"""STRING column helpers (the JAX package's columnar/strings.py).

A STRING column is ``uint8[nbytes]`` characters plus ``int32[n+1]``
offsets. Ops that work on whole strings at once (the plain row hashes,
sort lanes, key equality, the JCUDF row assembly) read the padded form
made here: ``uint8[n, L]`` zero-padded bytes and ``int32[n]`` lengths,
with L the max length bucketed by ``pad_width``.

The JAX package also has ``bucket_padded_data``, which pads the character
buffer to a bucketed length only so that its TPU programs compile once
per bucket; PyTorch compiles nothing per shape, so it is not ported.

Every function runs on the device of its input tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.shapes import bucket_size
from . import dtype as dt
from .column import Column
from .dtype import TypeId

# elements of one chunk of the padded matrix that densify_offsets builds at
# a time: its position tensor stays at 256 MB (int32) whatever n is
_DENSIFY_CHUNK = 1 << 26


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def pad_width(max_len: int, multiple: int = 8) -> int:
    """The padded width for a max string length: the next power of two,
    at least ``multiple`` (the JAX package's bucketing, so both packages
    pad to the same width)."""
    return round_up(bucket_size(max(1, max_len), floor=multiple), multiple)


def padded_bytes(col: Column, multiple: int = 8,
                 max_len: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``uint8[n, L]`` zero-padded bytes, ``int32[n]`` lengths) of a
    STRING column, L = ``pad_width(max length)``. The max length is the
    one host sync, unless the caller knows it (``max_len``). Memoized on
    the column (columns are never changed in place), so a sort, a key
    compare and a row conversion of one column pad it once."""
    if col.dtype.id is not TypeId.STRING:
        raise TypeError(f"padded_bytes of a {col.dtype.id.value} column")
    cached = getattr(col, "_padded", None)
    if cached is not None and cached[0] == multiple:
        return cached[1], cached[2]
    if max_len is None:
        lengths = col.offsets[1:] - col.offsets[:-1]
        max_len = int(lengths.max()) if col.size else 0
    mat, lengths = densify_offsets(col.data, col.offsets,
                                   pad_width(max_len, multiple))
    col._padded = (multiple, mat, lengths)
    return mat, lengths


def densify_offsets(data: torch.Tensor, offsets: torch.Tensor,
                    L: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat elements + ``int32[n+1]`` offsets -> (``[n, L]`` matrix of the
    elements, zero past each run, ``int32[n]`` lengths). Runs longer than
    L are cut at L. Built in row chunks, so the gather positions never
    take more than a chunk's memory."""
    offsets = offsets.to(torch.int32)
    lengths = offsets[1:] - offsets[:-1]
    n = int(lengths.shape[0])
    mat = torch.zeros((n, L), dtype=data.dtype, device=data.device)
    if data.shape[0] == 0 or n == 0 or L == 0:
        return mat, lengths
    wide = data.shape[0] + L >= 1 << 31
    ptype = torch.int64 if wide else torch.int32
    cols = torch.arange(L, dtype=ptype, device=data.device)
    step = max(1, _DENSIFY_CHUNK // L)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        start = offsets[r0:r1].to(ptype)[:, None]
        pos = (start + cols).clamp_(max=data.shape[0] - 1)
        got = data.index_select(0, pos.reshape(-1)).view(r1 - r0, L)
        inside = cols < lengths[r0:r1, None]
        mat[r0:r1] = torch.where(inside, got, torch.zeros(
            (), dtype=data.dtype, device=data.device))
    return mat, lengths


def unflatten_padded(mat: torch.Tensor, lengths: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``densify_offsets``: padded ``[n, L]`` + lengths ->
    (flat elements, ``int64[n+1]`` offsets)."""
    lengths = lengths.to(torch.int64)
    offsets = torch.zeros(lengths.shape[0] + 1, dtype=torch.int64,
                          device=mat.device)
    torch.cumsum(lengths, 0, out=offsets[1:])
    keep = (torch.arange(mat.shape[1], device=mat.device)[None, :]
            < lengths[:, None])
    return mat[keep], offsets


def from_padded_bytes(mat: torch.Tensor, lengths: torch.Tensor,
                      validity: Optional[torch.Tensor] = None) -> Column:
    """STRING column from padded ``uint8[n, L]`` bytes + lengths."""
    chars, offsets = unflatten_padded(mat.to(torch.uint8), lengths)
    if validity is not None:
        validity = torch.as_tensor(validity, device=mat.device).to(
            torch.bool)
    return Column(dt.STRING, int(mat.shape[0]), data=chars,
                  validity=validity, offsets=offsets.to(torch.int32))


def pack_byte_rows(parts: Sequence[bytes], validity=None,
                   device="cuda") -> Column:
    """STRING column from a Python list of bytes objects: their bytes
    joined on the host, one copy to ``device``."""
    from .column import resolve_device
    dev = resolve_device(device)
    lengths = np.fromiter((len(p) for p in parts), np.int64, len(parts))
    offsets = np.zeros(len(parts) + 1, np.int32)
    np.cumsum(lengths, out=offsets[1:])
    chars = np.frombuffer(b"".join(parts), np.uint8).copy()
    if validity is not None:
        validity = torch.as_tensor(np.asarray(validity, dtype=bool)).to(dev)
    return Column(dt.STRING, len(parts), data=torch.from_numpy(chars).to(dev),
                  validity=validity, offsets=torch.from_numpy(offsets).to(dev))


def row_of_position(bounds: torch.Tensor, total: int) -> torch.Tensor:
    """``int32[total]``: for each position k, the segment whose
    ``[bounds[s], bounds[s+1])`` holds it, given segment boundaries
    ``[0, ..., total]`` (the JAX package's ``_row_of_position``): a mark
    at each segment start, then a prefix sum. Empty segments add marks at
    one position; marks at ``total`` (empty trailing segments) fall off."""
    marks = torch.zeros(total + 1, dtype=torch.int32, device=bounds.device)
    inner = bounds[1:-1].to(torch.int64)
    marks.index_add_(0, inner, torch.ones_like(inner, dtype=torch.int32))
    return torch.cumsum(marks[:total], 0, dtype=torch.int32)


def gather_spans(src: torch.Tensor, starts: torch.Tensor,
                 lengths: torch.Tensor, validity=None) -> Column:
    """STRING column from per-row (start, length) spans over flat source
    bytes; a null row (``validity`` False) takes no bytes. One host sync:
    the output size. Every other step is a flat-byte gather."""
    n = int(lengths.shape[0])
    lengths = lengths.to(torch.int32)
    if validity is not None:
        lengths = torch.where(validity, lengths, 0)
    offs = torch.zeros(n + 1, dtype=torch.int32, device=src.device)
    torch.cumsum(lengths, 0, dtype=torch.int32, out=offs[1:])
    total = int(offs[-1])
    if total:
        row = row_of_position(offs, total)
        pos = (starts.to(torch.int64).index_select(0, row)
               + torch.arange(total, device=src.device)
               - offs.index_select(0, row))
        data = src.index_select(0, pos).to(torch.uint8)
    else:
        data = torch.zeros(0, dtype=torch.uint8, device=src.device)
    return Column(dt.STRING, n, data=data, validity=validity, offsets=offs)
