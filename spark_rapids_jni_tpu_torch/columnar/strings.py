"""STRING column helpers (the JAX package's columnar/strings.py).

A STRING column is ``uint8[nbytes]`` characters plus ``int32[n+1]``
offsets. Ops that work on whole strings at once (the plain row hashes,
sort lanes, key equality, the JCUDF row assembly) read the padded form
made here: ``uint8[n, L]`` zero-padded bytes and ``int32[n]`` lengths,
with L the max length bucketed by ``pad_width``.

The JAX package also has ``bucket_padded_data`` and ``pad_to_bucket``,
which pad the character buffer and a gather's output to a bucketed
length only so that its TPU programs compile once per bucket (the slack
then trimmed or left in place); PyTorch compiles nothing per shape, so
neither is ported: every buffer here is exact, and the string device
tiers' span gathers (``gather_spans``) have no slack to leave.

The string device tiers (ops/parse_uri_device.py, get_json_device.py,
from_json_device.py) share the masked scans at the end of this module
(``Marks``, ``first_index``, ``last_index``, ``byte_at``), the row-chunk plan of
their planes (``row_chunks``) and the loops of their DFAs
(``column_scan``).

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


# ---------------------------------------------------------------------------
# masked scans over a padded byte matrix (the string device tiers:
# ops/parse_uri_device.py, get_json_device.py, from_json_device.py)
# ---------------------------------------------------------------------------

def _count_type(W: int) -> torch.dtype:
    """The narrowest integer type that counts to W."""
    return torch.int16 if W < 1 << 15 else torch.int32


class Marks:
    """The marked positions of a bool ``[n, W]`` plane, by their running
    count: per row the first or last mark in a window ``[lo, hi)`` is one
    ``searchsorted`` of the counts, so a plane asked many windows is
    scanned once (``first_index``/``last_index`` answer a plane asked
    once)."""

    def __init__(self, mask: torch.Tensor):
        self.W = int(mask.shape[1])
        self.counts = torch.cumsum(mask, dim=1, dtype=_count_type(self.W))

    def _before(self, p: torch.Tensor) -> torch.Tensor:
        """Marks at positions < p (p clamped to [0, W])."""
        q = p.clamp(0, self.W).to(torch.int64) - 1
        got = torch.gather(self.counts, 1, q.clamp(min=0)[:, None])[:, 0]
        return torch.where(q >= 0, got, 0)

    def _at_count(self, k: torch.Tensor) -> torch.Tensor:
        """The position of each row's k-th mark (W where there is none)."""
        return torch.searchsorted(self.counts, k[:, None].to(
            self.counts.dtype).contiguous())[:, 0].to(torch.int32)

    def first(self, lo: torch.Tensor, hi: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per row: the smallest marked j in ``[lo, hi)``, and whether there
        is one (``int32[n]``, ``bool[n]``); ``hi`` where there is none (a
        safe clamp for span arithmetic)."""
        idx = self._at_count(self._before(lo) + 1)
        found = (idx < hi) & (idx < self.W)
        return torch.where(found, idx, hi.to(torch.int32)), found

    def last(self, lo: torch.Tensor, hi: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per row: the largest marked j in ``[lo, hi)``, and whether there
        is one; ``lo - 1`` where there is none."""
        c_hi = self._before(hi)
        found = c_hi > self._before(lo)
        idx = self._at_count(c_hi)
        return torch.where(found, idx, lo.to(torch.int32) - 1), found


def _window(mask, lo, hi):
    W = mask.shape[1]
    pos = torch.arange(W, dtype=_count_type(W), device=mask.device)
    return pos, mask & (pos >= lo[:, None]) & (pos < hi[:, None])


def first_index(mask: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``Marks(mask).first(lo, hi)`` for a plane asked once: one masked
    minimum of the positions, no scan."""
    W = mask.shape[1]
    pos, m = _window(mask, lo, hi)
    idx = torch.where(m, pos, W).amin(dim=1).to(torch.int32)
    found = idx < W
    return torch.where(found, idx, hi.to(torch.int32)), found


def last_index(mask: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``Marks(mask).last(lo, hi)`` for a plane asked once."""
    pos, m = _window(mask, lo, hi)
    idx = torch.where(m, pos, -1).amax(dim=1).to(torch.int32)
    found = idx >= 0
    return torch.where(found, idx, lo.to(torch.int32) - 1), found


def byte_at(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``mat[row, idx[row]]`` (uint8), 0 where idx is outside ``[0, W)``."""
    W = mat.shape[1]
    safe = idx.clamp(0, W - 1).to(torch.int64)[:, None]
    b = torch.gather(mat, 1, safe)[:, 0]
    return torch.where((idx >= 0) & (idx < W), b, 0).to(torch.uint8)


def row_chunks(n: int, W: int, elements: int):
    """``(r0, r1)`` row ranges of at most ``elements`` matrix elements
    each (one row at least): the device tiers build their ``[rows, W]``
    planes a chunk at a time, each row's result depending only on its own
    bytes, so that their peak memory does not grow with n."""
    step = max(1, elements // max(W, 1))
    return [(r0, min(n, r0 + step)) for r0 in range(0, n, step)]


def column_scan(step, regs, start: int, stop: int):
    """``regs = step(regs, j)`` for j in ``range(start, stop)``: the
    string device tiers' DFAs, which walk the columns of a padded byte
    matrix with ``[n]``-wide registers (a tuple of tensors), one small
    torch op per register update.

    On a CUDA device one step is captured as a CUDA graph (j a device
    scalar the graph advances) and replayed once a column, so a step's
    dozens of ops cost one launch; elsewhere a Python loop with j an
    int. ``step`` must give the same result for either j, make no host
    sync and return new tensors (it may return an input register
    unchanged); ``column(mat_t, j)`` reads row j of a transposed matrix
    for either."""
    if stop <= start:
        return regs
    dev = regs[0].device
    if dev.type != "cuda":
        for j in range(start, stop):
            regs = step(regs, j)
        return regs
    j = torch.full((), start, dtype=torch.int64, device=dev)
    static = tuple(r.clone() for r in regs)

    def body():
        new = step(static, j)
        for s, v in zip(static, new):
            if v is not s:
                s.copy_(v)
        j.add_(1)

    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()  # warm-up outside the capture; undone below
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        body()
    for s, r in zip(static, regs):
        s.copy_(r)
    j.fill_(start)
    for _ in range(start, stop):
        graph.replay()
    return static


def column(mat_t: torch.Tensor, j) -> torch.Tensor:
    """Row ``j`` of a transposed byte matrix (a column of the padded
    matrix), j an int or a device scalar (``column_scan``)."""
    if isinstance(j, int):
        return mat_t[j]
    return mat_t.index_select(0, j.view(1))[0]


def put_column(plane_t: torch.Tensor, j, values: torch.Tensor) -> None:
    """Write row ``j`` of a transposed plane (``column``'s counterpart)."""
    if isinstance(j, int):
        plane_t[j] = values
    else:
        plane_t.index_copy_(0, j.view(1), values[None])
