"""Run-length and frame-of-reference encoded columns (RLE, FOR32/FOR64),
the JAX package's columnar/encodings.py.

Integer columns stay encoded: a predicate over an RLE column evaluates once
per run, an aggregate sums ``value * run_length``, and a FOR comparison
shifts the literal by the reference and compares the codes. Both are plain
Columns with children, as DICT32 is:

RLE  ``Column(dt.RLE, n, data=None, children=(values, lengths))``
     values:  run values, a fixed-width integer Column of the logical type
              (r runs; a null run is one null entry covering its rows);
     lengths: INT32 run lengths (>= 0; a zero-length run covers no rows).
     Host run ends are memoized on the shared lengths child.

FOR  ``Column(DType(FOR32|FOR64, scale=width), n, data=uint8 packed codes,
     validity, children=(header,))``: LSB-first bit-packed codes (Parquet's
     bit-pack order), width 1..32 in ``dtype.scale``; header a one-row
     INT64 Column holding the reference. Row = reference + code; a null row
     packs code 0.

``decoded_rows`` is the in-op decoder at the declared boundaries (a
gather's row re-order, sort key lanes, groupby value expansion, eager
join keys); ``materialize`` is the output boundary. Bit unpacking and the
row-to-run map are plain torch ops.
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import dtype as dt
from .column import Column
from .dtype import TypeId

# value types an RLE column may carry
_RLE_VALUE_IDS = (
    TypeId.BOOL8, TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
    TypeId.UINT8, TypeId.UINT16, TypeId.UINT32,
    TypeId.TIMESTAMP_DAYS, TypeId.TIMESTAMP_SECONDS,
    TypeId.TIMESTAMP_MILLISECONDS, TypeId.TIMESTAMP_MICROSECONDS,
)

_CMP = {"lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
        "eq": torch.eq, "ne": torch.ne}
_AGG_OPS = ("sum", "count", "min", "max")
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def is_rle(col: Column) -> bool:
    return col.dtype.id is TypeId.RLE


def is_for(col: Column) -> bool:
    return col.dtype.id in (TypeId.FOR32, TypeId.FOR64)


def is_encoded(col: Column) -> bool:
    """RLE or FOR (DICT32 keeps its own paths)."""
    return col.dtype.id in (TypeId.RLE, TypeId.FOR32, TypeId.FOR64)


def logical_dtype(col: Column) -> dt.DType:
    """The type of a decoded row."""
    if is_rle(col):
        return rle_values(col).dtype
    if col.dtype.id is TypeId.FOR32:
        return dt.INT32
    if col.dtype.id is TypeId.FOR64:
        return dt.INT64
    return col.dtype


def _host(col: Column) -> np.ndarray:
    """Host copy of a plain child's data, memoized on the child."""
    cached = getattr(col, "_host_data", None)
    if cached is None:
        cached = col.to_numpy()
        cached.flags.writeable = False
        col._host_data = cached
    return cached


# ---------------------------------------------------------------------------
# RLE
# ---------------------------------------------------------------------------

def rle_values(col: Column) -> Column:
    return col.children[0]


def rle_lengths(col: Column) -> Column:
    return col.children[1]


def num_runs(col: Column) -> int:
    return col.children[0].size


def rle_column(values: Column, lengths: Column,
               size: Optional[int] = None) -> Column:
    """An RLE column of run values and INT32 run lengths; ``size`` (the
    decoded row count) defaults to the host sum of the lengths."""
    assert values.dtype.id in _RLE_VALUE_IDS, values.dtype
    assert lengths.dtype.id is TypeId.INT32, lengths.dtype
    assert values.size == lengths.size, (values.size, lengths.size)
    if size is None:
        size = int(_host(lengths).astype(np.int64).sum())
    return Column(dt.RLE, int(size), data=None, validity=None,
                  children=(values, lengths))


def rle_encode(col: Column) -> Column:
    """A plain integer column re-encoded as RLE by host run detection (a
    test and bench entry point). A run breaks where the value or the
    validity changes; a null run stores 0."""
    assert col.dtype.id in _RLE_VALUE_IDS, col.dtype
    dev = col.device
    n = col.size
    if n == 0:
        values = Column.from_numpy(np.zeros(0, col.dtype.np_dtype),
                                   col.dtype, device=dev)
        lengths = Column.from_numpy(np.zeros(0, np.int32), dt.INT32,
                                    device=dev)
        return rle_column(values, lengths, 0)
    vals = col.to_numpy()
    valid = (col.validity.cpu().numpy() if col.validity is not None
             else np.ones(n, dtype=bool))
    vals = np.where(valid, vals, 0).astype(col.dtype.np_dtype)
    brk = np.empty(n, dtype=bool)
    brk[0] = True
    brk[1:] = (vals[1:] != vals[:-1]) | (valid[1:] != valid[:-1])
    starts = np.flatnonzero(brk)
    ends = np.append(starts[1:], n)
    run_valid = valid[starts]
    values = Column.from_numpy(vals[starts].copy(), col.dtype, device=dev,
                               validity=None if run_valid.all()
                               else run_valid)
    lengths = Column.from_numpy((ends - starts).astype(np.int32), dt.INT32,
                                device=dev)
    return rle_column(values, lengths, n)


def run_ends(col: Column) -> np.ndarray:
    """Host int64 inclusive run ends, memoized on the shared lengths
    child."""
    lengths = rle_lengths(col)
    cached = getattr(lengths, "_rle_ends", None)
    if cached is None:
        cached = np.cumsum(_host(lengths), dtype=np.int64)
        cached.flags.writeable = False
        lengths._rle_ends = cached
    return cached


def run_ends_device(col: Column) -> torch.Tensor:
    """int64 inclusive run ends on the device (a cumsum of the lengths)."""
    return torch.cumsum(rle_lengths(col).data.to(torch.int64), 0)


def row_to_run(ends: torch.Tensor, n: int) -> torch.Tensor:
    """int64 run of every row: the first run whose end exceeds the row
    (a zero-length run is never selected)."""
    rows = torch.arange(n, dtype=torch.int64, device=ends.device)
    return torch.searchsorted(ends, rows, right=True)


# ---------------------------------------------------------------------------
# FOR
# ---------------------------------------------------------------------------

def for_header(col: Column) -> Column:
    return col.children[0]


def for_width(col: Column) -> int:
    return col.dtype.scale


def for_reference(col: Column) -> torch.Tensor:
    """int64 0-dim reference (decoded value = reference + code)."""
    return for_header(col).data[0]


def packed_nbytes(n: int, width: int) -> int:
    return (n * width + 7) // 8


def pack_codes(codes: np.ndarray, width: int) -> np.ndarray:
    """LSB-first bit-pack of host codes (< 2**width) into uint8 bytes."""
    n = codes.shape[0]
    buf = np.zeros(packed_nbytes(n, width) + 8, dtype=np.uint8)
    bit0 = np.arange(n, dtype=np.int64) * width
    byte0 = bit0 >> 3
    sh = (bit0 & 7).astype(np.uint64)
    c = codes.astype(np.uint64) << sh  # at most width + 7 <= 39 bits
    for b in range(5):  # a shifted code spans at most 5 bytes
        np.bitwise_or.at(buf, byte0 + b,
                         ((c >> np.uint64(8 * b)) & np.uint64(0xFF))
                         .astype(np.uint8))
    return buf[:packed_nbytes(n, width)]


def unpack_codes(packed: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """int64 codes of LSB-first packed bytes: a 5-byte window per row,
    reads past the buffer clipped to its last byte (their bits land above
    the mask)."""
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=packed.device)
    blob = packed.to(torch.int64)
    nb = packed.shape[0]
    bit0 = torch.arange(n, dtype=torch.int64, device=packed.device) * width
    byte0 = bit0 >> 3
    word = torch.zeros(n, dtype=torch.int64, device=packed.device)
    for b in range(5):
        word |= blob.index_select(0, (byte0 + b).clamp(0, nb - 1)) << (8 * b)
    return (word >> (bit0 & 7)) & ((1 << width) - 1)


def for_column(packed: torch.Tensor, dtype: dt.DType, size: int, reference,
               validity: Optional[torch.Tensor] = None) -> Column:
    """A FOR column of packed bytes and a reference (an int or an int64
    0-dim tensor)."""
    assert dtype.id in (TypeId.FOR32, TypeId.FOR64), dtype
    assert 1 <= dtype.scale <= 32, dtype.scale
    ref = torch.as_tensor(reference, dtype=torch.int64,
                          device=packed.device).reshape(1)
    return Column(dtype, int(size), data=packed, validity=validity,
                  children=(Column(dt.INT64, 1, data=ref),))


def for_encode(col: Column, width: Optional[int] = None) -> Column:
    """A plain INT32/INT64 column re-encoded as FOR32/FOR64 on the host (a
    test and bench entry point): reference = min of the valid rows, width
    = bits of their span (at least 1); null rows pack code 0."""
    assert col.dtype.id in (TypeId.INT32, TypeId.INT64), col.dtype
    n = col.size
    out_id = TypeId.FOR32 if col.dtype.id is TypeId.INT32 else TypeId.FOR64
    vals = col.to_numpy().astype(np.int64)
    valid = (col.validity.cpu().numpy() if col.validity is not None
             else np.ones(n, dtype=bool))
    live = vals[valid]
    ref = int(live.min()) if live.size else 0
    span = int(live.max()) - ref if live.size else 0
    need = max(1, int(span).bit_length())
    if width is None:
        width = need
    assert need <= width <= 32, (need, width, span)
    codes = np.where(valid, vals - ref, 0).astype(np.uint64)
    packed = torch.from_numpy(pack_codes(codes, width)).to(col.device)
    return for_column(packed, dt.DType(out_id, width), n, ref, col.validity)


def for_codes(col: Column) -> torch.Tensor:
    """int64 codes of a FOR column (reference not added)."""
    return unpack_codes(col.data, col.size, for_width(col))


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def decoded_rows(col: Column) -> Column:
    """The logical fixed-width column of an RLE or FOR column (any other
    column as it is): the in-op decoder of the declared boundaries."""
    if is_rle(col):
        values = rle_values(col)
        n = col.size
        if n == 0 or values.size == 0:
            return Column(values.dtype, n, data=torch.zeros(
                n, dtype=values.dtype.torch_dtype, device=col.device))
        rid = row_to_run(run_ends_device(col), n)
        validity = (values.validity.index_select(0, rid)
                    if values.validity is not None else None)
        return Column(values.dtype, n, data=values.data.index_select(0, rid),
                      validity=validity)
    if is_for(col):
        out = logical_dtype(col)
        data = (for_reference(col) + for_codes(col)).to(out.torch_dtype)
        return Column(out, col.size, data=data, validity=col.validity)
    return col


def materialize(col: Column) -> Column:
    """An RLE/FOR column decoded to a plain column (output boundary)."""
    assert is_encoded(col), col.dtype
    return decoded_rows(col)


def materialize_table(table):
    """Every RLE/FOR column of a Table decoded (output boundary)."""
    from .column import Table
    return Table(tuple(materialize(c) if is_encoded(c) else c
                       for c in table))


# ---------------------------------------------------------------------------
# identity: fingerprints and program-cache keys
# ---------------------------------------------------------------------------

def encoding_fingerprint(col: Column) -> int:
    """crc32 of the encoded buffers (run values + lengths, or packed bytes
    + reference + width), memoized on the column. For identity checks, not
    for cache keys: run buffers change with every batch."""
    cached = getattr(col, "_enc_fp", None)
    if cached is not None:
        return cached
    if is_rle(col):
        values, lengths = rle_values(col), rle_lengths(col)
        h = zlib.crc32(_host(values).astype(np.int64).tobytes())
        h = zlib.crc32(_host(lengths).astype(np.int64).tobytes(), h)
        if values.validity is not None:
            h = zlib.crc32(values.validity.cpu().numpy().tobytes(), h)
    else:
        assert is_for(col), col.dtype
        h = zlib.crc32(col.data.cpu().numpy().tobytes())
        h = zlib.crc32(_host(for_header(col)).astype(np.int64).tobytes(), h)
        h = zlib.crc32(bytes([for_width(col)]), h)
    cached = (h ^ col.size) & 0xFFFFFFFF
    col._enc_fp = cached
    return cached


def encoding_cache_key(col: Column) -> Tuple:
    """The encoding's part of the fused program cache key: DICT32 its
    dictionary fingerprint, RLE its static run structure (run count, value
    type, run validity; not the run content), FOR a tag (the width is in
    the dtype), a plain column nothing."""
    tid = col.dtype.id
    if tid is TypeId.DICT32:
        from .dictionary import dictionary_fingerprint
        return ("dict", dictionary_fingerprint(col))
    if tid is TypeId.RLE:
        values = rle_values(col)
        return ("rle", values.dtype.id.value, values.size,
                values.validity is not None)
    if tid in (TypeId.FOR32, TypeId.FOR64):
        return ("for",)
    return ()


# ---------------------------------------------------------------------------
# run-space / code-space compute
# ---------------------------------------------------------------------------

def rle_predicate_runs(col: Column, op: str, literal: int) -> torch.Tensor:
    """bool[r] per-run keep mask of ``col <op> literal``; null runs drop."""
    values = rle_values(col)
    keep = _CMP[op](values.data.to(torch.int64), literal)
    if values.validity is not None:
        keep = keep & values.validity
    return keep


def rle_aggregate(col: Column, op: str,
                  run_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 0-dim aggregate of an RLE column without decoding it: sum is
    ``sum(value * length)`` over the valid (masked) runs (int64 wraps as
    the row-wise sum does), count sums lengths, min/max reduce run values
    (int64 max/min when no run survives)."""
    assert op in _AGG_OPS, op
    values, lengths = rle_values(col), rle_lengths(col)
    live = values.valid_mask()
    if run_mask is not None:
        live = live & run_mask
    lens = lengths.data.to(torch.int64)
    vals = values.data.to(torch.int64)
    if op == "count":
        return torch.where(live, lens, 0).sum()
    if op == "sum":
        return torch.where(live, vals * lens, 0).sum()
    live = live & (lens > 0)
    if op == "min":
        return torch.where(live, vals, _I64_MAX).min()
    return torch.where(live, vals, _I64_MIN).max()


def for_predicate_mask(col: Column, op: str, literal: int) -> torch.Tensor:
    """bool[n] keep mask of ``col <op> literal`` on a FOR column: the codes
    compare with ``literal - reference``; null rows drop."""
    keep = _CMP[op](for_codes(col), literal - for_reference(col))
    if col.validity is not None:
        keep = keep & col.validity
    return keep


def for_aggregate(col: Column, op: str,
                  row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 0-dim aggregate of a FOR column in code space: sum is
    ``sum(codes) + reference * live_count``; min/max add the reference to
    the code extremum."""
    assert op in _AGG_OPS, op
    live = col.valid_mask()
    if row_mask is not None:
        live = live & row_mask
    cnt = live.to(torch.int64).sum()
    if op == "count":
        return cnt
    codes = for_codes(col)
    ref = for_reference(col)
    if op == "sum":
        return torch.where(live, codes, 0).sum() + ref * cnt
    if op == "min":
        return ref + torch.where(live, codes, _I64_MAX).min()
    return ref + torch.where(live, codes, _I64_MIN).max()


# ---------------------------------------------------------------------------
# concat
# ---------------------------------------------------------------------------

def _concat_plain(cols: Sequence[Column], out_dtype: dt.DType) -> Column:
    n = sum(c.size for c in cols)
    data = torch.cat([c.data for c in cols])
    validity = (torch.cat([c.valid_mask() for c in cols])
                if any(c.validity is not None for c in cols) else None)
    return Column(out_dtype, n, data=data, validity=validity)


def concat_rle(cols: Sequence[Column]) -> Column:
    """RLE columns concatenated run-wise (runs append; equal values across
    the seam stay separate runs)."""
    assert all(is_rle(c) for c in cols)
    vd = rle_values(cols[0]).dtype
    assert all(rle_values(c).dtype == vd for c in cols), \
        "RLE concat requires matching value dtypes"
    values = _concat_plain([rle_values(c) for c in cols], vd)
    lengths = _concat_plain([rle_lengths(c) for c in cols], dt.INT32)
    return rle_column(values, lengths, sum(c.size for c in cols))


def concat_for(cols: Sequence[Column]) -> Optional[Column]:
    """FOR columns concatenated encoded when their packed bytes join: same
    width and reference, and every chunk but the last ending on a byte.
    None otherwise (the caller decodes)."""
    assert all(is_for(c) for c in cols)
    d0 = cols[0].dtype
    if not all(c.dtype == d0 for c in cols):
        return None
    refs = [int(_host(for_header(c))[0]) for c in cols]
    if len(set(refs)) != 1:
        return None
    if any(c.size * d0.scale % 8 for c in cols[:-1]):
        return None
    validity = (torch.cat([c.valid_mask() for c in cols])
                if any(c.validity is not None for c in cols) else None)
    return for_column(torch.cat([c.data for c in cols]), d0,
                      sum(c.size for c in cols), refs[0], validity)
