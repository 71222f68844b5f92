"""Sort-based groupby-aggregate (the JAX package's ops/groupby.py).

  1. ``sort_order`` over the key columns (nulls form their own group and
     sort first, Spark's default);
  2. segment boundaries where a sorted row's keys differ from the row
     before it (float keys over normalized bits: NaNs equal, -0.0 == 0.0;
     STRING keys over their zero-padded bytes and their lengths; DICT32
     keys over their codes);
  3. segmented reductions over the sorted values.

Aggregations: sum, count, min, max and mean, with Spark's null rules
(nulls ignored; an all-null group gives a null result; count counts
non-nulls) and types (sum of an integer is INT64, of a float FLOAT64; mean
is FLOAT64; min and max keep the type). Integer sums wrap as int64, in any
order, so the prefix-sum and scatter reductions here equal the JAX
package's exactly; an integer mean is that sum divided once by
``max(count, 1)`` in float64.

Float sums depend on their order. The JAX package's ``segment_sum`` on
XLA:CPU adds each segment's rows one after the other in sorted order
(table order within a group: the sort is stable), with denormals-are-zero
inputs and flush-to-zero results; FLOAT32 widens to float64 first (a
subnormal becomes ±0, a NaN is quieted). The sum, min and max of a float
column run in kernel H1 (``kernels.segment_float_agg``), which keeps that
order and those flushes; a float mean is that sum over ``max(count, 1)``,
flushed as x86 flushes a quotient.

Decimals and UINT64, as in the JAX package: DECIMAL32/64 and UINT64
aggregate their stored integers as int64 (sum INT64, mean FLOAT64 of the
unscaled values, min/max in int64 order, the type kept). DECIMAL128 keys
compare their limb rows; its sum is exact mod 2^128 (per-limb int64
segment sums, one carry pass), min/max take the high then the low 64
bits, and its mean is Spark's avg(decimal): the sum divided by the count
in ops/decimal128 (kernel H2 on the card) at scale min(s + 4, 38), null
where the sum wraps past int128 or the quotient overflows. DECIMAL128
aggregates run on the sorted path only.

Two sort-free paths take a single encoded key, as in the JAX package: a
DICT32 key maps its codes through the dictionary's ranks to |dictionary|+1
slots (``_dict_code_groupby``), an RLE key its runs to the distinct run
values (``_rle_groupby``). Both decline float sum and mean, whose order is
the sorted path's. Encoded value columns decode at the declared
boundaries.

The plan cores (plan/registry.py) the fused plan engine composes:
``groupby_core`` (the same sort and segment math with a static slot
count), ``groupby_direct_small_core`` and ``groupby_direct_wide_core``
(direct-addressed slots for a single integer key of a known span).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar import encodings as enc
from ..columnar.column import Column, Table
from ..columnar.dtype import TypeId
from ..columnar.strings import padded_bytes
from ..memory.reservation import device_reservation, release_barrier
from ..plan.registry import plan_core
from ..utils.tracing import func_range
from . import kernels
from .hashing import spark_key_values
from .sort import gather, lexsort, sort_lanes, sort_order

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)
_SIGN, _EXP, _QUIET = kernels._SIGN, kernels._EXP, kernels._QUIET
_CHUNK_SLOTS = 1 << 24   # accumulators of a chunked scatter (128 MiB)


def _keys_equal_prev(col: Column, order: torch.Tensor) -> torch.Tensor:
    """bool[n-1]: sorted row i+1 equals sorted row i on this key column
    (two nulls are equal)."""
    if col.dtype.is_encoded:
        col = enc.decoded_rows(col)  # equality needs per-row validity
    idx, pidx = order[1:], order[:-1]
    valid = col.valid_mask()
    v_cur, v_prev = valid.index_select(0, idx), valid.index_select(0, pidx)
    if col.dtype.id is TypeId.STRING:
        mat, lengths = padded_bytes(col)
        words = mat.view(torch.int64)  # 8 padded bytes a word
        same_val = ((words.index_select(0, idx)
                     == words.index_select(0, pidx)).all(dim=1)
                    & (lengths.index_select(0, idx)
                       == lengths.index_select(0, pidx)))
    elif col.dtype.id is TypeId.DECIMAL128:  # both words of the limbs
        from .int128 import take_words
        a, b = take_words(col.data, idx), take_words(col.data, pidx)
        same_val = (a[0] == b[0]) & (a[1] == b[1])
    else:
        # a DICT32 key compares codes: the entries are unique
        vals = spark_key_values(col)
        same_val = vals.index_select(0, idx) == vals.index_select(0, pidx)
    return (v_cur & v_prev & same_val) | (~v_cur & ~v_prev)


def _segment_structure(cmp_keys: Sequence[Column], order: torch.Tensor):
    """(boundary int64[n], seg_ids int64[n]) over the sorted rows (n >= 1)."""
    n = cmp_keys[0].size
    dev = order.device
    same = torch.ones(n - 1, dtype=torch.bool, device=dev)
    for k in cmp_keys:
        same = same & _keys_equal_prev(k, order)
    boundary = torch.cat([torch.ones(1, dtype=torch.int64, device=dev),
                          (~same).to(torch.int64)])
    return boundary, torch.cumsum(boundary, 0) - 1


def _agg_out_dtype(vdtype: dt.DType, op: str) -> dt.DType:
    """Result dtype of an aggregation over a column of (logical) type
    ``vdtype``, and the one validation point, its checks in the JAX
    package's order: Spark's sum(int) -> long, sum(float/double) ->
    double, count -> long, mean -> double, min/max keep the type;
    DECIMAL128 sum/min/max keep it, its mean is DECIMAL128 at scale
    min(s + 4, 38)."""
    if op == "count":
        return dt.INT64
    if vdtype.id is TypeId.DICT32:
        raise TypeError("groupby aggregation over dictionary-encoded "
                        "string value columns supports count only")
    if vdtype.id is TypeId.DECIMAL128:
        if op == "mean":
            return dt.decimal128(min(vdtype.scale + 4, 38))
        if op not in ("sum", "min", "max"):
            raise TypeError(f"groupby {op} unsupported for decimal128 "
                            f"(sum/min/max/mean/count are)")
        return vdtype
    if not vdtype.is_fixed_width:
        raise TypeError(f"groupby aggregation unsupported for "
                        f"{vdtype.id.value} value columns")
    vdtype.require_stored()
    if op not in ("sum", "min", "max", "mean"):
        raise ValueError(f"unknown aggregation {op}")
    if op == "mean" or (op == "sum" and vdtype.is_floating):
        return dt.FLOAT64
    return dt.INT64 if op == "sum" else vdtype


def _value_dtype(col: Column) -> dt.DType:
    return enc.logical_dtype(col) if col.dtype.is_encoded else col.dtype


def _sorted_segment_sum(z: torch.Tensor, seg: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """int64 sums of ``z`` per segment id, for ids ``seg`` in
    non-decreasing order: differences of one inclusive prefix sum at the
    segment edges (an empty segment sums to 0). The prefix sum and the
    difference both wrap mod 2^64, so each sum is the int64 sum in any
    order — the JAX package's — without the scatter-add atomics that
    serialize when few segments take many rows."""
    prefix = torch.cat([torch.zeros(1, dtype=torch.int64, device=z.device),
                        torch.cumsum(z, 0)])
    lo, hi = _segment_edges(seg, num_segments)
    return prefix.index_select(0, hi) - prefix.index_select(0, lo)


def _segment_edges(seg: torch.Tensor, num_segments: int):
    """(first row, end row) int64[G] of each segment of sorted ids."""
    ids = torch.arange(num_segments, dtype=seg.dtype, device=seg.device)
    return (torch.searchsorted(seg, ids),
            torch.searchsorted(seg, ids, right=True))


def _chunked_scatter(vals: torch.Tensor, seg: torch.Tensor, G: int,
                     op: str) -> torch.Tensor:
    """int64 per-segment ``op`` ("sum", "amin", "amax") of ``vals`` for ids
    ``seg`` in any order: each chunk of rows reduces into its own row of G
    accumulators, and the rows are reduced at the end, so many rows never
    contend for one address (as ``groupby_direct_small_core`` sums). An
    empty segment holds the op's identity."""
    n = vals.shape[0]
    blocks = max(1, min(-(-n // 1024), _CHUNK_SLOTS // max(G, 1)))
    per = max(1, -(-n // blocks))
    dest = (torch.arange(n, dtype=torch.int64, device=vals.device) // per
            * G + seg)
    if op == "sum":
        acc = torch.zeros(blocks * G, dtype=torch.int64, device=vals.device)
        return acc.index_add_(0, dest, vals).view(blocks, G).sum(0)
    fill = _I64_MAX if op == "amin" else _I64_MIN
    acc = torch.full((blocks * G,), fill, dtype=torch.int64,
                     device=vals.device)
    acc.scatter_reduce_(0, dest, vals, op)
    acc = acc.view(blocks, G)
    return acc.amin(0) if op == "amin" else acc.amax(0)


# ---------------------------------------------------------------------------
# float values
# ---------------------------------------------------------------------------

def _f64_values(col: Column) -> torch.Tensor:
    """float64 values a FLOAT64 or FLOAT32 column aggregates as, in the
    JAX package (Spark sums float as double): FLOAT32 widened by its bits
    as XLA:CPU widens it — a subnormal becomes the zero of its sign, a NaN
    is quieted — the same on every backend."""
    if col.dtype.id is TypeId.FLOAT64:
        return col.data
    b = col.data.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = torch.where(b >= 1 << 31, _SIGN, 0)
    exp = (b >> 23) & 0xFF
    mant = b & 0x7FFFFF
    normal = sign | ((exp + (1023 - 127)) << 52) | (mant << 29)
    special = sign | _EXP | (mant << 29) | torch.where(mant != 0, _QUIET, 0)
    bits = torch.where(exp == 0, sign,
                       torch.where(exp == 0xFF, special, normal))
    return bits.view(torch.float64)


def _f32_of(x: torch.Tensor) -> torch.Tensor:
    """float32 of float64 values that came from float32 (exact), a NaN
    narrowed as x86 narrows it: sign, quiet bit and the top of the
    payload kept."""
    b = x.view(torch.int64)
    nan = (b & _I64_MAX) > _EXP
    nb = (torch.where(b < 0, -(1 << 31), 0) | 0x7F800000
          | ((b >> 29) & 0x7FFFFF))
    return torch.where(nan, nb.to(torch.int32),
                       x.to(torch.float32).view(torch.int32)).view(
                           torch.float32)


def _flushed_mean(s: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """``s / max(cnt, 1)`` as x86 computes it under flush-to-zero: a
    quotient that is tiny after rounding to 53 bits (below 2^-1022)
    becomes the zero of its sign; a NaN sum passes through. The second
    quotient, scaled by 2^100, sees that rounding in the normal range."""
    c = cnt.clamp(min=1).to(torch.float64)
    r = (s / c).view(torch.int64)
    tiny = ((s * 2.0 ** 100) / c).abs() < 2.0 ** -922
    sb = s.view(torch.int64)
    out = torch.where(tiny, r & _SIGN, r)
    return torch.where((sb & _I64_MAX) > _EXP, sb, out).view(torch.float64)


def _float_agg(vcol: Column, op: str, cnt: torch.Tensor, h1) -> Column:
    """A float aggregation's Column from H1's (sum, min, max)."""
    sums, mins, maxs = h1
    G = cnt.shape[0]
    any_valid = cnt > 0
    if op == "sum":
        return Column(dt.FLOAT64, G, data=sums, validity=any_valid)
    if op == "mean":
        return Column(dt.FLOAT64, G, data=_flushed_mean(sums, cnt),
                      validity=any_valid)
    res = mins if op == "min" else maxs
    if vcol.dtype.id is TypeId.FLOAT32:
        res = _f32_of(res)
    return Column(vcol.dtype, G, data=res, validity=any_valid)


def _float_h1(vcol: Column, order: torch.Tensor, valid: torch.Tensor,
              seg_ids: torch.Tensor, num_segments: int):
    """H1 over the sorted segments (``seg_ids`` non-decreasing)."""
    z = _f64_values(vcol).index_select(0, order)
    ids = torch.arange(num_segments + 1, dtype=seg_ids.dtype,
                       device=seg_ids.device)
    starts = torch.searchsorted(seg_ids, ids)
    return kernels.segment_float_agg(z, valid, starts)


def _float_minmax_any_order(vcol: Column, valid: torch.Tensor,
                            seg_ids: torch.Tensor, num_segments: int):
    """(None, min, max) for segment ids in table order (the sort-free
    paths): H1's min/max contract by scatter reductions."""
    xb = kernels._flush_bits(_f64_values(vcol).view(torch.int64))
    mins, maxs = kernels.float_minmax_scatter(xb, valid, seg_ids,
                                              num_segments)
    return None, mins, maxs


def _segment_agg_fixed(vcol: Column, order: Optional[torch.Tensor],
                       valid: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, cnt: torch.Tensor, op: str,
                       state: dict, sorted_ids: bool = True) -> Column:
    """One aggregation over segments. ``valid`` is the per-row
    contribution mask (sorted space when ``order`` is given; with ``order``
    None the rows are in table order and, unless ``sorted_ids``, the ids
    in any order); masked rows contribute the op's identity (+0.0 to a
    float sum). ``state``: the value column's memo within one groupby, so
    every float aggregation of the column reads one H1 result, and a
    DECIMAL128 column's sum and mean one 128-bit sum."""
    out_dtype = _agg_out_dtype(vcol.dtype, op)
    if op == "count":
        return Column(dt.INT64, num_segments, data=cnt)
    if vcol.dtype.id is TypeId.DECIMAL128:  # sorted path only
        if op in ("sum", "mean") and "dec_sum" not in state:
            state["dec_sum"] = _decimal128_sum(vcol, order, valid, seg_ids,
                                               num_segments, cnt > 0)
        if op == "sum":
            return state["dec_sum"][0]
        if op == "mean":
            return _decimal128_mean(state["dec_sum"], num_segments, cnt,
                                    out_dtype)
        return _decimal128_minmax(vcol, order, valid, seg_ids, num_segments,
                                  cnt > 0, op == "min")
    if vcol.dtype.is_floating:
        if "h1" not in state:
            if sorted_ids:
                state["h1"] = _float_h1(vcol, order, valid, seg_ids,
                                        num_segments)
            else:
                state["h1"] = _float_minmax_any_order(vcol, valid, seg_ids,
                                                      num_segments)
        return _float_agg(vcol, op, cnt, state["h1"])
    vals = vcol.data.to(torch.int64)
    if order is not None:
        vals = vals.index_select(0, order)
    if vcol.dtype.id is TypeId.UINT32:
        vals = vals & 0xFFFFFFFF
    elif vcol.dtype.id is TypeId.UINT16:
        vals = vals & 0xFFFF
    identity = {"sum": 0, "mean": 0, "min": _I64_MAX, "max": _I64_MIN}[op]
    z = torch.where(valid, vals, identity)
    if op in ("sum", "mean"):
        res = (_sorted_segment_sum(z, seg_ids, num_segments) if sorted_ids
               else _chunked_scatter(z, seg_ids, num_segments, "sum"))
    elif sorted_ids:
        res = torch.full((num_segments,), identity, dtype=torch.int64,
                         device=vals.device)
        res.scatter_reduce_(0, seg_ids, z, "amin" if op == "min" else "amax")
    else:
        res = _chunked_scatter(z, seg_ids, num_segments,
                               "amin" if op == "min" else "amax")
    if op == "mean":
        res = res.to(torch.float64) / cnt.clamp(min=1).to(torch.float64)
    return Column(out_dtype, num_segments,
                  data=res.to(out_dtype.torch_dtype), validity=cnt > 0)


# ---------------------------------------------------------------------------
# DECIMAL128 values (sorted path)
# ---------------------------------------------------------------------------

def _decimal128_sum(vcol: Column, order: torch.Tensor, valid: torch.Tensor,
                    seg_ids: torch.Tensor, num_segments: int,
                    any_valid: torch.Tensor):
    """Exact 128-bit segment sums (the JAX package's
    _decimal128_segment_sum): each u32 limb, and a fifth limb of the
    sign extension, summed in int64 (exact for groups under 2^31 rows),
    then one carry pass per group gives the sum mod 2^128 — negative
    addends enter as their unsigned limbs, so the wrap is the signed sum.
    Returns (the sum Column, bool[G] where the true sum is outside
    int128: limb 4 is not the sign extension of limb 3)."""
    from .hashing import _lsr
    from .int128 import M32, take_words
    lo, hi = take_words(vcol.data, order)  # sorted
    # one 1-D prefix sum a limb (a scan down a column of an [n, 5] tensor
    # is far slower on the card)
    lanes = [torch.where(valid, x, 0) for x in
             (lo & M32, _lsr(lo, 32), hi & M32, _lsr(hi, 32))]
    lanes.append(torch.where(valid & (hi < 0), M32, 0))
    out = []
    carry = 0
    for z in lanes:
        t = _sorted_segment_sum(z, seg_ids, num_segments) + carry
        out.append(t & M32)
        carry = t >> 32
    wrap = out[4] != torch.where(out[3] >> 31 != 0, M32, 0)
    data = torch.stack(out[:4], dim=1).to(torch.int32)
    return Column(vcol.dtype, num_segments, data=data,
                  validity=any_valid), wrap


def _decimal128_minmax(vcol: Column, order: torch.Tensor,
                       valid: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, any_valid: torch.Tensor,
                       is_min: bool) -> Column:
    """128-bit segment min/max: the high 64 bits (signed) are reduced
    first, then the low 64 bits (unsigned, sign-flipped into int64 order)
    among each group's rows that hold the winning high word. A group
    with no valid row holds the JAX package's padding."""
    from .int128 import take_words
    lo, hi = take_words(vcol.data, order)  # sorted
    pad = _I64_MAX if is_min else _I64_MIN
    red = "amin" if is_min else "amax"
    hi = torch.where(valid, hi, pad)
    win_hi = torch.full((num_segments,), pad, dtype=torch.int64,
                        device=hi.device).scatter_reduce_(0, seg_ids, hi,
                                                          red)
    on_win = valid & (hi == win_hi.index_select(0, seg_ids))
    lo = torch.where(on_win, lo ^ _I64_MIN, pad)
    win_lo = torch.full_like(win_hi, pad).scatter_reduce_(0, seg_ids, lo,
                                                          red)
    data = torch.stack([win_lo ^ _I64_MIN, win_hi], dim=1).view(
        torch.int32)
    return Column(vcol.dtype, num_segments, data=data, validity=any_valid)


def _decimal128_mean(sum_wrap, num_segments: int, cnt: torch.Tensor,
                     out_dtype: dt.DType) -> Column:
    """Spark's avg(decimal): the exact group sum (``_decimal128_sum``'s
    (column, wrap)) over the group count (a scale-0 DECIMAL128) by
    ops/decimal128's HALF_UP division at scale min(s + 4, 38). An
    all-null group, a sum past int128 and a quotient overflow come back
    null."""
    from .decimal128 import divide_decimal128
    from .int128 import from_int64, storage
    sum_col, wrap = sum_wrap
    cnt_col = Column(dt.decimal128(0), num_segments,
                     data=storage(from_int64(cnt)))
    res = divide_decimal128(sum_col, cnt_col, out_dtype.scale)
    overflow = (res.columns[0].data != 0) | wrap
    return Column(out_dtype, num_segments, data=res.columns[1].data,
                  validity=(cnt > 0) & ~overflow)


def _check_row_mask(row_mask, n: int, device) -> Optional[torch.Tensor]:
    if row_mask is None:
        return None
    row_mask = torch.as_tensor(row_mask, device=device).bool()
    if row_mask.shape != (n,):
        raise ValueError(f"boolean row_mask shape {tuple(row_mask.shape)} "
                         f"!= table rows ({n},)")
    return row_mask


def _declines_fast_path(table: Table, aggs) -> bool:
    """A sort-free path keeps its hands off float sums and means (their
    order is the sorted path's) and off DECIMAL128 values (their limb
    carries stay on the sorted path), as the JAX package's do."""
    return any((table.columns[ci].dtype.is_floating and op in ("sum", "mean"))
               or table.columns[ci].dtype.id is TypeId.DECIMAL128
               for ci, op in aggs)


def _unsorted_aggs(table: Table, aggs, live: torch.Tensor,
                   seg_ids: torch.Tensor, num_segments: int
                   ) -> List[Column]:
    """The aggregations of a sort-free path (segment ids in table order)."""
    out = []
    state: Dict[int, dict] = {}
    for ci, op in aggs:
        st = state.get(ci)
        if st is None:
            vcol = enc.decoded_rows(table.columns[ci])
            valid = vcol.valid_mask() & live
            st = state[ci] = {"col": vcol, "valid": valid, "cnt":
                              _chunked_scatter(valid.to(torch.int64),
                                               seg_ids, num_segments, "sum")}
        vcol = st["col"]
        out.append(_segment_agg_fixed(vcol, None, st["valid"], seg_ids,
                                      num_segments, st["cnt"], op, st,
                                      sorted_ids=False))
    return out


def _dict_code_groupby(table: Table, key_indices, aggs, row_mask):
    """Sort-free groupby of a single DICT32 key: the ranks map codes
    straight to group-ordered slots (the null group first, then entries in
    rank order), so segmentation is a scatter over |dictionary|+1 slots
    instead of an n-row sort. A group's key is the entry of its slot, and
    its rows keep their table order, so the output is the sorted path's,
    bit for bit. None where it does not apply (several keys, float sum or
    mean)."""
    if len(key_indices) != 1:
        return None
    key = table.columns[key_indices[0]]
    if key.dtype.id is not TypeId.DICT32 or key.size == 0:
        return None
    if _declines_fast_path(table, aggs):
        return None
    from ..columnar.dictionary import dict_column
    from ..columnar.table_ops import mask_indices_core
    n = key.size
    dev = key.device
    ranks = key.children[1].data
    card = int(ranks.shape[0])
    if card:
        slot = torch.where(key.valid_mask(), ranks.index_select(
            0, key.data.to(torch.int64).clamp(0, card - 1)).to(torch.int64)
            + 1, 0)
    else:
        slot = torch.zeros(n, dtype=torch.int64, device=dev)
    live = _check_row_mask(row_mask, n, dev)
    if live is None:
        live = torch.ones(n, dtype=torch.bool, device=dev)
    present = _chunked_scatter(live.to(torch.int64), slot, card + 1,
                               "sum") > 0
    pos = torch.cumsum(present.to(torch.int64), 0) - 1  # slot -> group
    true_segments = int(present.sum())  # the op's one host sync
    num_segments = max(true_segments, 1)
    seg_ids = torch.where(live, pos.index_select(0, slot), 0)
    slot_of_group = mask_indices_core(present, true_segments).to(
        torch.int64)
    if true_segments == 0:
        slot_of_group = torch.zeros(1, dtype=torch.int64, device=dev)
    if card:
        inv_rank = torch.argsort(ranks.to(torch.int64))
        code_of_group = inv_rank.index_select(0, (slot_of_group - 1).clamp(
            min=0))
    else:
        code_of_group = torch.zeros_like(slot_of_group)
    validity = None if key.validity is None else slot_of_group > 0
    out_cols = [dict_column(code_of_group, key.children[0],
                            validity=validity, ranks=key.children[1])]
    out_cols += _unsorted_aggs(table, aggs, live, seg_ids, num_segments)
    return Table(tuple(_shrink(c, true_segments) for c in out_cols))


def _rle_groupby(table: Table, key_indices, aggs, row_mask):
    """Sort-free groupby of a single RLE key: the groups are the distinct
    (validity, value) pairs of the RUNS (host work per run), nulls first,
    then ascending — the sorted path's order — and each row's group is its
    run's. None where it does not apply (several keys, float sum or mean,
    no runs)."""
    if len(key_indices) != 1:
        return None
    key = table.columns[key_indices[0]]
    if key.dtype.id is not TypeId.RLE or key.size == 0:
        return None
    if _declines_fast_path(table, aggs):
        return None
    from ..columnar.table_ops import mask_indices_core
    n = key.size
    dev = key.device
    values, lengths = enc.rle_values(key), enc.rle_lengths(key)
    r = values.size
    if r == 0:
        return None
    rvals = values.to_numpy().astype(np.int64)
    rvalid = (values.validity.cpu().numpy() if values.validity is not None
              else np.ones(r, dtype=bool))
    rlens = enc._host(lengths).astype(np.int64)
    live_run = rlens > 0  # zero-length runs cover no rows: no groups
    # the distinct (validity, value) pairs of the live runs, the null
    # group first: the JAX package's np.unique over (valid, value)
    # records, as one unique of the valid values
    live_valid = live_run & rvalid
    has_null = bool((live_run & ~rvalid).any())
    uniq, inverse = np.unique(rvals[live_valid], return_inverse=True)
    run_group = np.zeros(r, dtype=np.int64)  # null runs: group 0
    run_group[live_valid] = inverse.reshape(-1) + int(has_null)
    gvals = np.concatenate([np.zeros(int(has_null), np.int64), uniq])
    gvalid = np.arange(gvals.size) >= int(has_null)
    num_groups = int(gvals.size)
    rid = enc.row_to_run(enc.run_ends_device(key), n)
    slot = torch.from_numpy(run_group).to(dev).index_select(0, rid)
    live = _check_row_mask(row_mask, n, dev)
    if live is not None:
        present = _chunked_scatter(live.to(torch.int64), slot, num_groups,
                                   "sum") > 0
        pos = torch.cumsum(present.to(torch.int64), 0) - 1
        true_segments = int(present.sum())  # the op's one host sync
        seg_ids = torch.where(live, pos.index_select(0, slot), 0)
        slot_of_group = mask_indices_core(present, true_segments).to(
            torch.int64)
    else:
        live = torch.ones(n, dtype=torch.bool, device=dev)
        true_segments = num_groups  # every group has rows: no sync
        seg_ids = slot
        slot_of_group = torch.arange(num_groups, device=dev)
    num_segments = max(true_segments, 1)
    if true_segments == 0:
        slot_of_group = torch.zeros(1, dtype=torch.int64, device=dev)
    key_data = Column.from_numpy(gvals.astype(values.dtype.np_dtype),
                                 values.dtype, device=dev).data.index_select(
                                     0, slot_of_group)
    key_valid = (torch.from_numpy(gvalid).to(dev).index_select(
        0, slot_of_group) if values.validity is not None else None)
    out_cols = [Column(values.dtype, num_segments, data=key_data,
                       validity=key_valid)]
    out_cols += _unsorted_aggs(table, aggs, live, seg_ids, num_segments)
    return Table(tuple(_shrink(c, true_segments) for c in out_cols))


@func_range()
def groupby_aggregate(table: Table, key_indices: Sequence[int],
                      aggs: Sequence[Tuple[int, str]],
                      row_mask=None) -> Table:
    """Group by the key columns and aggregate.

    ``aggs``: (column_index, op), op in {sum, count, min, max, mean}.
    Returns a Table of [keys..., one column per agg] in group order (keys
    ascending, nulls first). ``row_mask`` (bool[n]) pushes a filter down: the result
    of ``groupby_aggregate(filter_table(table, row_mask), ...)`` with no
    compaction — masked rows sort after every live row into dead groups
    that the final slice drops."""
    # peak ~ input + sorted/gathered intermediates (reservation bracketing)
    with device_reservation(2 * table.device_nbytes()) as took:
        return release_barrier(
            _groupby_aggregate(table, key_indices, aggs, row_mask), took)


def _groupby_aggregate(table: Table, key_indices: Sequence[int],
                       aggs: Sequence[Tuple[int, str]],
                       row_mask=None) -> Table:
    for ci, op in aggs:
        _agg_out_dtype(_value_dtype(table.columns[ci]), op)
    for fast in (_dict_code_groupby, _rle_groupby):
        out = fast(table, key_indices, aggs, row_mask)
        if out is not None:
            return out
    if any(table.columns[ci].dtype.is_encoded for ci, _ in aggs):
        # encoded VALUE columns decode here; encoded keys stay encoded
        # (sort lanes, key equality and the gather decode their own)
        cols = list(table.columns)
        for ci, _ in aggs:
            cols[ci] = enc.decoded_rows(cols[ci])
        table = Table(tuple(cols))
    keys = [table.columns[i] for i in key_indices]
    dead_col = None
    row_mask = _check_row_mask(row_mask, table.num_rows, table.device)
    if row_mask is not None:
        dead_col = Column(dt.BOOL8, keys[0].size,
                          data=(~row_mask).to(torch.uint8))
    cmp_keys = ([dead_col] + keys) if dead_col is not None else keys
    order = sort_order(cmp_keys)

    if keys[0].size == 0:
        out_cols: List[Column] = [gather(k, order) for k in keys]
        for ci, op in aggs:
            od = _agg_out_dtype(table.columns[ci].dtype, op)
            shape = (0, 4) if od.id is TypeId.DECIMAL128 else (0,)
            out_cols.append(Column(od, 0, data=torch.zeros(
                shape, dtype=od.torch_dtype, device=table.device)))
        return Table(tuple(out_cols))

    boundary, seg_ids = _segment_structure(cmp_keys, order)
    if dead_col is None:
        num_segments = live_groups = int(seg_ids[-1]) + 1  # one host sync
    else:
        # live rows sort first, so the last live row's group bounds the
        # live prefix; both counts cross in one sync
        n_live = row_mask.sum()
        lg = torch.where(n_live > 0,
                         seg_ids[(n_live - 1).clamp(min=0)] + 1, 0)
        num_segments, live_groups = torch.stack([seg_ids[-1] + 1,
                                                 lg]).tolist()

    rep_rows = order[torch.nonzero(boundary).reshape(-1)]
    out_cols = [gather(k, rep_rows) for k in keys]
    state: Dict[int, dict] = {}
    for ci, op in aggs:
        vcol = table.columns[ci]
        st = state.setdefault(ci, {})
        if "cnt" not in st:
            st["valid"] = vcol.valid_mask().index_select(0, order)
            st["cnt"] = _sorted_segment_sum(st["valid"].to(torch.int64),
                                            seg_ids, num_segments)
        out_cols.append(_segment_agg_fixed(vcol, order, st["valid"],
                                           seg_ids, num_segments, st["cnt"],
                                           op, st))
    return Table(tuple(_shrink(c, live_groups) for c in out_cols))


def _shrink(col: Column, n: int) -> Column:
    """The first ``n`` groups (drops the dead groups of a row_mask)."""
    if col.size == n:
        return col
    if col.dtype.id is TypeId.STRING:
        return gather(col, torch.arange(n, device=col.device))
    validity = None if col.validity is None else col.validity[:n]
    return Column(col.dtype, n, data=col.data[:n], validity=validity,
                  children=col.children)


def _take1(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-dim index tensor without a host sync (indexing
    with a 0-dim tensor reads it back as a Python int)."""
    return t.index_select(0, i.reshape(1)).reshape(())


def _segment_sum(contrib: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, seg, contrib)


@plan_core("groupby")
def groupby_core(keys: List[Column], aggs: Sequence[Tuple[Column, str]],
                 row_mask: Optional[torch.Tensor], num_segments: int):
    """The sorted groupby with a STATIC slot count G = ``num_segments``:
    the same lanes, stable sort and segment math as ``groupby_aggregate``,
    for the fused plan engine.

    ``keys``: key Columns of n >= 1 rows. ``aggs``: (value Column, op).
    ``row_mask``: optional bool[n] filter pushdown (dead rows sort after
    every live row).

    Returns ``(out_cols, live_groups, overflow)``: G-slot Columns [keys...,
    one per agg] whose slots at and past ``live_groups`` (int32 0-dim) are
    garbage the caller trims, and ``overflow`` (bool 0-dim), set when the
    live groups outnumber G — the slots are then meaningless and the
    executor replays the query eagerly. Rows past slot G-1 contribute each
    op's identity (a float sum adds +0.0 for each, in its sorted place),
    so live slots equal the eager op's groups bit for bit.
    """
    n = keys[0].size
    dev = keys[0].device
    aggs = [(enc.decoded_rows(v), op) for v, op in aggs]
    dead_col = None
    if row_mask is not None:
        dead_col = Column(dt.BOOL8, n, data=(~row_mask).to(torch.uint8))
    cmp_keys = ([dead_col] + keys) if dead_col is not None else keys
    order = lexsort(sort_lanes(cmp_keys), n, dev)
    _, seg_ids = _segment_structure(cmp_keys, order)
    if row_mask is None:
        live_groups = seg_ids[-1] + 1
    else:
        n_live = row_mask.sum()
        live_groups = torch.where(
            n_live > 0, _take1(seg_ids, (n_live - 1).clamp(min=0)) + 1, 0)
    live_groups = live_groups.to(torch.int32)
    overflow = live_groups > num_segments
    seg_c = seg_ids.clamp(max=num_segments - 1)
    row_ok = seg_ids < num_segments
    if row_mask is not None:
        row_ok = row_ok & row_mask.index_select(0, order)
    # first sorted row of each of the first G segments (slots past the
    # live groups point at row 0, as the JAX package's fill does)
    first = torch.searchsorted(seg_c, torch.arange(
        num_segments, dtype=torch.int64, device=dev))
    first = torch.where(first < n, first, 0)
    rep_rows = order.index_select(0, first)
    out_cols = [gather(k, rep_rows) for k in keys]
    state: Dict[int, dict] = {}  # per value column: mask, count, H1
    for vcol, op in aggs:
        st = state.setdefault(id(vcol), {"col": vcol})
        if "cnt" not in st:
            st["valid"] = vcol.valid_mask().index_select(0, order) & row_ok
            st["cnt"] = _sorted_segment_sum(st["valid"].to(torch.int64),
                                            seg_c, num_segments)
        out_cols.append(_segment_agg_fixed(vcol, order, st["valid"], seg_c,
                                           num_segments, st["cnt"], op, st))
    return out_cols, live_groups, overflow


@plan_core("groupby_direct_small")
def groupby_direct_small_core(key: torch.Tensor, value: torch.Tensor,
                              row_mask: Optional[torch.Tensor], lo: int,
                              span: int, num_slots: int, chunk: int):
    """Direct-slot groupby of a single int64 key of a tiny span with one
    integer sum (the TPC-H q5 tail). The planner picks it only when stats
    prove every key in [lo, lo + span) and every value in (0, 2^48), so a
    slot is live iff its sum is positive.

    Each live row adds its value to slot ``key - lo + 1`` of span + 2
    accumulators (slot 0 takes the dead rows' zeros); a LIVE row that
    breaks either claim adds 1 to the sentinel slot span + 1 instead, and
    ``bad`` is that slot's sum > 0, so the claims are re-checked over the
    live rows only — dead rows cannot corrupt a sum either way. Each
    ``chunk`` of rows scatters into its own row of accumulators, summed
    at the end: a scatter of every row into span + 2 slots would make the
    atomics of all rows contend for a few addresses. (The JAX package
    packs slot and value into one word and scans the same chunks; the sums
    are exact int64 in any order.)

    Returns ``(slot_keys i64[G], sums i64[G], live i32, bad bool)``, G =
    ``num_slots`` >= span + 1, with the live slots compacted to a
    key-ascending prefix."""
    n = key.shape[0]
    dev = key.device
    keep = (row_mask if row_mask is not None
            else torch.ones(n, dtype=torch.bool, device=dev))
    ok = (key >= lo) & (key < lo + span) & (value > 0) & (value < (1 << 48))
    gid = torch.where(keep, torch.where(ok, key - lo + 1, span + 1), 0)
    contrib = torch.where(keep, torch.where(ok, value, 1), 0)
    nacc = span + 2
    blocks = -(-n // chunk)
    dest = torch.arange(n, dtype=torch.int64, device=dev) // chunk * nacc
    small = _segment_sum(contrib, dest + gid, blocks * nacc).view(
        blocks, nacc).sum(0)
    bad = small[span + 1] > 0
    sums = torch.zeros(num_slots, dtype=torch.int64, device=dev)
    sums[:span + 1] = small[:span + 1]
    gids = torch.arange(num_slots, dtype=torch.int64, device=dev)
    livem = (sums > 0) & (gids > 0)
    order = torch.sort(torch.where(livem, gids, num_slots),
                       stable=True).indices
    slot_keys = gids.index_select(0, order) - 1 + lo
    live = livem.sum().to(torch.int32)
    return slot_keys, sums.index_select(0, order), live, bad


@plan_core("groupby_direct_wide")
def groupby_direct_wide_core(key: torch.Tensor, aggs,
                             row_mask: Optional[torch.Tensor], lo: int,
                             span: int, num_slots: int,
                             live_agg: Optional[int]):
    """Direct-slot groupby of a single int64 key of a WIDE span: one
    scatter-add per aggregate instead of a sort (the FD-reduced TPC-H q3
    groupby). ``aggs``: (value i64[n] or None, op) with op in sum/count.
    ``live_agg``: index of a sum whose values stats prove > 0, making slot
    liveness its sum > 0; None adds a count scatter.

    Slot s holds key ``lo + s``, in key order, NOT compacted:
    ``live_mask[s]`` marks the real groups. ``bad`` re-checks the span
    claim over every row (overflow semantics).

    Returns ``(slot_keys i64[G], out_sums tuple, live_mask bool[G], live
    i32, bad bool)``."""
    n = key.shape[0]
    bad = ~((key >= lo) & (key < lo + span)).all()
    keep = (row_mask if row_mask is not None
            else torch.ones(n, dtype=torch.bool, device=key.device))
    seg = (key - lo).clamp(0, num_slots - 1)
    outs = []
    for val, op in aggs:
        if op == "count":
            contrib = keep.to(torch.int64)
        else:
            contrib = torch.where(keep, val, 0)
        outs.append(_segment_sum(contrib, seg, num_slots))
    if live_agg is None:
        live_mask = _segment_sum(keep.to(torch.int32), seg, num_slots) > 0
    else:
        live_mask = outs[live_agg] > 0
    slot_keys = torch.arange(num_slots, dtype=torch.int64,
                             device=key.device) + lo
    live = live_mask.sum().to(torch.int32)
    return slot_keys, tuple(outs), live_mask, live, bad
