"""Sort-based groupby-aggregate (the JAX package's ops/groupby.py).

  1. ``sort_order`` over the key columns (nulls form their own group and
     sort first, Spark's default);
  2. segment boundaries where a sorted row's keys differ from the row
     before it (float keys over normalized bits: NaNs equal, -0.0 == 0.0);
  3. segmented reductions over the sorted values.

Aggregations: sum, count, min, max and mean over integer-valued columns,
with Spark's null rules (nulls ignored; an all-null group gives a null
result; count counts non-nulls). Integer sums wrap as int64, in any
order, so the scatter-add reductions here equal the JAX package's
exactly; a mean is that exact sum divided once by ``max(count, 1)`` in
float64, as the JAX package divides it. Float sum and mean need the JAX
package's summation order (ROADMAP A4) and raise.

The plan cores (plan/registry.py) the fused plan engine composes:
``groupby_core`` (the same sort and segment math with a static slot
count), ``groupby_direct_small_core`` and ``groupby_direct_wide_core``
(direct-addressed slots for a single integer key of a known span).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table
from ..columnar.dtype import TypeId
from ..plan.registry import plan_core
from .hashing import spark_key_values
from .sort import gather, lexsort, sort_lanes, sort_order

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _keys_equal_prev(col: Column, order: torch.Tensor) -> torch.Tensor:
    """bool[n-1]: sorted row i+1 equals sorted row i on this key column
    (two nulls are equal)."""
    idx, pidx = order[1:], order[:-1]
    valid = col.valid_mask()
    v_cur, v_prev = valid.index_select(0, idx), valid.index_select(0, pidx)
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
    """Result dtype of an aggregation, and the one validation point:
    Spark's sum(int) -> long, count -> long, min/max keep the type."""
    if op == "count":
        return dt.INT64
    if op not in ("sum", "min", "max", "mean"):
        raise ValueError(f"unknown aggregation {op}")
    vdtype.require_stored()
    if vdtype.is_floating:
        raise dt.not_ported(f"groupby {op} over {vdtype.id.value}",
                            "A4, float aggregates in the reference's "
                            "summation order")
    if vdtype.is_decimal or vdtype.id is TypeId.UINT64:
        raise dt.not_ported(f"groupby {op} over {vdtype.id.value}",
                            "A4, decimal and unsigned 64-bit aggregates")
    if op == "mean":
        return dt.FLOAT64
    return dt.INT64 if op == "sum" else vdtype


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
    ids = torch.arange(num_segments, dtype=seg.dtype, device=seg.device)
    lo = torch.searchsorted(seg, ids)
    hi = torch.searchsorted(seg, ids, right=True)
    return prefix.index_select(0, hi) - prefix.index_select(0, lo)


def _segment_agg_fixed(vcol: Column, order: torch.Tensor,
                       valid: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, cnt: torch.Tensor,
                       op: str) -> Column:
    """One aggregation over sorted segments (``seg_ids`` non-decreasing).
    ``valid`` is the per-sorted-row contribution mask; masked rows
    contribute the op's identity."""
    out_dtype = _agg_out_dtype(vcol.dtype, op)
    if op == "count":
        return Column(dt.INT64, num_segments, data=cnt)
    vals = vcol.data.index_select(0, order).to(torch.int64)
    if vcol.dtype.id is TypeId.UINT32:
        vals = vals & 0xFFFFFFFF
    elif vcol.dtype.id is TypeId.UINT16:
        vals = vals & 0xFFFF
    identity = {"sum": 0, "mean": 0, "min": _I64_MAX, "max": _I64_MIN}[op]
    z = torch.where(valid, vals, identity)
    res = torch.full((num_segments,), identity, dtype=torch.int64,
                     device=vals.device)
    if op in ("sum", "mean"):
        res = _sorted_segment_sum(z, seg_ids, num_segments)
    else:
        res.scatter_reduce_(0, seg_ids, z, "amin" if op == "min" else "amax")
    if op == "mean":
        res = res.to(torch.float64) / cnt.clamp(min=1).to(torch.float64)
    return Column(out_dtype, num_segments,
                  data=res.to(out_dtype.torch_dtype), validity=cnt > 0)


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
    keys = [table.columns[i] for i in key_indices]
    for ci, op in aggs:
        _agg_out_dtype(table.columns[ci].dtype, op)
    dead_col = None
    if row_mask is not None:
        row_mask = torch.as_tensor(row_mask, device=table.device).bool()
        if row_mask.shape != (table.num_rows,):
            raise ValueError(f"boolean row_mask shape "
                             f"{tuple(row_mask.shape)} != table rows "
                             f"({table.num_rows},)")
        dead_col = Column(dt.BOOL8, keys[0].size,
                          data=(~row_mask).to(torch.uint8))
    cmp_keys = ([dead_col] + keys) if dead_col is not None else keys
    order = sort_order(cmp_keys)

    if keys[0].size == 0:
        out_cols: List[Column] = [gather(k, order) for k in keys]
        for ci, op in aggs:
            od = _agg_out_dtype(table.columns[ci].dtype, op)
            out_cols.append(Column(od, 0, data=torch.zeros(
                0, dtype=od.torch_dtype, device=table.device)))
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
    for ci, op in aggs:
        vcol = table.columns[ci]
        valid = vcol.valid_mask().index_select(0, order)
        cnt = _sorted_segment_sum(valid.to(torch.int64), seg_ids,
                                  num_segments)
        out_cols.append(_segment_agg_fixed(vcol, order, valid, seg_ids,
                                           num_segments, cnt, op))
    return Table(tuple(_shrink(c, live_groups) for c in out_cols))


def _shrink(col: Column, n: int) -> Column:
    """The first ``n`` groups (drops the dead groups of a row_mask)."""
    if col.size == n:
        return col
    validity = None if col.validity is None else col.validity[:n]
    return Column(col.dtype, n, data=col.data[:n], validity=validity)


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
    op's identity, so live slots equal the eager op's groups bit for bit.
    """
    n = keys[0].size
    dev = keys[0].device
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
    for vcol, op in aggs:
        valid = vcol.valid_mask().index_select(0, order) & row_ok
        cnt = _sorted_segment_sum(valid.to(torch.int64), seg_c,
                                  num_segments)
        out_cols.append(_segment_agg_fixed(vcol, order, valid, seg_c,
                                           num_segments, cnt, op))
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
