"""Sort-based groupby-aggregate (the sorted path of the JAX package's
ops/groupby.py).

  1. ``sort_order`` over the key columns (nulls form their own group and
     sort first, Spark's default);
  2. segment boundaries where a sorted row's keys differ from the row
     before it (float keys over normalized bits: NaNs equal, -0.0 == 0.0);
  3. segmented reductions over the sorted values.

Aggregations: sum, count, min and max over integer-valued columns, with
Spark's null rules (nulls ignored; an all-null group gives a null result;
count counts non-nulls). Integer sums wrap as int64, in any order, so the
scatter-add reductions here equal the JAX package's exactly. Float sum
and mean need the JAX package's summation order (ROADMAP A4) and raise.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table
from ..columnar.dtype import TypeId
from .hashing import spark_key_values
from .sort import gather, sort_order

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _keys_equal_prev(col: Column, order: torch.Tensor) -> torch.Tensor:
    """bool[n-1]: sorted row i+1 equals sorted row i on this key column
    (two nulls are equal)."""
    idx, pidx = order[1:], order[:-1]
    valid = col.valid_mask()
    v_cur, v_prev = valid[idx], valid[pidx]
    vals = spark_key_values(col)
    same_val = vals[idx] == vals[pidx]
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
    if vdtype.is_floating or op == "mean":
        raise dt.not_ported(f"groupby {op} over {vdtype.id.value}",
                            "A4, float aggregates in the reference's "
                            "summation order")
    if vdtype.is_decimal or vdtype.id is TypeId.UINT64:
        raise dt.not_ported(f"groupby {op} over {vdtype.id.value}",
                            "A4, decimal and unsigned 64-bit aggregates")
    return dt.INT64 if op == "sum" else vdtype


def _segment_agg_fixed(vcol: Column, order: torch.Tensor,
                       valid: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, cnt: torch.Tensor,
                       op: str) -> Column:
    """One aggregation over sorted segments. ``valid`` is the per-sorted-row
    contribution mask; masked rows contribute the op's identity."""
    out_dtype = _agg_out_dtype(vcol.dtype, op)
    if op == "count":
        return Column(dt.INT64, num_segments, data=cnt)
    vals = vcol.data[order].to(torch.int64)
    if vcol.dtype.id is TypeId.UINT32:
        vals = vals & 0xFFFFFFFF
    elif vcol.dtype.id is TypeId.UINT16:
        vals = vals & 0xFFFF
    identity = {"sum": 0, "min": _I64_MAX, "max": _I64_MIN}[op]
    z = torch.where(valid, vals, identity)
    res = torch.full((num_segments,), identity, dtype=torch.int64,
                     device=vals.device)
    if op == "sum":
        res.index_add_(0, seg_ids, z)
    else:
        res.scatter_reduce_(0, seg_ids, z, "amin" if op == "min" else "amax")
    return Column(out_dtype, num_segments,
                  data=res.to(out_dtype.torch_dtype), validity=cnt > 0)


def groupby_aggregate(table: Table, key_indices: Sequence[int],
                      aggs: Sequence[Tuple[int, str]],
                      row_mask=None) -> Table:
    """Group by the key columns and aggregate.

    ``aggs``: (column_index, op), op in {sum, count, min, max}. Returns a
    Table of [keys..., one column per agg] in group order (keys ascending,
    nulls first). ``row_mask`` (bool[n]) pushes a filter down: the result
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
        valid = vcol.valid_mask()[order]
        cnt = torch.zeros(num_segments, dtype=torch.int64,
                          device=valid.device)
        cnt.index_add_(0, seg_ids, valid.to(torch.int64))
        out_cols.append(_segment_agg_fixed(vcol, order, valid, seg_ids,
                                           num_segments, cnt, op))
    return Table(tuple(_shrink(c, live_groups) for c in out_cols))


def _shrink(col: Column, n: int) -> Column:
    """The first ``n`` groups (drops the dead groups of a row_mask)."""
    if col.size == n:
        return col
    validity = None if col.validity is None else col.validity[:n]
    return Column(col.dtype, n, data=col.data[:n], validity=validity)
