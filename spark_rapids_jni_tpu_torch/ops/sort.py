"""Multi-key table sort and row gather (the JAX package's ops/sort.py).

Every key column becomes one or more int64 *monotone lanes* — signed
int64 order over a lane is the key's Spark order — and the lanes are
sorted from the least significant to the most significant with stable
sorts. That is the permutation the JAX package's stable lexsort gives:
rows ordered by their keys, ties in row order. Descending flips a lane
with ``~``; a null lane above a column's value lanes places its nulls.

``sort_lanes`` and ``select_topk_core`` are plan cores (plan/registry.py):
the fused plan engine composes them, so the eager and fused paths order
rows through the same lanes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..columnar.column import Column, Table
from ..columnar.dtype import TypeId
from ..plan.registry import plan_core
from .hashing import _f32_bits, _f64_bits

_SIGN64 = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def _monotone_unsigned(col: Column) -> List[torch.Tensor]:
    """int64 lane(s) for one key column, most significant first, whose
    signed order is the order of the JAX package's unsigned lane: signed
    values as they are, unsigned values zero-extended (UINT64 with its
    sign bit flipped), floats through the IEEE total-order transform after
    NaN canonicalization and -0.0 folding. Null rows may hold anything
    (the null lane masks them)."""
    tid = col.dtype.id
    data = col.data
    if tid is TypeId.FLOAT64:
        bits = _f64_bits(data, normalize_zero=True)
        ukey = torch.where(bits < 0, ~bits, bits | _SIGN64)
        return [ukey ^ _SIGN64]
    if tid is TypeId.FLOAT32:
        bits = _f32_bits(data, normalize_zero=True).to(torch.int64)
        ukey = torch.where(bits < 0, ~bits, bits | (1 << 31))
        return [ukey & 0xFFFFFFFF]
    if tid is TypeId.UINT64:
        return [data ^ _SIGN64]
    if tid is TypeId.UINT32:
        return [data.to(torch.int64) & 0xFFFFFFFF]
    if tid is TypeId.UINT16:
        return [data.to(torch.int64) & 0xFFFF]
    col.dtype.require_stored()
    # signed integers, decimals, timestamps; BOOL8/UINT8 are stored uint8
    return [data.to(torch.int64)]


@plan_core("sort_lanes")
def sort_lanes(keys: Sequence[Column],
               ascending: Optional[Sequence[bool]] = None,
               nulls_first: Optional[Sequence[bool]] = None
               ) -> List[torch.Tensor]:
    """Monotone lanes of a key set, least significant FIRST (the primary
    key's lanes come last)."""
    if ascending is None:
        ascending = [True] * len(keys)
    if nulls_first is None:
        nulls_first = list(ascending)
    lanes: List[torch.Tensor] = []
    for col, asc, nf in reversed(list(zip(keys, ascending, nulls_first))):
        value_lanes = _monotone_unsigned(col)
        if not asc:
            value_lanes = [~v for v in value_lanes]
        lanes.extend(reversed(value_lanes))
        if col.validity is not None:
            lanes.append(torch.where(col.validity, 1 if nf else 0,
                                     0 if nf else 1).to(torch.int64))
    return lanes


def sort_order(keys: Sequence[Column],
               ascending: Optional[Sequence[bool]] = None,
               nulls_first: Optional[Sequence[bool]] = None
               ) -> torch.Tensor:
    """Stable int64 order indices sorting by ``keys[0]`` then the rest.
    Defaults follow Spark SQL: ascending, NULLS FIRST."""
    return lexsort(sort_lanes(keys, ascending, nulls_first), keys[0].size,
                   keys[0].device)


def lexsort(lanes: Sequence[torch.Tensor], n: int,
            device: torch.device) -> torch.Tensor:
    """int64 permutation ordering rows by ``lanes`` (least significant
    first, as ``sort_lanes`` returns them): one stable sort per lane, ties
    in row order."""
    order = torch.arange(n, dtype=torch.int64, device=device)
    for lane in lanes:
        order = order.index_select(
            0, torch.sort(lane.index_select(0, order), stable=True).indices)
    return order


def gather(col: Column, idx: torch.Tensor) -> Column:
    """Rows ``idx`` (int64, in range) of a fixed-width column."""
    col.dtype.require_stored()
    validity = (None if col.validity is None
                else col.validity.index_select(0, idx))
    return Column(col.dtype, int(idx.shape[0]),
                  data=col.data.index_select(0, idx), validity=validity)


@plan_core("select_topk")
def select_topk_core(lanes: Sequence[torch.Tensor], live: torch.Tensor,
                     k: int) -> torch.Tensor:
    """int64 indices of the first ``k`` live rows in ``lanes`` order: k
    rounds, each a minimum down the lanes from the most significant, then
    the lowest row index among the rows that tie on every lane — the order
    of a stable sort, so the top k equal a sort followed by a slice.

    ``live``: bool[n]. Rounds past the live count return index 0, which
    the caller masks off with its own live count."""
    n = live.shape[0]
    if k == 0:
        return torch.zeros(0, dtype=torch.int64, device=live.device)
    rowids = torch.arange(n, dtype=torch.int64, device=live.device)
    alive = live
    picks = []
    for _ in range(k):
        cand = alive
        for lane in reversed(lanes):
            m = torch.where(cand, lane, _I64_MAX).min()
            cand = cand & (lane == m)
        # argmax takes no bool; on ties it returns the first index
        w = torch.argmax(cand.to(torch.uint8))
        picks.append(w)
        alive = alive & (rowids != w)
    return torch.stack(picks)


def sort_table(table: Table, key_indices: Sequence[int],
               ascending: Optional[Sequence[bool]] = None,
               nulls_first: Optional[Sequence[bool]] = None) -> Table:
    keys = [table.columns[i] for i in key_indices]
    order = sort_order(keys, ascending, nulls_first)
    return Table(tuple(gather(c, order) for c in table.columns))
