"""Split-and-retry support for fused plans (the OOM degradation ladder; the
JAX package's plan/split.py).

When the pool answers a fused ``plan_execute`` dispatch with
``TpuSplitAndRetryOOM``, the executor halves the scan input on row
boundaries and re-runs the piece program per piece (equal-size halves
share one input signature, so the second piece is a ProgramCache hit).
This module owns everything that makes that exact:

* ``split_unmergeable_reason`` — the gate. Splitting is offered only for
  plans whose piece results merge BIT-IDENTICALLY to the unsplit run:
  linear Filter/Project chains (row-local, order-preserving -> concat) and
  chains whose first GroupBy commutes over row partitions (partial
  aggregates, merged). Everything else — DAG/Join plans (the probe side's
  row order spans the build), Sort/Limit before the first GroupBy (pieces
  would interleave), float non-count aggregations (accumulation order),
  RLE/FOR-encoded inputs (run/packed buffers don't split on row
  boundaries; DICT32 is fine — codes row-slice and the dictionary
  children are shared) — names its reason and the executor degrades to
  the eager interpreter instead: never an approximation.

* ``split_table`` — halve at ``n // 2`` (even inputs give equal halves).

* ``prepare`` / ``merge_pieces`` — the piece plan and the exact merge.
  Filter/Project: concatenate piece outputs in piece order. GroupBy:
  pieces run the prefix chain + a PARTIAL GroupBy (count always rides;
  sum for sum/mean; min/max for themselves), and the merge re-groups the
  concatenated partial rows through the same ``groupby_core`` (counts
  merge by summing), recomputes mean with the identical division
  expression, then applies any post-GroupBy suffix (Sort/Limit/Project
  over the merged group state) through the eager interpreter — the oracle
  the fused lowering is bit-identical to by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table
from ..ops.groupby import groupby_core
from ..utils.shapes import bucket_size
from . import expr as ex
from .nodes import (GroupBy, Limit, PlanError, PlanNode, Project, Scan,
                    Sort, is_dag, linearize)

_FLOAT_IDS = (dt.TypeId.FLOAT32, dt.TypeId.FLOAT64)
_ENCODED_IDS = (dt.TypeId.RLE, dt.TypeId.FOR32, dt.TypeId.FOR64)


class SplitMergeOverflow(Exception):
    """The merged group count exceeded the solo slot budget — the solo
    run would have overflowed too; the caller re-runs eagerly."""


class SplitMergeError(Exception):
    """A degenerate merge input (e.g. every piece filtered to zero
    groups) — the caller re-runs eagerly rather than hand-building
    empty padded state."""


def split_unmergeable_reason(plan: PlanNode,
                             table: Table) -> Optional[str]:
    """Why splitting this (plan, table) on row boundaries cannot merge
    bit-identically — None when it can. A gated plan still degrades safely
    (eager fallback), it just never risks a wrong merged answer."""
    if is_dag(plan):
        return ("plan is a DAG (Join) — the probe side's row order "
                "spans the build side; pieces don't merge")
    for i, c in enumerate(table.columns):
        if c.dtype.id in _ENCODED_IDS:
            return (f"column {i} is {c.dtype.id.value}-encoded — run/"
                    f"packed buffers don't split on row boundaries")
    nodes = linearize(plan)
    is_float = [c.dtype.id in _FLOAT_IDS for c in table.columns]
    for node in nodes[1:]:
        if isinstance(node, Project):
            is_float = [isinstance(e, ex.Col) and is_float[e.index]
                        for e in node.exprs]
        elif isinstance(node, GroupBy):
            for i, op in node.aggs:
                if op != "count" and is_float[i]:
                    return (f"{op} over a float value column is "
                            f"accumulation-order-sensitive across pieces")
            return None  # merged group state is whole-input state; any
            # suffix (Sort/Limit/Project) applies post-merge
        elif isinstance(node, Sort):
            return ("Sort precedes the first GroupBy — piece outputs "
                    "would interleave, not concatenate")
        elif isinstance(node, Limit):
            return "Limit precedes the first GroupBy"
    return None  # pure Filter/Project chain: concat merge


@dataclasses.dataclass
class SplitSpec:
    """How pieces run and how their results merge back."""

    piece_plan: PlanNode                      # what each piece runs fused
    groupby: Optional[GroupBy]                # None => concat merge
    porder: Tuple[Tuple[int, str], ...]       # partial slots, in order
    pindex: Dict[Tuple[int, str], int]        # (col, op) -> slot
    suffix: Tuple[PlanNode, ...]              # post-GroupBy nodes


def prepare(plan: PlanNode) -> SplitSpec:
    """Build the piece plan + merge spec for a plan that passed
    ``split_unmergeable_reason``."""
    nodes = linearize(plan)
    g = next((k for k, n in enumerate(nodes) if isinstance(n, GroupBy)),
             None)
    if g is None:
        return SplitSpec(plan, None, (), {}, ())
    gb = nodes[g]
    assert isinstance(gb, GroupBy)

    # the commuting-partial decomposition: every value column rides ONE
    # count partial (global null semantics), mean shares the sum partial
    porder: List[Tuple[int, str]] = []
    pindex: Dict[Tuple[int, str], int] = {}

    def need(i: int, op: str) -> int:
        if (i, op) not in pindex:
            pindex[(i, op)] = len(porder)
            porder.append((i, op))
        return pindex[(i, op)]

    for i, op in gb.aggs:
        need(i, "count")
        if op in ("sum", "mean"):
            need(i, "sum")
        elif op in ("min", "max"):
            need(i, op)
        elif op != "count":
            raise PlanError(f"unknown aggregation {op}")

    piece: PlanNode = nodes[0]
    for node in nodes[1:g]:
        piece = dataclasses.replace(node, child=piece)
    piece = GroupBy(piece, gb.keys, tuple(porder))
    return SplitSpec(piece, gb, tuple(porder), pindex, tuple(nodes[g + 1:]))


def _slice_rows(c: Column, lo: int, hi: int) -> Column:
    v = c.validity[lo:hi] if c.validity is not None else None
    return Column(c.dtype, hi - lo, data=c.data[lo:hi], validity=v,
                  children=c.children)


def split_table(table: Table) -> List[Table]:
    """Halve on the row axis at ``n // 2``. Even inputs yield equal
    halves — one piece program, one ProgramCache hit; DICT32 children
    (the dictionary) are shared by reference so the encoding component
    of the cache key is identical across pieces."""
    n = table.num_rows
    if n < 2:
        return [table]  # with_retry turns a 1-piece split into a typed OOM
    h = n // 2
    a = Table(tuple(_slice_rows(c, 0, h) for c in table.columns))
    b = Table(tuple(_slice_rows(c, h, n) for c in table.columns))
    return [a, b]


def _concat_col(cols: List[Column]) -> Column:
    n = sum(c.size for c in cols)
    data = torch.cat([c.data for c in cols])
    if any(c.validity is not None for c in cols):
        validity = torch.cat([c.valid_mask() for c in cols])
    else:
        validity = None
    return Column(cols[0].dtype, n, data=data, validity=validity,
                  children=cols[0].children)


def _concat_tables(pieces: List[Table]) -> Table:
    return Table(tuple(
        _concat_col([p.columns[i] for p in pieces])
        for i in range(pieces[0].num_columns)))


def merge_pieces(spec: SplitSpec, pieces: List[Table], n_rows: int,
                 max_groups: int) -> Table:
    """Merge final piece results into the exact unsplit answer.

    ``n_rows`` is the ORIGINAL input row count: the merge groupby uses
    the solo slot budget ``bucket_size(min(max_groups, n_rows))`` so its
    overflow semantics match the unsplit program's.
    """
    if spec.groupby is None:
        return _concat_tables(pieces)

    pieces = [p for p in pieces if p.num_rows > 0]
    if not pieces:
        raise SplitMergeError("every piece aggregated to zero groups")
    ptab = _concat_tables(pieces)

    gb = spec.groupby
    nk = len(gb.keys)
    gkeys = list(ptab.columns[:nk])
    gparts = list(ptab.columns[nk:])
    G = bucket_size(min(max_groups, n_rows))     # the SOLO slot count

    # exact merge: the same stable-sort segmented core re-groups the
    # concatenated partial rows, each partial merged by its operator —
    # counts merge by summing
    mops = [(c, "sum" if op == "count" else op)
            for (_, op), c in zip(spec.porder, gparts)]
    mouts, mlive, mov = groupby_core(gkeys, mops, None, G)
    live, overflow = torch.stack([mlive.to(torch.int64),
                                  mov.to(torch.int64)]).tolist()
    if overflow:
        raise SplitMergeOverflow()

    def merged(i: int, op: str) -> Column:
        return mouts[nk + spec.pindex[(i, op)]]

    out: List[Column] = list(mouts[:nk])
    for i, op in gb.aggs:
        if op == "count":
            # solo count columns carry no validity (0 for all-null groups)
            out.append(Column(dt.INT64, G, data=merged(i, "count").data))
        elif op == "mean":
            # the solo division: global int64 sum / global int64 count,
            # the identical expression -> identical f64 bits
            s = merged(i, "sum").data
            cnt = merged(i, "count").data
            m = s.to(torch.float64) / cnt.clamp(min=1).to(torch.float64)
            out.append(Column(dt.FLOAT64, G, data=m, validity=cnt > 0))
        else:
            out.append(merged(i, op))
    table = Table(tuple(_slice_rows(c, 0, live) for c in out))

    if not spec.suffix:
        return table
    # post-GroupBy suffix over the merged group state: the eager
    # interpreter IS the oracle the fused suffix lowering is
    # bit-identical to — not a fallback, so no reason is recorded
    from .interpreter import run_eager
    node: PlanNode = Scan(table.num_columns)
    for s in spec.suffix:
        node = dataclasses.replace(s, child=node)
    return run_eager(node, table)
