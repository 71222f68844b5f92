"""Eager (op-by-op) plan execution — the reference semantics (the JAX
package's plan/interpreter.py).

Runs the plan through the public ops, one node at a time, materializing
every intermediate. It is the fallback of the fused engine (unsupported
input, group-budget overflow, duplicate-key join builds, a planner gate)
and the oracle the fused engine is held against: both evaluate
expressions through ``plan/expr.py``, aggregate through the segment math
of ops/groupby.py and sort through the lanes of ops/sort.py.

* Eager Filter compacts at once (``filter_table``) where the fused path
  carries a mask — the same rows, because every downstream op is stable.
* Eager joins go through the ops/join.py wrappers (xxhash64, kernel B2,
  on the card), which widen an INT32/INT64 key pair to INT64 as the fused
  lowering's int64 key lanes do. Their gather maps are put in (left-row,
  right-row) order by two stable sorts: probe-row order for the unique
  builds the fused path accepts, and a deterministic expansion order for
  duplicate builds (the fused program overflows on those).

Fallback accounting lives here: ``run_eager(..., fallback_reason=...)``
bumps ``plan_fallbacks``, the per-reason map and, for Join-bearing plans,
``plan_join_fallbacks``. Oracle calls pass no reason and bump nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..columnar.column import Column, Table
from ..columnar.table_ops import filter_table, gather_table, slice_table
from ..ops.groupby import groupby_aggregate
from ..ops.join import inner_join, left_anti_join, left_join, left_semi_join
from ..ops.sort import gather, lexsort, sort_table
from . import expr as ex
from .compile import plan_metrics
from .nodes import (Filter, GroupBy, Join, Limit, PlanError, PlanNode,
                    Project, Scan, Sort, walk)

TableOrTables = Union[Table, Sequence[Table]]

# The declared fallback reasons. Every site that falls back to the eager
# interpreter names one of these slugs (the per-reason metrics key on it).
FALLBACK_REASONS = frozenset({
    "unsupported-input",       # executor gate: empty or non-fixed-width
                               # or decimal input
    "planner-unsupported",     # planner strategy gate on a DAG plan
    "overflow",                # a device re-check tripped (group budget,
                               # duplicate or non-dense build key, span)
})


def _as_tables(table: TableOrTables) -> tuple:
    if isinstance(table, Table):
        return (table,)
    return tuple(table)


def _null_padding(c: Column, n: int) -> Column:
    """``n`` all-null rows shaped like ``c``: the LEFT-join payload when
    the build side has 0 rows (nothing to gather from)."""
    return Column(c.dtype, n,
                  data=torch.zeros(n, dtype=c.data.dtype,
                                   device=c.data.device),
                  validity=torch.zeros(n, dtype=torch.bool,
                                       device=c.data.device))


def _join_eager(node: Join, lt: Table, rt: Table) -> Table:
    """One eager join (null keys never match)."""
    lkeys = [lt.columns[i] for i in node.left_on]
    rkeys = [rt.columns[i] for i in node.right_on]
    if node.how == "semi":
        return gather_table(lt, left_semi_join(lkeys, rkeys))
    if node.how == "anti":
        return gather_table(lt, left_anti_join(lkeys, rkeys))
    if node.how == "inner":
        l_idx, r_idx = inner_join(lkeys, rkeys)
    else:
        l_idx, r_idx = left_join(lkeys, rkeys)
    # (left-row, right-row) order; a left join's misses (right index -1,
    # appended at the end) move back into probe-row position
    order = lexsort([r_idx, l_idx], int(l_idx.shape[0]), l_idx.device)
    l_idx, r_idx = l_idx[order], r_idx[order]
    out = list(gather_table(lt, l_idx).columns)
    if node.how == "inner":
        out.extend(gather_table(rt, r_idx).columns)
        return Table(tuple(out))
    # LEFT OUTER: a miss gathers row 0 and nulls it; its data is pinned to
    # zero (the value the fused lowering writes), so results stay
    # bit-identical under the nulls. A 0-row build has nothing to gather.
    found = r_idx >= 0
    n = int(found.shape[0])
    safe = r_idx.clamp(min=0)
    for c in rt.columns:
        if rt.num_rows == 0:
            out.append(_null_padding(c, n))
            continue
        g = gather(c, safe)
        data = torch.where(found, g.data, torch.zeros((), dtype=g.data.dtype,
                                                      device=g.data.device))
        v = found if g.validity is None else (g.validity & found)
        out.append(Column(g.dtype, g.size, data=data, validity=v))
    return Table(tuple(out))


def _run(node: PlanNode, tables: tuple) -> Table:
    if isinstance(node, Scan):
        t = tables[node.input_index]
        if t.num_columns != node.ncols:
            raise PlanError(f"plan expects {node.ncols} columns, "
                            f"got {t.num_columns}")
        return t
    if isinstance(node, Join):
        return _join_eager(node, _run(node.left, tables),
                           _run(node.right, tables))
    table = _run(node.child, tables)
    if isinstance(node, Filter):
        keep = ex.predicate_mask(
            ex.eval_expr(node.predicate, table.columns))
        return filter_table(table, keep)
    if isinstance(node, Project):
        n = table.num_rows
        return Table(tuple(ex.project_column(e, table.columns, n)
                           for e in node.exprs))
    if isinstance(node, GroupBy):
        return groupby_aggregate(table, list(node.keys), list(node.aggs))
    if isinstance(node, Sort):
        return sort_table(table, list(node.keys),
                          node.ascending, node.nulls_first)
    if isinstance(node, Limit):
        return slice_table(table, 0, min(node.count, table.num_rows))
    raise PlanError(f"unknown plan node {type(node).__name__}")


def run_eager(plan: PlanNode, table: TableOrTables,
              fallback_reason: Optional[str] = None) -> Table:
    """Execute ``plan`` eagerly over one table (linear plans) or a
    sequence of tables (DAG plans; ``Scan.input_index`` selects).

    ``fallback_reason`` labels this run as a fallback of the fused engine
    and bumps the plan metrics; oracle callers omit it. A reason outside
    ``FALLBACK_REASONS`` raises."""
    if fallback_reason is not None:
        if fallback_reason not in FALLBACK_REASONS:
            raise PlanError(
                f"undeclared fallback reason {fallback_reason!r} — add it "
                f"to plan/interpreter.FALLBACK_REASONS first")
        plan_metrics.inc("plan_fallbacks")
        plan_metrics.inc_fallback_reason(fallback_reason)
        if any(isinstance(n, Join) for n in walk(plan)):
            plan_metrics.inc("plan_join_fallbacks")
    return _run(plan, _as_tables(table))
