"""Plan execution: one fused program, one host sync (the JAX package's
plan/executor.py without its memory and fault-domain layers).

Host traffic per fused query is exactly one sync: the read of the
program's 2-element ``head`` (live row count, overflow flag). Trimming to
the live rows follows it — a prefix slice when the live rows are a prefix
(after GroupBy/Sort/top-k), else a gather at the mask's True rows
(``mask_indices_core``, which needs no further sync).

Fallbacks go through ``run_eager`` (plan/interpreter.py) with a declared
reason: unsupported input (empty, not fixed-width, decimal), a planner
gate (a DAG plan the strategy selector cannot fuse), and a device re-check
that tripped (``plan_overflows``: group budget, duplicate or non-dense
build key, span). Inputs are never donated, so the eager replay always has
them.

DAG plans (Join nodes, several input tables) take the same path: the
planner (plan/planner.py) rewrites and annotates the plan, the
ProgramCache lowers the whole DAG into ONE program, and the same single
head sync applies. The fallbacks run the eager interpreter on the plan as
given, before the rewrite passes.

Not ported: input donation (ROADMAP A7); the OOM ladder — retry, spill
rollback, split and the reservation brackets (A11; a CUDA OOM propagates
as ``torch.cuda.OutOfMemoryError``); dictionary-literal resolution (A10);
the sharded and batched programs (A15, A16).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple, Union

import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table
from ..columnar.table_ops import gather_table, mask_indices_core
from . import planner as _planner
from .compile import CompiledPlan, ProgramCache, plan_metrics
from .interpreter import run_eager
from .nodes import PlanError, PlanNode, is_dag, num_inputs

_default_cache = ProgramCache()


def _table_unsupported_reason(table: Table) -> Optional[str]:
    """Why one input table can't feed a fused program — None when it
    can. Anything not provably supported falls back to the eager path."""
    if table.num_rows == 0:
        return "empty input"
    for i, c in enumerate(table.columns):
        if not c.dtype.is_fixed_width:
            return f"column {i} is {c.dtype.id.value} (not fixed-width)"
        if c.dtype.is_decimal:
            return f"column {i} is decimal (eager-only aggregation path)"
    return None


def unsupported_reason(plan: PlanNode, table: Table) -> Optional[str]:
    """Why this (plan, table) can't run fused — None when it can."""
    return _table_unsupported_reason(table)


def _trim_prefix(cols, live: int) -> Table:
    out = []
    for c in cols:
        v = c.validity[:live] if c.validity is not None else None
        out.append(Column(c.dtype, live, data=c.data[:live], validity=v))
    return Table(tuple(out))


def _inputs(plan: PlanNode, table) -> Tuple[Tuple[Table, ...], bool]:
    """(input tables, whether the DAG lowering runs them): DAG plans and
    table sequences take it, a linear plan over one Table the linear
    one."""
    if is_dag(plan) or not isinstance(table, Table):
        tables = (table,) if isinstance(table, Table) else tuple(table)
        k = num_inputs(plan)
        if len(tables) < k:
            raise PlanError(f"plan reads {k} inputs, got {len(tables)}")
        return tables[:k], True
    return (table,), False


def fused_program(plan: PlanNode, table: Union[Table, Sequence[Table]],
                  cache: Optional[ProgramCache] = None
                  ) -> Tuple[Optional[CompiledPlan], tuple, Optional[str]]:
    """The fused program ``execute_plan`` runs for ``plan`` over
    ``table``: ``(program, its arguments, None)``, or ``(None, (),
    reason)`` with the fallback reason where the query runs eagerly.
    ``program(*arguments)`` returns ``(cols, mask, head)`` without a host
    sync."""
    cache = cache if cache is not None else _default_cache
    tables, dag = _inputs(plan, table)
    for t in tables:
        if _table_unsupported_reason(t) is not None:
            return None, (), "unsupported-input"
    if not dag:
        return (cache.get_or_compile(plan, tables[0]),
                (tuple(tables[0].columns),), None)
    opt = _planner.optimize(plan, tables)
    decisions = _planner.plan_decisions(opt, tables)
    if decisions.eager_reason is not None:
        return None, (), "planner-unsupported"
    prog = cache.get_or_compile_dag(opt, tables, decisions)
    return prog, (tuple(tuple(t.columns) for t in tables),), None


def execute_plan(plan: PlanNode, table: Union[Table, Sequence[Table]],
                 donate_input: bool = False,
                 cache: Optional[ProgramCache] = None) -> Table:
    """Run ``plan`` over ``table`` as one fused program, or eagerly where
    it cannot be fused (a labeled fallback). DAG plans (Join nodes) take a
    sequence of tables indexed by ``Scan.input_index``. Every op runs on
    the tables' device."""
    if donate_input:
        raise dt.not_ported("input donation", "A7, fused executor")
    tables, dag = _inputs(plan, table)
    eager_in = tables if dag else tables[0]
    prog, args, reason = fused_program(plan, table, cache)
    if prog is None:
        return run_eager(plan, eager_in, fallback_reason=reason)
    t0 = time.perf_counter()
    cols, mask, head = prog(*args)
    live, overflow = head.tolist()      # THE host sync of the query
    plan_metrics.add_time("execute_s", time.perf_counter() - t0)
    plan_metrics.inc("plan_executes")
    if overflow:
        # a device re-check failed: the fused output is garbage, so the
        # query is recomputed eagerly from the untouched inputs
        plan_metrics.inc("plan_overflows")
        return run_eager(plan, eager_in, fallback_reason="overflow")
    if mask is None:
        return Table(tuple(cols))
    if prog.out_info["prefix"]:
        return _trim_prefix(cols, live)
    return gather_table(Table(tuple(cols)),
                        mask_indices_core(mask, live).to(torch.int64))
