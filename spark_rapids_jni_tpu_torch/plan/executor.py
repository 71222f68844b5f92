"""Plan execution: one guarded dispatch around one fused program, one
host sync (the JAX package's plan/executor.py).

Host traffic per fused query is exactly one sync: the read of the
program's 2-element ``head`` (live row count, overflow flag). Trimming to
the live rows follows it — a prefix slice when the live rows are a prefix
(after GroupBy/Sort/top-k), else a gather at the mask's True rows
(``mask_indices_core``, which needs no further sync).

Each fused run goes through the memory and fault domains, as in the JAX
package: ``guarded_dispatch("plan_execute", ...)`` (injection point,
fault classification, transient retry, watchdog), inside it a device
reservation of twice the input bytes (taken only when an RmmSpark handler
is installed and the thread works on a task; a taken bracket synchronizes
before it is released), and around it the degradation ladder — retry the
same program -> spill rollback (every SpillStore-registered table leaves
the card) -> split (halved pieces through the ProgramCache, merged
exactly: plan/split.py) -> eager (a named gate: ``oom-split-unmergeable``,
``oom-split-degenerate``) -> typed shed (the OOM propagates as
``TpuRetryOOM``/``TpuSplitAndRetryOOM``). A real CUDA out-of-memory error
inside the program, the head read or the trim classifies as
RESOURCE_EXHAUSTED and enters the same ladder; none escapes it raw.
Ungoverned, the ladder adds no sync and no device work. The counters are
``plan_oom_retries``, ``plan_oom_splits``, ``plan_oom_pieces`` and
``plan_oom_spill_bytes``.

Fallbacks go through ``run_eager`` (plan/interpreter.py), under the same
``plan_execute`` guard, with a declared reason: unsupported input (empty,
not fixed-width, decimal), a planner gate (a DAG plan the strategy
selector cannot fuse), a device re-check that tripped
(``plan_overflows``: group budget, duplicate or non-dense build key,
span) and the two split gates. The ladder's inputs are never donated,
so the eager replay always has them.

DAG plans (Join nodes, several input tables) take the same path: the
planner (plan/planner.py) rewrites and annotates the plan, the
ProgramCache lowers the whole DAG into ONE program, and the same single
head sync applies; their ladder has no split rung (the probe side's row
order spans the build side, so a split demand runs eagerly). The
fallbacks run the eager interpreter on the plan as given, before the
rewrite passes.

String literals compared with DICT32 columns are rewritten to their
dictionary codes before either engine sees the plan
(``resolve_dict_literals``; an absent string becomes -1, which no code
equals), so a fused program holds integer compares only. A DAG join of
two DICT32 keys on different dictionaries gets the right side's code
remap as an extra program input. DAG plans over RLE or FOR inputs run
eagerly (the join lowering reads key lanes as plain data), as in the JAX
package.

Input donation (``donate_input=True``, linear plans over plain columns)
hands the input's column tensors to the program, which drops each after
its last use; the donated run stays outside the ladder, and an overflow
after it raises ``RuntimeError``, as in the JAX package.

Not ported: the sharded and batched programs (A15b, A16).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar import encodings as enc
from ..columnar.column import Column, Table
from ..columnar.table_ops import gather_table, mask_indices_core
from ..faultinj.guard import guarded_dispatch
from ..memory.exceptions import TpuSplitAndRetryOOM
from ..memory.reservation import device_reservation, release_barrier
from ..memory.retry import with_retry
from ..utils import config
from . import expr as ex
from . import planner as _planner
from . import split as _split
from .compile import CompiledPlan, ProgramCache, plan_metrics
from .interpreter import run_eager
from .nodes import (Filter, GroupBy, Join, PlanError, PlanNode, Project,
                    Scan, is_dag, linearize, num_inputs, walk)

_default_cache = ProgramCache()


class _OverflowSignal(Exception):
    """Internal: the fused program's device re-check tripped (group
    budget, join shape) — the output is garbage; recompute eagerly."""


def _eager_fallback(plan: PlanNode, table, reason: str) -> Table:
    """Declared engine fallback -> eager interpreter, under the SAME
    guarded ``plan_execute`` surface as the fused dispatch: the op entry
    points it runs are fault-injector-instrumented, and an unguarded walk
    would leak their injected faults raw instead of classifying them. The
    interpreter is pure over immutable tables, so the guard's re-run is
    safe."""
    return guarded_dispatch(
        "plan_execute",
        lambda: run_eager(plan, table, fallback_reason=reason))


def _pool_cap_check(want_bytes: int) -> None:
    """injectionType 6 "shrink" mode (faultinj/injector.py): a standing
    injected pool cap at the plan_execute surface ONLY — a reservation
    envelope that doesn't fit demands a split, so storms can force the
    ladder's split rung deterministically while the eager fallback (which
    never takes this surface) still completes."""
    from ..faultinj import injector as _inj
    cap = _inj.oom_pool_cap("plan_execute")
    if cap is not None and want_bytes > cap:
        raise TpuSplitAndRetryOOM(
            f"injected shrinking pool: reservation envelope {want_bytes} "
            f"bytes exceeds the {cap}-byte cap")


def _rollback_spill() -> None:
    """The ladder's spill-rollback rung: release every SpillStore-
    registered table, then account the retry (plan_oom_retries) and the
    freed bytes (plan_oom_spill_bytes)."""
    from ..memory import transport
    freed = transport.rollback_all_stores()
    plan_metrics.inc("plan_oom_retries")
    plan_metrics.inc("plan_oom_spill_bytes", freed)


def _oom_budget() -> int:
    return int(config.get("plan.oom_retry_budget"))


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
        # an encoded passthrough column decodes here: a prefix of runs or
        # packed bits is no slice of its buffers
        c = enc.decoded_rows(c)
        v = c.validity[:live] if c.validity is not None else None
        out.append(Column(c.dtype, live, data=c.data[:live], validity=v,
                          children=c.children))
    return Table(tuple(out))


# ---------------------------------------------------------------------------
# dictionary literal resolution
# ---------------------------------------------------------------------------

def _has_str_lit(e: ex.Expr) -> bool:
    if isinstance(e, ex.Lit):
        return isinstance(e.value, str)
    if isinstance(e, ex.BinOp):
        return _has_str_lit(e.left) or _has_str_lit(e.right)
    if isinstance(e, (ex.Not, ex.Cast64)):
        return _has_str_lit(e.operand)
    return False


def _resolve_pair(left: ex.Expr, right: ex.Expr, desc):
    from ..columnar.dictionary import lookup_code

    def code_lit(lit_e, col_e):
        if not (isinstance(col_e, ex.Col) and col_e.index < len(desc)
                and desc[col_e.index] is not None):
            raise TypeError(
                "a string literal in a plan expression can only be "
                "compared (eq/ne) against a dictionary-encoded column")
        return ex.Lit(int(lookup_code(desc[col_e.index], lit_e.value)))

    if isinstance(left, ex.Lit) and isinstance(left.value, str):
        left = code_lit(left, right)
    if isinstance(right, ex.Lit) and isinstance(right.value, str):
        right = code_lit(right, left)
    return left, right


def _resolve_expr(e: ex.Expr, desc) -> ex.Expr:
    if isinstance(e, ex.Lit) and isinstance(e.value, str):
        raise TypeError(
            "string literal outside an eq/ne comparison with a "
            "dictionary-encoded column")
    if isinstance(e, ex.BinOp):
        left, right = e.left, e.right
        if e.op in ("eq", "ne"):
            left, right = _resolve_pair(left, right, desc)
        return ex.BinOp(e.op, _resolve_expr(left, desc),
                        _resolve_expr(right, desc))
    if isinstance(e, ex.Not):
        return ex.Not(_resolve_expr(e.operand, desc))
    if isinstance(e, ex.Cast64):
        return ex.Cast64(_resolve_expr(e.operand, desc))
    return e


def _dict_desc(table: Table) -> List[Optional[Column]]:
    return [c if c.dtype.id is dt.TypeId.DICT32 else None
            for c in table.columns]


def resolve_dict_literals(plan: PlanNode, table: Table) -> PlanNode:
    """The linear plan with every string literal compared to a DICT32
    column rewritten to its dictionary code (-1 when absent: the encoded
    always-false). A plan without string literals comes back as it is
    (the same object, the same fingerprint)."""
    nodes = linearize(plan)
    if not any((isinstance(n, Filter) and _has_str_lit(n.predicate))
               or (isinstance(n, Project)
                   and any(_has_str_lit(e) for e in n.exprs))
               for n in nodes[1:]):
        return plan
    desc = _dict_desc(table)
    new_plan: PlanNode = nodes[0]
    for node in nodes[1:]:
        if isinstance(node, Filter):
            node = Filter(new_plan, _resolve_expr(node.predicate, desc))
        elif isinstance(node, Project):
            exprs = tuple(_resolve_expr(e, desc) for e in node.exprs)
            desc = [desc[e.index] if isinstance(e, ex.Col) else None
                    for e in exprs]
            node = Project(new_plan, exprs)
        else:
            if isinstance(node, GroupBy):
                desc = ([desc[i] for i in node.keys]
                        + [None] * len(node.aggs))
            node = dataclasses.replace(node, child=new_plan)
        new_plan = node
    return new_plan


def resolve_dag_literals(plan: PlanNode, tables: Tuple[Table, ...]
                         ) -> PlanNode:
    """``resolve_dict_literals`` of a DAG plan: the dictionary columns are
    tracked per branch and joined across Join outputs."""
    if not any((isinstance(n, Filter) and _has_str_lit(n.predicate))
               or (isinstance(n, Project)
                   and any(_has_str_lit(e) for e in n.exprs))
               for n in walk(plan)):
        return plan

    def rec(node):
        if isinstance(node, Scan):
            return node, _dict_desc(tables[node.input_index])
        if isinstance(node, Join):
            left, ldesc = rec(node.left)
            right, rdesc = rec(node.right)
            desc = ldesc if node.how in ("semi", "anti") else ldesc + rdesc
            return Join(left, right, node.left_on, node.right_on,
                        node.how), desc
        child, desc = rec(node.child)
        if isinstance(node, Filter):
            return Filter(child, _resolve_expr(node.predicate, desc)), desc
        if isinstance(node, Project):
            exprs = tuple(_resolve_expr(e, desc) for e in node.exprs)
            desc = [desc[e.index] if isinstance(e, ex.Col) else None
                    for e in exprs]
            return Project(child, exprs), desc
        if isinstance(node, GroupBy):
            desc = [desc[i] for i in node.keys] + [None] * len(node.aggs)
            return GroupBy(child, node.keys, node.aggs), desc
        return dataclasses.replace(node, child=child), desc

    return rec(plan)[0]


def resolve_literals(plan: PlanNode, table) -> PlanNode:
    """The plan with its dictionary literals resolved against its input(s),
    as ``execute_plan`` runs it (linear or DAG); the eager engine's
    reference run takes the same plan."""
    tables, dag = _inputs(plan, table)
    return (resolve_dag_literals(plan, tables) if dag
            else resolve_dict_literals(plan, tables[0]))


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
    plan = resolve_literals(plan, table)
    for t in tables:
        if _table_unsupported_reason(t) is not None:
            return None, (), "unsupported-input"
        if dag and any(c.dtype.is_encoded for c in t.columns):
            # the join lowering reads key lanes as plain data; the eager
            # interpreter decodes at its join boundary
            return None, (), "unsupported-input"
    if not dag:
        return (cache.get_or_compile(plan, tables[0]),
                (tuple(tables[0].columns),), None)
    opt = _planner.optimize(plan, tables)
    decisions = _planner.plan_decisions(opt, tables)
    if decisions.eager_reason is not None:
        return None, (), "planner-unsupported"
    aux = []
    for lsrc, rsrc in decisions.dict_joins.values():
        from ..columnar.dictionary import code_remap_table, dict_values
        lcol = tables[lsrc[0]].columns[lsrc[1]]
        rcol = tables[rsrc[0]].columns[rsrc[1]]
        remap = code_remap_table(lcol, rcol)
        if remap is None:  # co-dictionary after all: identity remap
            remap = np.arange(dict_values(rcol).size, dtype=np.int32)
        aux.append(torch.from_numpy(remap).to(tables[0].device))
    prog = cache.get_or_compile_dag(opt, tables, decisions)
    return prog, (tuple(tuple(t.columns) for t in tables),
                  tuple(aux)), None


def _run_fused(prog: CompiledPlan, args: tuple, nbytes: int) -> Table:
    """One governed run of a fused program: reservation (2x the input
    bytes, the envelope of the eager sort/join brackets), the program, the
    head read (THE host sync of the query) and the trim, under the
    ``plan_execute`` guard. Raises ``_OverflowSignal`` when a device
    re-check tripped."""
    def once() -> Table:
        t0 = time.perf_counter()
        _pool_cap_check(2 * nbytes)
        with device_reservation(2 * nbytes) as took:
            cols, mask, head = release_barrier(prog(*args), took)
        live, overflow = head.tolist()
        plan_metrics.add_time("execute_s", time.perf_counter() - t0)
        plan_metrics.inc("plan_executes")
        if overflow:
            raise _OverflowSignal()
        if mask is None:
            return Table(tuple(cols))
        if prog.out_info["prefix"]:
            return _trim_prefix(cols, live)
        return gather_table(Table(tuple(cols)),
                            mask_indices_core(mask, live).to(torch.int64))
    return guarded_dispatch("plan_execute", once)


def _execute_dag(plan: PlanNode, tables: Tuple[Table, ...],
                 cache: ProgramCache) -> Table:
    """A DAG plan's ladder: retry and spill rollback re-dispatch the SAME
    program; a split demand gates to eager (join pieces can't merge
    bit-identically)."""
    prog, args, reason = fused_program(plan, tables, cache)
    if prog is None:
        return _eager_fallback(plan, tables, reason)
    nbytes = sum(t.device_nbytes() for t in tables)
    try:
        return with_retry(lambda _: _run_fused(prog, args, nbytes), None,
                          rollback=_rollback_spill,
                          max_retries=_oom_budget())[0]
    except TpuSplitAndRetryOOM:
        return _eager_fallback(plan, tables, "oom-split-unmergeable")
    except _OverflowSignal:
        # a device re-check failed: the fused output is garbage, so the
        # query is recomputed eagerly from the untouched inputs
        plan_metrics.inc("plan_overflows")
        return _eager_fallback(plan, tables, "overflow")


def _run_donated(prog: CompiledPlan, table: Table) -> Table:
    """The donated run: the program takes the input's columns out of
    ``table`` (which then raises on use) and drops each after its last
    use. It stays outside the retry, rollback and split ladder, which
    would have to re-run it; the guard still classifies, and an OOM
    propagates typed to a caller that owns replayable state."""
    nbytes = table.device_nbytes()
    # the table gives up its columns inside the guarded call, after the
    # guard's injection point, as a donated jax.Array at the program call
    donating = CompiledPlan(fn=lambda: prog(table.donate()),
                            out_info=prog.out_info)
    try:
        return _run_fused(donating, (), nbytes)
    except _OverflowSignal:
        plan_metrics.inc("plan_overflows")
        raise RuntimeError(
            "plan group-budget overflow after input donation: the input "
            "was consumed by the fused program and the eager fallback "
            "cannot run. Raise plan.max_groups or disable donation for "
            "this query.") from None


def execute_plan(plan: PlanNode, table: Union[Table, Sequence[Table]],
                 donate_input: bool = False,
                 cache: Optional[ProgramCache] = None) -> Table:
    """Run ``plan`` over ``table`` as one fused program, or eagerly where
    it cannot be fused (a labeled fallback), through the degradation
    ladder of the module docstring. DAG plans (Join nodes) take a sequence
    of tables indexed by ``Scan.input_index``; they never donate (the
    eager overflow replay needs the inputs). Every op runs on the tables'
    device.

    ``donate_input=True`` hands a linear plan's input columns to the
    fused program (``_run_donated``): only for a caller that is done with
    the table and gives up the ladder's retries. An input holding DICT32,
    RLE or FOR columns does not donate (their children are shared), and
    one that runs eagerly keeps its columns."""
    cache = cache if cache is not None else _default_cache
    tables, dag = _inputs(plan, table)
    plan = resolve_literals(plan, table)
    if dag:
        return _execute_dag(plan, tables, cache)
    table = tables[0]
    if donate_input and any(c.dtype.id is dt.TypeId.DICT32
                            or c.dtype.is_encoded for c in table.columns):
        # encoded children (a dictionary's values and ranks, RLE runs, a
        # FOR header) are shared by reference with other columns
        donate_input = False
    if _table_unsupported_reason(table) is not None:
        return _eager_fallback(plan, table, "unsupported-input")
    prog = cache.get_or_compile(plan, table)
    if donate_input:
        return _run_donated(prog, table)

    # the degradation ladder: retry (same program) -> spill-rollback ->
    # split (halved pieces through the ProgramCache) -> eager (named
    # gate) -> typed shed (the OOM propagates)
    unmergeable = _split.split_unmergeable_reason(plan, table)
    state = {"spec": None}

    def attempt(item):
        tag, t = item
        pr = prog if tag == "whole" else cache.get_or_compile(
            state["spec"].piece_plan, t)
        return _run_fused(pr, (tuple(t.columns),), t.device_nbytes())

    def do_split(item):
        if state["spec"] is None:
            state["spec"] = _split.prepare(plan)
        _tag, t = item
        pieces = _split.split_table(t)
        if len(pieces) >= 2:
            plan_metrics.inc("plan_oom_splits")
        return [("piece", p) for p in pieces]

    try:
        results = with_retry(
            attempt, ("whole", table),
            split=None if unmergeable is not None else do_split,
            rollback=_rollback_spill, max_retries=_oom_budget())
    except TpuSplitAndRetryOOM:
        if unmergeable is None:
            raise  # split depth/retry budget exhausted: typed shed
        # named gate: this plan's pieces can't merge bit-identically
        return _eager_fallback(plan, table, "oom-split-unmergeable")
    except _OverflowSignal:
        # true group count exceeded the static budget: fused output is
        # truncated garbage — recompute eagerly
        plan_metrics.inc("plan_overflows")
        return _eager_fallback(plan, table, "overflow")

    if state["spec"] is None:
        return results[0]
    plan_metrics.inc("plan_oom_pieces", len(results))
    try:
        return _split.merge_pieces(state["spec"], results, table.num_rows,
                                   int(config.get("plan.max_groups")))
    except _split.SplitMergeOverflow:
        plan_metrics.inc("plan_overflows")
        return _eager_fallback(plan, table, "overflow")
    except _split.SplitMergeError:
        return _eager_fallback(plan, table, "oom-split-degenerate")
