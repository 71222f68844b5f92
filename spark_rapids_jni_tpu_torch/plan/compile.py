"""Lowering: one logical plan -> one fused program of torch ops (the JAX
package's plan/compile.py).

The lowering walks the plan and composes the op layer's plan cores
(plan/expr.py, ops/groupby.py, ops/sort.py, ops/join.py) into one function
of the input columns. Inside it there is no host sync and no
data-dependent shape:

* Filter carries a keep-mask instead of compacting (the state keeps the
  input's lane count);
* GroupBy pads its group axis to a static slot count and reports (live
  groups, overflow) as device scalars;
* Sort appends a dead-row lane so masked rows sink to the tail, making the
  live rows a prefix;
* Limit is a static slice (valid only on prefix-compacted state);
* Join gathers build rows onto probe lanes (never expands them).

The program returns ``(columns, mask, head)`` with ``head = stack([live,
overflow])``; the executor reads ``head`` with the query's ONE host sync
and trims on the host side.

On the TPU the JAX package compiles this function with ``jax.jit``; here
the "program" is the function itself, run as torch ops. ``ProgramCache``
keeps the lowered function per (fingerprint, input shape signature, group
budget, planner decisions), as the JAX package keys its executables, and
the static facts of its output (``out_info``) that the first run
discovers. Capturing the function as a CUDA graph is queued (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table
from ..ops.groupby import (groupby_core, groupby_direct_small_core,
                           groupby_direct_wide_core)
from ..ops.join import (join_build_sorted_core, join_probe_direct_core,
                        join_probe_sorted_core)
from ..ops.sort import gather, lexsort, select_topk_core, sort_lanes
from ..utils import config
from ..utils.shapes import bucket_size
from . import expr as ex
from .nodes import (Filter, GroupBy, Join, Limit, PlanError, PlanNode,
                    Project, Scan, Sort, fingerprint, linearize,
                    output_ncols)
from .planner import _expr_cols


class PlanMetrics:
    """Counters of the plan layer, under the JAX package's names."""

    _COUNTERS = ("plan_compiles", "plan_cache_hits", "plan_cache_misses",
                 "plan_executes", "plan_fallbacks", "plan_join_fallbacks",
                 "plan_overflows")
    _TIMES = ("compile_s", "execute_s")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._c = {k: 0 for k in self._COUNTERS}
            self._t = {k: 0.0 for k in self._TIMES}
            self._reasons: Dict[str, int] = {}

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._c[name] += by

    def inc_fallback_reason(self, reason: str) -> None:
        """Per-reason fallback count (a slug of
        interpreter.FALLBACK_REASONS)."""
        with self._lock:
            self._reasons[reason] = self._reasons.get(reason, 0) + 1

    def add_time(self, name: str, seconds: float) -> None:
        with self._lock:
            self._t[name] += seconds

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self._c)
            out.update({k: round(v, 6) for k, v in self._t.items()})
            out["plan_fallback_reasons"] = dict(self._reasons)
            return out


plan_metrics = PlanMetrics()


@dataclasses.dataclass
class CompiledPlan:
    """A lowered fused program and the static facts of its output, which
    its first run records in ``out_info``: ``has_mask`` (it returns a
    keep-mask), ``prefix`` (the live rows are a prefix), ``n_out`` (its
    static lane count)."""

    fn: Callable
    out_info: Dict[str, Any]

    def __call__(self, *args):
        return self.fn(*args)


def _shape_key(table: Table) -> Tuple:
    """Input signature of the cache key: per column its dtype, size and
    whether it has a validity mask — what changes the program."""
    return tuple((c.dtype.id.value, c.dtype.scale, c.size,
                  c.validity is not None) for c in table.columns)


def _head(live: Optional[torch.Tensor], n: int, overflow: torch.Tensor,
          device: torch.device) -> torch.Tensor:
    live_out = (torch.full((), n, dtype=torch.int32, device=device)
                if live is None else live.to(torch.int32))
    return torch.stack([live_out, overflow.to(torch.int32)])


def _sort_order(keys, node: Sort, mask: Optional[torch.Tensor], n: int,
                device: torch.device) -> torch.Tensor:
    lanes = sort_lanes(keys, node.ascending, node.nulls_first)
    if mask is not None:
        # dead lane LAST == most significant: live rows first
        lanes.append((~mask).to(torch.int64))
    return lexsort(lanes, n, device)


def _unread(dtype: dt.DType, n: int) -> Column:
    """Stand-in of ``n`` rows for a column no later node reads: it keeps
    the schema's positions, and any read of its data fails."""
    return Column(dtype, n)


def _take(c: Column, idx: torch.Tensor) -> Column:
    return (gather(c, idx) if c.data is not None
            else _unread(c.dtype, int(idx.shape[0])))


def _slice_col(c: Column, k: int) -> Column:
    if c.data is None:
        return _unread(c.dtype, k)
    v = c.validity[:k] if c.validity is not None else None
    return Column(c.dtype, k, data=c.data[:k], validity=v)


def _needed_columns(plan: PlanNode, decisions) -> Dict[int, set]:
    """id(node) -> the output columns of that node the DAG program reads.
    The lowering skips the rest: a Join gathers no build payload and a
    Project evaluates no expression that nothing downstream reads (the
    dead code ``jax.jit`` drops from the JAX package's program)."""
    need: Dict[int, set] = {}
    reprobed: Dict[int, set] = {}   # join id -> build columns FD reprobes

    def rec(node, cols: set):
        need[id(node)] = need.get(id(node), set()) | cols
        if isinstance(node, Scan):
            return
        if isinstance(node, Join):
            ln = output_ncols(node.left)
            rcols = set(node.right_on) | reprobed.get(id(node), set())
            lcols = set(node.left_on) | {i for i in cols if i < ln}
            if node.how not in ("semi", "anti"):
                rcols |= {i - ln for i in cols if i >= ln}
            rec(node.left, lcols)
            rec(node.right, rcols)
            return
        if isinstance(node, Filter):
            rec(node.child, cols | _expr_cols(node.predicate))
        elif isinstance(node, Project):
            used = set()
            for i in cols:
                used |= _expr_cols(node.exprs[i])
            rec(node.child, used)
        elif isinstance(node, GroupBy):
            rec(node.child, _groupby_reads(node, decisions.of(node),
                                           reprobed))
        elif isinstance(node, Sort):
            rec(node.child, cols | set(node.keys))
        elif isinstance(node, Limit):
            rec(node.child, cols)

    rec(plan, set(range(output_ncols(plan))))
    return need


def _groupby_reads(node: GroupBy, dec, reprobed: Dict[int, set]) -> set:
    """The child columns a GroupBy's strategy reads; records the build
    columns its FD reprobes read in ``reprobed``."""
    strat = dec.strategy if dec is not None else "generic"
    if strat == "direct_small":
        return {node.keys[0], node.aggs[0][0]}
    if strat == "generic":
        return set(node.keys) | {i for i, _ in node.aggs}
    dropped = {e[0] for e in dec.fd_drop}
    for _, jid, rloc in dec.fd_drop:
        reprobed.setdefault(jid, set()).add(rloc)
    return ({k for p, k in enumerate(node.keys) if p not in dropped}
            | {i for i, op in node.aggs if op != "count"})


def _make_fn(plan: PlanNode, max_groups: int, out_info: Dict[str, Any]):
    """The fused function of a linear plan: ``fn(cols) -> (cols, mask,
    head)``. Each run writes the static facts of its output into
    ``out_info``."""
    nodes = linearize(plan)

    def fn(cols: Tuple[Column, ...]):
        scan = nodes[0]
        if len(cols) != scan.ncols:
            raise PlanError(f"plan expects {scan.ncols} columns, "
                            f"got {len(cols)}")
        cols = list(cols)
        n = cols[0].size
        dev = cols[0].device
        mask: Optional[torch.Tensor] = None
        live = None                     # device i32; None while mask is None
        prefix = True                   # trivially true with no mask
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        for node in nodes[1:]:
            if isinstance(node, Filter):
                keep = ex.predicate_mask(ex.eval_expr(node.predicate, cols))
                mask = keep if mask is None else mask & keep
                live = mask.sum(dtype=torch.int32)
                prefix = False
            elif isinstance(node, Project):
                cols = [ex.project_column(e, cols, n) for e in node.exprs]
            elif isinstance(node, GroupBy):
                G = bucket_size(min(max_groups, n))
                keys = [cols[i] for i in node.keys]
                aggs = [(cols[i], op) for i, op in node.aggs]
                cols, live, ov = groupby_core(keys, aggs, mask, G)
                overflow = overflow | ov
                n = G
                mask = torch.arange(G, dtype=torch.int32, device=dev) < live
                prefix = True
            elif isinstance(node, Sort):
                order = _sort_order([cols[i] for i in node.keys], node, mask,
                                    n, dev)
                cols = [gather(c, order) for c in cols]
                if mask is not None:
                    mask = mask.index_select(0, order)
                prefix = True
            elif isinstance(node, Limit):
                if mask is not None and not prefix:
                    raise PlanError(
                        "Limit needs prefix-compacted rows — place it "
                        "after a Sort or GroupBy, not directly on a "
                        "Filter")
                k = min(node.count, n)
                cols = [_slice_col(c, k) for c in cols]
                if mask is not None:
                    mask = mask[:k]
                    live = live.clamp(max=k)
                n = k
            else:
                raise PlanError(f"unknown plan node {type(node).__name__}")
        out_info["has_mask"] = mask is not None
        out_info["prefix"] = prefix
        out_info["n_out"] = n
        return tuple(cols), mask, _head(live, n, overflow, dev)

    return fn


@dataclasses.dataclass
class _DagState:
    """Per-subtree lowering state: columns, carried keep-mask (None = all
    rows live), static lane count, and whether the live rows are a prefix
    of the lanes."""

    cols: list
    mask: Optional[torch.Tensor]
    n: int
    prefix: bool


def _key_values(col: Column) -> torch.Tensor:
    """int64 join-key lane of an integer column."""
    return col.data.to(torch.int64)


def _gather_probe(rc: Column, r_idx: torch.Tensor, found: torch.Tensor,
                  how: str) -> Column:
    """Build-side payload gathered at the probe lanes. ``r_idx`` is in
    range even for misses; their rows hold garbage that the row mask
    (inner) or the validity bits (left) hide."""
    data = rc.data.index_select(0, r_idx)
    validity = (rc.validity.index_select(0, r_idx)
                if rc.validity is not None else None)
    if how == "left":
        # LEFT OUTER: a miss keeps its probe row and nulls the payload; its
        # data is pinned to zero, the value the eager interpreter writes
        data = torch.where(found, data, torch.zeros((), dtype=data.dtype,
                                                    device=data.device))
        validity = found if validity is None else (validity & found)
    return Column(rc.dtype, int(r_idx.shape[0]), data=data,
                  validity=validity)


def _make_dag_fn(plan: PlanNode, decisions, max_groups: int,
                 out_info: Dict[str, Any]):
    """The fused function of a DAG plan: ``fn(tables) -> (cols, mask,
    head)`` over several input tables, with Join nodes lowered to the
    build/probe cores and GroupBy/Sort+Limit to the planner's strategies.
    Every advisory-stats claim is re-checked on the device and folded into
    the overflow flag.

    ``decisions`` is the planner's PlanDecisions for THIS plan object (its
    map keys on node identity)."""

    need = _needed_columns(plan, decisions)

    def fn(tables: Tuple[Tuple[Column, ...], ...]):
        dev = tables[0][0].device
        overflow = [torch.zeros((), dtype=torch.bool, device=dev)]
        # per-join build context for the FD reprobe of a GroupBy
        join_env: Dict[int, Dict[str, Any]] = {}

        def lower_join(node: Join) -> _DagState:
            ls = rec(node.left)
            rs = rec(node.right)
            dec = decisions.of(node)
            lkey = ls.cols[node.left_on[0]]
            rkey = rs.cols[node.right_on[0]]
            pk = _key_values(lkey)
            bk = _key_values(rkey)
            blive = rs.mask
            if rkey.validity is not None:
                blive = (rkey.validity if blive is None
                         else blive & rkey.validity)
            if dec.strategy == "direct":
                r_idx, found, bad = join_probe_direct_core(
                    bk, blive, dec.lo, pk)
                overflow[0] = overflow[0] | bad
            else:
                order, sk, sl, dup = join_build_sorted_core(bk, blive)
                overflow[0] = overflow[0] | dup
                r_idx, found = join_probe_sorted_core(order, sk, sl, pk)
            if lkey.validity is not None:
                found = found & lkey.validity
            join_env[id(node)] = {"dec": dec, "bk": bk, "rcols": rs.cols}
            if node.how == "semi":
                m = found if ls.mask is None else ls.mask & found
                return _DagState(list(ls.cols), m, ls.n, False)
            if node.how == "anti":
                # NOT EXISTS: null probe keys never match -> kept
                m = ~found if ls.mask is None else ls.mask & ~found
                return _DagState(list(ls.cols), m, ls.n, False)
            out = list(ls.cols)
            for rc in rs.cols:
                out.append(_gather_probe(rc, r_idx, found, node.how)
                           if len(out) in need[id(node)]
                           else _unread(rc.dtype, ls.n))
            if node.how == "inner":
                m = found if ls.mask is None else ls.mask & found
                return _DagState(out, m, ls.n, False)
            return _DagState(out, ls.mask, ls.n, ls.prefix)  # left

        def fd_reprobe(jid: int, slot_keys: torch.Tensor) -> torch.Tensor:
            """Re-probe a direct join's build at the groupby slot keys:
            the gather that restores a key column dropped by FD
            reduction. Inner join, non-null payload: every LIVE slot key
            matched a live in-range build row; dead slots gather an
            in-range garbage row that the live mask hides."""
            env = join_env[jid]
            rn = env["bk"].shape[0]
            return (slot_keys - env["dec"].lo).clamp(0, rn - 1)

        def lower_groupby(node: GroupBy) -> _DagState:
            st = rec(node.child)
            dec = decisions.of(node)
            strat = dec.strategy if dec is not None else "generic"
            if strat == "generic":
                G = bucket_size(min(max_groups, st.n))
                keys = [st.cols[i] for i in node.keys]
                aggs = [(st.cols[i], op) for i, op in node.aggs]
                cols, live, ov = groupby_core(keys, aggs, st.mask, G)
                overflow[0] = overflow[0] | ov
                m = torch.arange(G, dtype=torch.int32, device=dev) < live
                return _DagState(list(cols), m, G, True)
            if strat == "direct_small":
                kcol = st.cols[node.keys[0]]
                vi, _ = node.aggs[0]
                slot_keys, sums, live, bad = groupby_direct_small_core(
                    kcol.data.to(torch.int64),
                    st.cols[vi].data.to(torch.int64), st.mask, dec.lo,
                    dec.span, dec.num_slots, dec.chunk)
                overflow[0] = overflow[0] | bad
                G = dec.num_slots
                cols = [Column(kcol.dtype, G,
                               data=slot_keys.to(kcol.dtype.torch_dtype)),
                        Column(dt.INT64, G, data=sums)]
                m = torch.arange(G, dtype=torch.int32, device=dev) < live
                return _DagState(cols, m, G, True)
            # direct_wide: slots stay in key order, live mask NON-prefix
            dropped = {e[0] for e in dec.fd_drop}
            kept_pos = next(p for p in range(len(node.keys))
                            if p not in dropped)
            kcol = st.cols[node.keys[kept_pos]]
            aggs_in = [(None if op == "count"
                        else st.cols[i].data.to(torch.int64), op)
                       for i, op in node.aggs]
            slot_keys, outs, live_mask, live, bad = \
                groupby_direct_wide_core(
                    kcol.data.to(torch.int64), tuple(aggs_in), st.mask,
                    dec.lo, dec.span, dec.num_slots, dec.live_agg)
            overflow[0] = overflow[0] | bad
            G = dec.num_slots
            nk = len(node.keys)
            cols: list = [None] * (nk + len(node.aggs))
            cols[kept_pos] = Column(
                kcol.dtype, G, data=slot_keys.to(kcol.dtype.torch_dtype))
            for pos, jid, rloc in dec.fd_drop:
                rc = join_env[jid]["rcols"][rloc]
                r_idx = fd_reprobe(jid, slot_keys)
                cols[pos] = Column(rc.dtype, G,
                                   data=rc.data.index_select(0, r_idx))
            for j in range(len(node.aggs)):
                cols[nk + j] = Column(dt.INT64, G, data=outs[j])
            return _DagState(cols, live_mask, G, False)

        def lower_limit(node: Limit) -> _DagState:
            dec = decisions.of(node)
            if dec is not None and dec.strategy == "topk":
                sort_node = node.child
                st = rec(sort_node.child)
                keys = [st.cols[i] for i in sort_node.keys]
                lanes = sort_lanes(keys, sort_node.ascending,
                                   sort_node.nulls_first)
                livem = (st.mask if st.mask is not None
                         else torch.ones(st.n, dtype=torch.bool, device=dev))
                k = min(dec.k, st.n)
                idx = select_topk_core(lanes, livem, k)
                cols = [_take(c, idx) for c in st.cols]
                nlive = livem.sum(dtype=torch.int32).clamp(max=k)
                m = torch.arange(k, dtype=torch.int32, device=dev) < nlive
                return _DagState(cols, m, k, True)
            st = rec(node.child)
            if st.mask is not None and not st.prefix:
                raise PlanError(
                    "Limit needs prefix-compacted rows — place it "
                    "after a Sort or GroupBy, not directly on a "
                    "Filter or Join")
            k = min(node.count, st.n)
            cols = [_slice_col(c, k) for c in st.cols]
            m = st.mask[:k] if st.mask is not None else None
            return _DagState(cols, m, k, st.prefix)

        def rec(node) -> _DagState:
            if isinstance(node, Scan):
                cols = list(tables[node.input_index])
                if len(cols) != node.ncols:
                    raise PlanError(f"plan expects {node.ncols} columns "
                                    f"for input {node.input_index}, got "
                                    f"{len(cols)}")
                return _DagState(cols, None, cols[0].size, True)
            if isinstance(node, Filter):
                st = rec(node.child)
                keep = ex.predicate_mask(
                    ex.eval_expr(node.predicate, st.cols))
                m = keep if st.mask is None else st.mask & keep
                return _DagState(st.cols, m, st.n, False)
            if isinstance(node, Project):
                st = rec(node.child)
                used = need[id(node)]
                # an unread expression is not evaluated (nor typed)
                cols = [ex.project_column(e, st.cols, st.n) if i in used
                        else _unread(dt.INT64, st.n)
                        for i, e in enumerate(node.exprs)]
                return _DagState(cols, st.mask, st.n, st.prefix)
            if isinstance(node, Join):
                return lower_join(node)
            if isinstance(node, GroupBy):
                return lower_groupby(node)
            if isinstance(node, Sort):
                dec = decisions.of(node)
                if dec is not None and dec.strategy == "skip":
                    return rec(node.child)  # folded into Limit topk
                st = rec(node.child)
                order = _sort_order([st.cols[i] for i in node.keys], node,
                                    st.mask, st.n, dev)
                cols = [_take(c, order) for c in st.cols]
                m = (st.mask.index_select(0, order)
                     if st.mask is not None else None)
                return _DagState(cols, m, st.n, True)
            if isinstance(node, Limit):
                return lower_limit(node)
            raise PlanError(f"unknown plan node {type(node).__name__}")

        st = rec(plan)
        out_info["has_mask"] = st.mask is not None
        out_info["prefix"] = st.prefix
        out_info["n_out"] = st.n
        live = (None if st.mask is None
                else st.mask.sum(dtype=torch.int32))
        return tuple(st.cols), st.mask, _head(live, st.n, overflow[0], dev)

    return fn


class ProgramCache:
    """Lower-once-per-(plan, shape, decisions) cache of fused programs.
    Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._programs: Dict[Tuple, CompiledPlan] = {}

    def _get(self, key: Tuple, make: Callable) -> CompiledPlan:
        with self._lock:
            prog = self._programs.get(key)
        if prog is not None:
            plan_metrics.inc("plan_cache_hits")
            return prog
        plan_metrics.inc("plan_cache_misses")
        t0 = time.perf_counter()
        out_info: Dict[str, Any] = {}
        prog = CompiledPlan(fn=make(out_info), out_info=out_info)
        plan_metrics.add_time("compile_s", time.perf_counter() - t0)
        plan_metrics.inc("plan_compiles")
        with self._lock:
            # lost race: keep the first program, drop ours
            return self._programs.setdefault(key, prog)

    def get_or_compile(self, plan: PlanNode, table: Table) -> CompiledPlan:
        """The program of a linear plan over ``table``'s signature."""
        max_groups = int(config.get("plan.max_groups"))
        key = (fingerprint(plan), _shape_key(table), max_groups)
        return self._get(key, lambda info: _make_fn(plan, max_groups, info))

    def get_or_compile_dag(self, plan: PlanNode, tables: Tuple[Table, ...],
                           decisions) -> CompiledPlan:
        """The program of a DAG plan. The key extends the linear key with
        every input's signature and the planner's ``cache_suffix`` (a
        stats-driven strategy change lowers a distinct program); the "dag"
        sentinel keeps it apart from linear entries."""
        max_groups = int(config.get("plan.max_groups"))
        key = (fingerprint(plan), tuple(_shape_key(t) for t in tables),
               "dag", max_groups, decisions.cache_suffix)
        return self._get(key, lambda info: _make_dag_fn(
            plan, decisions, max_groups, info))

    def __len__(self) -> int:
        with self._lock:
            return len(self._programs)
