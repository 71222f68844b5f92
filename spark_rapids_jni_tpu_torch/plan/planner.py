"""Cost-shaped planner for DAG plans (the JAX package's plan/planner.py;
host-only, deterministic).

Three passes run before every DAG execution:

  1. ``push_filters``: predicate pushdown through joins — probe-side
     conjuncts sink below any join; build-side conjuncts sink into the
     build pipeline for inner joins (the only how where pre-filtering the
     build is equivalent). ``source_predicates`` then lists the
     Scan-adjacent predicates per input.
  2. ``order_joins``: directly-nested inner joins probing the same
     pipeline swap so the smallest estimated build side probes first,
     with column references above the swap remapped.
  3. ``plan_decisions``: strategy selection from advisory ColumnStats
     (columnar/column.py). Every claim a strategy leans on is re-checked
     ON DEVICE by the core it picks and folded into the plan's overflow
     flag — stats shape the program, device checks guarantee the answer.

Strategies:
  Join    ``direct``  build key proven ascending-dense: the build payload
                      array IS the hash table (probe = subtract + gather).
          ``sorted``  anything else: sorted build + searchsorted probe;
                      duplicate LIVE keys -> overflow (fused joins never
                      expand rows).
  GroupBy ``direct_small``  single int key, span <= plan.groupby_small_span,
                      one integer sum with per-row values proven in
                      (0, 2^48).
          ``direct_wide``   single int key (possibly after FD reduction),
                      span <= plan.groupby_wide_span, int sum/count aggs:
                      one scatter-add per agg, no sort.
          ``generic``       everything else: ops/groupby.groupby_core.
  Limit   ``topk``    Sort+Limit(k <= plan.topk_max) fuses into k
                      min-selection rounds; the Sort node is skipped.

FD reduction: a GroupBy key that is the build payload of a *direct*
unique-build join, probed by another GroupBy key, is functionally
determined by that key — it drops out of the grouping and is re-probed per
output slot. (TPC-H q3 groups by (l_orderkey, o_orderdate,
o_shippriority); the latter two are payload of the orders join keyed by
l_orderkey, so the groupby collapses to one dense int key.)

A join of two DICT32 keys is a sorted join over codes: when the two
dictionaries differ, the planner traces each key back to its input column
(``dict_joins``) so the executor can hand the program the right side's
code remap; a key that mixes a dictionary and a plain column, or whose
dictionary column is derived, runs eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..columnar import dtype as dt
from ..columnar.column import ColumnStats, Table
from ..columnar.dictionary import same_dictionary
from ..utils import config
from ..utils.shapes import bucket_size
from . import expr as ex
from .nodes import (Filter, GroupBy, Join, Limit, PlanError, Project, Scan,
                    Sort, canonical_repr, output_ncols)

_PACK_LIMIT = 1 << 48  # value bits in the small-groupby packed word

_INT_IDS = (dt.TypeId.INT8, dt.TypeId.INT16, dt.TypeId.INT32,
            dt.TypeId.INT64, dt.TypeId.UINT8, dt.TypeId.UINT16,
            dt.TypeId.UINT32)

# coarse selectivity guesses for cardinality ESTIMATES only (join
# ordering); nothing correctness-bearing reads these
_FILTER_SEL = 0.4
_JOIN_SEL = {"inner": 0.7, "left": 1.0, "semi": 0.7, "anti": 0.3}


# ---------------------------------------------------------------------------
# decisions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JoinDecision:
    strategy: str                 # "direct" | "sorted"
    lo: int = 0                   # direct: first build key value
    dict_remap: bool = False      # sorted: a code remap input is present

    def key(self):
        return ("J", self.strategy, self.lo, self.dict_remap)


@dataclasses.dataclass(frozen=True)
class GroupByDecision:
    strategy: str                 # "generic" | "direct_small" | "direct_wide"
    lo: int = 0
    span: int = 0
    num_slots: int = 0
    chunk: int = 0                # direct_small rows per block
    live_agg: Optional[int] = None  # direct_wide: sum agg proving liveness
    # (key position, join node id, right-local column) triples dropped by
    # FD reduction; the id resolves against this plan object's nodes at
    # lower time, the local column names the build payload to reprobe
    fd_drop: Tuple[Tuple[int, int, int], ...] = ()

    def key(self):
        return ("G", self.strategy, self.lo, self.span, self.num_slots,
                self.chunk, self.live_agg,
                tuple((e[0], e[2]) for e in self.fd_drop))


@dataclasses.dataclass(frozen=True)
class SortDecision:
    strategy: str                 # "generic" | "skip" (folded into topk)

    def key(self):
        return ("S", self.strategy)


@dataclasses.dataclass(frozen=True)
class LimitDecision:
    strategy: str                 # "slice" | "topk"
    k: int = 0

    def key(self):
        return ("L", self.strategy, self.k)


@dataclasses.dataclass
class PlanDecisions:
    """Planner output the DAG lowering consumes. ``by_node`` keys on
    id(node) of THIS plan object; ``cache_suffix`` is the canonical tuple
    appended to the ProgramCache key so strategy changes (stats-driven)
    never collide with earlier programs."""

    by_node: Dict[int, object]
    cache_suffix: Tuple
    # per cross-dictionary join: the (input, column) of both key columns
    dict_joins: Dict[int, Tuple[Tuple[int, int], Tuple[int, int]]] = \
        dataclasses.field(default_factory=dict)
    eager_reason: Optional[str] = None

    def of(self, node):
        return self.by_node.get(id(node))


# ---------------------------------------------------------------------------
# expression helpers
# ---------------------------------------------------------------------------

def _expr_cols(e: ex.Expr, out: Optional[set] = None) -> set:
    """Set of child-column indices an expression references."""
    if out is None:
        out = set()
    if isinstance(e, ex.Col):
        out.add(e.index)
    elif isinstance(e, (ex.Cast64, ex.Not)):
        _expr_cols(e.operand, out)
    elif isinstance(e, ex.BinOp):
        _expr_cols(e.left, out)
        _expr_cols(e.right, out)
    return out


def _remap_expr(e: ex.Expr, cmap) -> ex.Expr:
    """Rebuild an expression with Col indices passed through ``cmap``."""
    if isinstance(e, ex.Col):
        return ex.Col(cmap[e.index])
    if isinstance(e, ex.Cast64):
        return ex.Cast64(_remap_expr(e.operand, cmap))
    if isinstance(e, ex.Not):
        return ex.Not(_remap_expr(e.operand, cmap))
    if isinstance(e, ex.BinOp):
        return ex.BinOp(e.op, _remap_expr(e.left, cmap),
                        _remap_expr(e.right, cmap))
    return e  # Lit


# ---------------------------------------------------------------------------
# pass 1: predicate pushdown
# ---------------------------------------------------------------------------

def push_filters(plan):
    """Sink Filter predicates through Joins (left side for every how,
    right side for inner). AND-conjuncts split so mixed predicates sink
    partially. Runs to fixpoint in one recursive sweep — a pushed filter
    is re-visited at its new position."""

    def conjuncts(pred):
        if isinstance(pred, ex.BinOp) and pred.op == "and":
            return conjuncts(pred.left) + conjuncts(pred.right)
        return [pred]

    def conjoin(preds):
        out = preds[0]
        for p in preds[1:]:
            out = ex.BinOp("and", out, p)
        return out

    def rec(node):
        if isinstance(node, Scan):
            return node
        if isinstance(node, Join):
            return Join(rec(node.left), rec(node.right),
                        node.left_on, node.right_on, node.how)
        if isinstance(node, Filter) and isinstance(node.child, Join):
            j = node.child
            nl = output_ncols(j.left)
            sink_l, sink_r, keep = [], [], []
            for c in conjuncts(node.predicate):
                refs = _expr_cols(c)
                if refs and all(i < nl for i in refs):
                    sink_l.append(c)
                elif (j.how == "inner" and refs
                      and all(i >= nl for i in refs)):
                    sink_r.append(_remap_expr(
                        c, {i: i - nl for i in refs}))
                else:
                    keep.append(c)
            left = Filter(j.left, conjoin(sink_l)) if sink_l else j.left
            right = Filter(j.right, conjoin(sink_r)) if sink_r else j.right
            out = Join(rec(left), rec(right),
                       j.left_on, j.right_on, j.how)
            return Filter(out, conjoin(keep)) if keep else out
        if isinstance(node, Filter):
            return Filter(rec(node.child), node.predicate)
        if isinstance(node, Project):
            return Project(rec(node.child), node.exprs)
        if isinstance(node, GroupBy):
            return GroupBy(rec(node.child), node.keys, node.aggs)
        if isinstance(node, Sort):
            return Sort(rec(node.child), node.keys, node.ascending,
                        node.nulls_first)
        if isinstance(node, Limit):
            return Limit(rec(node.child), node.count)
        raise PlanError(f"unknown plan node {type(node).__name__}")

    return rec(plan)


def source_predicates(plan) -> Dict[int, Tuple[ex.Expr, ...]]:
    """Per-input Scan-adjacent predicates after pushdown: input_index ->
    predicates of the Filter chain sitting directly on that Scan,
    innermost first: what a scan below the plan could prune with."""
    out: Dict[int, List[ex.Expr]] = {}

    def rec(node):
        if isinstance(node, Scan):
            return node.input_index
        if isinstance(node, Filter):
            idx = rec(node.child)
            if idx is not None:
                out.setdefault(idx, []).append(node.predicate)
            return idx
        if isinstance(node, Join):
            rec(node.left)
            rec(node.right)
            return None
        rec(node.child)
        return None

    rec(plan)
    return {k: tuple(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# pass 2: join ordering
# ---------------------------------------------------------------------------

def estimate_rows(node, tables: Tuple[Table, ...]) -> float:
    """Coarse live-row estimate (join ordering only)."""
    if isinstance(node, Scan):
        return float(tables[node.input_index].num_rows)
    if isinstance(node, Filter):
        return _FILTER_SEL * estimate_rows(node.child, tables)
    if isinstance(node, Join):
        return (_JOIN_SEL[node.how]
                * estimate_rows(node.left, tables))
    if isinstance(node, GroupBy):
        return max(1.0, estimate_rows(node.child, tables) * 0.1)
    if isinstance(node, Limit):
        return float(min(node.count, estimate_rows(node.child, tables)))
    return estimate_rows(node.child, tables)


def order_joins(plan, tables: Tuple[Table, ...]):
    """Swap directly-nested inner joins so the smaller estimated build
    probes first: Join(Join(X, B1), B2) -> Join(Join(X, B2), B1) when
    B2's keys reference only X's columns and est(B2) < est(B1). Column
    references above a swap are remapped (payload blocks change places);
    a Project/GroupBy rebases the schema and stops the remap. Repeats to
    fixpoint for longer chains."""

    def rec(node):
        # returns (new_node, colmap) — colmap maps old output column
        # index -> new output column index, or None when unchanged/rebased
        if isinstance(node, Scan):
            return node, None
        if isinstance(node, Join):
            nl, lmap = rec(node.left)
            nr, rmap = rec(node.right)
            lon = tuple(lmap[i] if lmap else i for i in node.left_on)
            ron = tuple(rmap[i] if rmap else i for i in node.right_on)
            node2 = Join(nl, nr, lon, ron, node.how)
            ln = output_ncols(nl)
            if node.how in ("semi", "anti"):
                cmap = lmap
            elif lmap is None and rmap is None:
                cmap = None
            else:
                cmap = ([lmap[i] if lmap else i for i in range(ln)]
                        + [ln + (rmap[j] if rmap else j)
                           for j in range(output_ncols(nr))])
            while (isinstance(node2.left, Join)
                   and node2.how == "inner"
                   and node2.left.how == "inner"):
                j1 = node2.left
                nx = output_ncols(j1.left)
                if not all(i < nx for i in node2.left_on):
                    break
                if not (estimate_rows(node2.right, tables)
                        < estimate_rows(j1.right, tables)):
                    break
                nb1 = output_ncols(j1.right)
                nb2 = output_ncols(node2.right)
                inner = Join(j1.left, node2.right,
                             node2.left_on, node2.right_on, "inner")
                node2 = Join(inner, j1.right,
                             j1.left_on, j1.right_on, "inner")
                # old layout [X, B1, B2] -> new [X, B2, B1]
                swap = (list(range(nx))
                        + [nx + nb2 + j for j in range(nb1)]
                        + [nx + j for j in range(nb2)])
                cmap = (swap if cmap is None
                        else [swap[c] for c in cmap])
            return node2, cmap
        child2, cmap = rec(node.child)
        if isinstance(node, Filter):
            pred = (node.predicate if cmap is None
                    else _remap_expr(node.predicate, cmap))
            return Filter(child2, pred), cmap
        if isinstance(node, Project):
            exprs = (node.exprs if cmap is None else
                     tuple(_remap_expr(e, cmap) for e in node.exprs))
            return Project(child2, exprs), None  # rebases the schema
        if isinstance(node, GroupBy):
            keys = (node.keys if cmap is None
                    else tuple(cmap[i] for i in node.keys))
            aggs = (node.aggs if cmap is None
                    else tuple((cmap[i], op) for i, op in node.aggs))
            return GroupBy(child2, keys, aggs), None
        if isinstance(node, Sort):
            keys = (node.keys if cmap is None
                    else tuple(cmap[i] for i in node.keys))
            return Sort(child2, keys, node.ascending,
                        node.nulls_first), cmap
        if isinstance(node, Limit):
            return Limit(child2, node.count), cmap
        raise PlanError(f"unknown plan node {type(node).__name__}")

    for _ in range(4):  # bubble longer chains to fixpoint
        new_plan, _ = rec(plan)
        if canonical_repr(new_plan) == canonical_repr(plan):
            return new_plan
        plan = new_plan
    return plan


def optimize(plan, tables: Tuple[Table, ...]):
    """push_filters + order_joins — the rewriting passes, applied before
    plan_decisions. Deterministic in (plan structure, table shapes)."""
    return order_joins(push_filters(plan), tables)


# ---------------------------------------------------------------------------
# pass 3: strategy decisions (stats propagation)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ColInfo:
    tid: object                       # TypeId
    stats: Optional[ColumnStats]
    maybe_null: bool
    vid: int                          # value-identity token (FD tracking)
    # (join node id, right-local col, probe-key vid) when this column is
    # the payload of a direct unique-build join — the FD witness
    fd: Optional[Tuple[int, int, int]] = None


class _Planner:
    def __init__(self, plan, tables: Tuple[Table, ...]):
        self.plan = plan
        self.tables = tables
        self.by_node: Dict[int, object] = {}
        self.dict_joins: Dict[int, Tuple[Tuple[int, int],
                                         Tuple[int, int]]] = {}
        self.suffix: List[Tuple] = []
        self.eager_reason: Optional[str] = None
        self._vid = 0
        self.small_span = int(config.get("plan.groupby_small_span"))
        self.wide_span = int(config.get("plan.groupby_wide_span"))
        self.chunk = max(1, int(config.get("plan.groupby_chunk")))
        self.topk_max = int(config.get("plan.topk_max"))

    def fresh(self) -> int:
        self._vid += 1
        return self._vid

    def fail(self, reason: str):
        if self.eager_reason is None:
            self.eager_reason = reason

    def _origin(self, node, idx) -> Optional[Tuple[int, int]]:
        """(input_index, column) feeding column ``idx`` of ``node``'s
        output through bare passthroughs, or None when derived."""
        if isinstance(node, Scan):
            return (node.input_index, idx)
        if isinstance(node, (Filter, Sort, Limit)):
            return self._origin(node.child, idx)
        if isinstance(node, Project):
            e = node.exprs[idx]
            if isinstance(e, ex.Col):
                return self._origin(node.child, e.index)
            return None
        if isinstance(node, Join):
            ln = output_ncols(node.left)
            if node.how in ("semi", "anti") or idx < ln:
                return self._origin(node.left, idx)
            return self._origin(node.right, idx - ln)
        return None  # a GroupBy rebases rows

    # -- per-node inference -------------------------------------------------
    def infer(self, node) -> Tuple[List[_ColInfo], int]:
        """(column infos, static fused lane count) for a node's output."""
        if isinstance(node, Scan):
            t = self.tables[node.input_index]
            cols = []
            for c in t.columns:
                cols.append(_ColInfo(c.dtype.id, c.stats(),
                                     c.validity is not None, self.fresh()))
            return cols, t.num_rows
        if isinstance(node, Filter):
            return self.infer(node.child)  # mask only — lanes unchanged
        if isinstance(node, Project):
            cols, lanes = self.infer(node.child)
            return [self._expr_info(e, cols) for e in node.exprs], lanes
        if isinstance(node, Sort):
            cols, lanes = self.infer(node.child)
            out = []
            for c in cols:
                st = c.stats
                if st is not None and st.ascending_dense:
                    st = dataclasses.replace(st, ascending_dense=False)
                out.append(dataclasses.replace(c, stats=st))
            return out, lanes
        if isinstance(node, Limit):
            cols, lanes = self.infer(node.child)
            dec = self.by_node.get(id(node))
            if isinstance(dec, LimitDecision) and dec.strategy == "topk":
                return cols, dec.k
            return cols, min(node.count, lanes)
        if isinstance(node, Join):
            return self._infer_join(node)
        if isinstance(node, GroupBy):
            return self._infer_groupby(node)
        raise PlanError(f"unknown plan node {type(node).__name__}")

    def _expr_info(self, e, cols) -> _ColInfo:
        if isinstance(e, ex.Col):
            return cols[e.index]
        if isinstance(e, ex.Cast64):
            inner = self._expr_info(e.operand, cols)
            return dataclasses.replace(inner, tid=dt.TypeId.INT64)
        if isinstance(e, ex.Lit) and isinstance(e.value, int) \
                and not isinstance(e.value, bool):
            v = int(e.value)
            return _ColInfo(dt.TypeId.INT64,
                            ColumnStats(lo=v, hi=v), False, self.fresh())
        if isinstance(e, ex.BinOp) and e.op in ("add", "sub", "mul"):
            l = self._expr_info(e.left, cols)
            r = self._expr_info(e.right, cols)
            stats = None
            if (l.stats is not None and r.stats is not None
                    and l.stats.lo is not None and r.stats.lo is not None):
                a, b = (l.stats.lo, l.stats.hi), (r.stats.lo, r.stats.hi)
                if e.op == "add":
                    bounds = (a[0] + b[0], a[1] + b[1])
                elif e.op == "sub":
                    bounds = (a[0] - b[1], a[1] - b[0])
                else:
                    prods = [x * y for x in a for y in b]
                    bounds = (min(prods), max(prods))
                stats = ColumnStats(lo=bounds[0], hi=bounds[1])
            return _ColInfo(dt.TypeId.INT64, stats,
                            l.maybe_null or r.maybe_null, self.fresh())
        # comparisons / bool ops / string lits: no useful numeric info
        return _ColInfo(dt.TypeId.BOOL8, None, True, self.fresh())

    def _infer_join(self, node: Join) -> Tuple[List[_ColInfo], int]:
        lcols, llanes = self.infer(node.left)
        rcols, _ = self.infer(node.right)
        dec = self._decide_join(node, lcols, rcols)
        self.by_node[id(node)] = dec
        self.suffix.append(dec.key())
        if node.how in ("semi", "anti"):
            return list(lcols), llanes
        out = list(lcols)
        pkey_vid = lcols[node.left_on[0]].vid
        for j, rc in enumerate(rcols):
            st = rc.stats
            if st is not None:
                # a gather preserves value bounds, not order/uniqueness
                st = ColumnStats(lo=st.lo, hi=st.hi)
            maybe_null = rc.maybe_null or node.how == "left"
            fd = None
            if (dec.strategy == "direct" and node.how == "inner"
                    and not maybe_null):
                fd = (id(node), j, pkey_vid)
            out.append(_ColInfo(rc.tid, st, maybe_null, self.fresh(), fd))
        return out, llanes

    def _decide_join(self, node: Join, lcols, rcols) -> JoinDecision:
        if len(node.left_on) != 1:
            self.fail("multi-column join key")
            return JoinDecision("sorted")
        lk = lcols[node.left_on[0]]
        rk = rcols[node.right_on[0]]
        if lk.tid is dt.TypeId.DICT32 or rk.tid is dt.TypeId.DICT32:
            if not (lk.tid is dt.TypeId.DICT32
                    and rk.tid is dt.TypeId.DICT32):
                self.fail("join key mixes dictionary and plain columns")
                return JoinDecision("sorted")
            lo_src = self._origin(node.left, node.left_on[0])
            ro_src = self._origin(node.right, node.right_on[0])
            if lo_src is None or ro_src is None:
                self.fail("dictionary join key with derived origin")
                return JoinDecision("sorted")
            lcol = self.tables[lo_src[0]].columns[lo_src[1]]
            rcol = self.tables[ro_src[0]].columns[ro_src[1]]
            remap = not same_dictionary(lcol, rcol)
            if remap:
                self.dict_joins[id(node)] = (lo_src, ro_src)
            return JoinDecision("sorted", dict_remap=remap)
        if not (lk.tid in _INT_IDS or lk.tid is dt.TypeId.INT64) or \
                not (rk.tid in _INT_IDS or rk.tid is dt.TypeId.INT64):
            self.fail(f"non-integer join key ({lk.tid.value})")
            return JoinDecision("sorted")
        st = rk.stats
        if st is not None and st.ascending_dense and st.lo is not None:
            return JoinDecision("direct", lo=st.lo)
        return JoinDecision("sorted")

    def _infer_groupby(self, node: GroupBy) -> Tuple[List[_ColInfo], int]:
        cols, lanes = self.infer(node.child)
        dec = self._decide_groupby(node, cols, lanes)
        self.by_node[id(node)] = dec
        self.suffix.append(dec.key())
        out = []
        for i in node.keys:
            c = cols[i]
            st = c.stats
            if st is not None:
                st = ColumnStats(lo=st.lo, hi=st.hi, unique=len(
                    node.keys) == 1)
            out.append(_ColInfo(c.tid, st, c.maybe_null, self.fresh()))
        for i, op in node.aggs:
            tid = dt.TypeId.INT64 if op in ("sum", "count") else cols[i].tid
            out.append(_ColInfo(tid, None, True, self.fresh()))
        if dec.strategy == "generic":
            g = bucket_size(min(int(config.get("plan.max_groups")),
                                max(lanes, 1)))
        else:
            g = dec.num_slots
        return out, g

    def _decide_groupby(self, node: GroupBy, cols,
                        lanes: int) -> GroupByDecision:
        # FD reduction: keys that are direct-join payload probed by a
        # sibling key collapse onto that key
        keys = list(node.keys)
        fd_drop: List[Tuple[int, int, int]] = []
        key_vids = {cols[i].vid for i in keys}
        kept = []
        for pos, i in enumerate(keys):
            fd = cols[i].fd
            if (fd is not None and fd[2] in key_vids
                    and fd[2] != cols[i].vid):
                fd_drop.append((pos, fd[0], fd[1]))
            else:
                kept.append(i)
        if len(kept) != 1:
            return GroupByDecision("generic")
        key = cols[kept[0]]
        st = key.stats
        if (key.tid not in _INT_IDS and key.tid is not dt.TypeId.INT64) \
                or key.maybe_null or st is None or st.lo is None:
            return GroupByDecision("generic")
        span = st.hi - st.lo + 1
        vals = []
        for i, op in node.aggs:
            v = cols[i]
            if op not in ("sum", "count"):
                return GroupByDecision("generic")
            if op == "sum":
                if v.maybe_null or (v.tid not in _INT_IDS
                                    and v.tid is not dt.TypeId.INT64):
                    return GroupByDecision("generic")
            vals.append((v, op))
        fd_tuple = tuple(fd_drop)
        if (span <= self.small_span and len(vals) == 1
                and vals[0][1] == "sum" and not fd_tuple):
            vst = vals[0][0].stats
            if (vst is not None and vst.lo is not None and vst.lo >= 1
                    and vst.hi < _PACK_LIMIT):
                return GroupByDecision(
                    "direct_small", lo=st.lo, span=span,
                    num_slots=bucket_size(span + 1), chunk=self.chunk)
        if span <= self.wide_span:
            live_agg = None
            for j, (v, op) in enumerate(vals):
                if (op == "sum" and v.stats is not None
                        and v.stats.lo is not None and v.stats.lo >= 1):
                    live_agg = j
                    break
            return GroupByDecision(
                "direct_wide", lo=st.lo, span=span,
                num_slots=bucket_size(span), live_agg=live_agg,
                fd_drop=fd_tuple)
        return GroupByDecision("generic")

    # -- entry --------------------------------------------------------------
    def run(self) -> PlanDecisions:
        # Sort+Limit(k) fusion is decided top-down before infer() walks
        # bottom-up, so Limit's lane count reflects it
        node = self.plan
        topk = None
        if (isinstance(node, Limit) and isinstance(node.child, Sort)
                and 1 <= node.count <= self.topk_max):
            topk = LimitDecision("topk", k=node.count)
            self.by_node[id(node)] = topk
            self.by_node[id(node.child)] = SortDecision("skip")
        try:
            self.infer(self.plan)
        except PlanError as err:
            self.fail(str(err))
        if topk is not None:
            self.suffix.append(topk.key())
        return PlanDecisions(self.by_node, tuple(self.suffix),
                             self.dict_joins, self.eager_reason)


def plan_decisions(plan, tables: Tuple[Table, ...]) -> PlanDecisions:
    """Strategy decisions for an (already optimized) DAG plan against
    concrete input tables. Host-only; runs on every execute — the
    ProgramCache key carries ``cache_suffix`` so distinct decision sets
    lower distinct programs."""
    return _Planner(plan, tables).run()
