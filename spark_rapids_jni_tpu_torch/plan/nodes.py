"""Logical plan IR (the JAX package's plan/nodes.py, pure Python).

A plan is a DAG of frozen dataclass nodes rooted at ``Scan`` leaves:

    Scan -> [Filter | Project]* -> [GroupBy] -> [Sort] -> [Limit]

with ``Join`` nodes composing pipelines: ``Join(left, right, ...)``
probes the left pipeline's rows against a build of the right pipeline.
Plans without Join (and with a single input) keep the linear grammar.

The grammar is the fusable subset: Filter never compacts inside the fused
program (it carries a keep-mask that downstream nodes consume), and Join
keeps the probe side's lane count (build rows are gathered onto probe
lanes, never expanded), so every intermediate has a static shape.

Identity: ``fingerprint(plan)`` is a sha1 over a canonical repr built from
node and expression structure only (no data, no shapes). It is the same
string, so the same sha1, as the JAX package's for the same plan, and the
port's ProgramCache keys on it.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

from . import expr as ex


class PlanError(ValueError):
    """Malformed plan (bad structure or node arguments)."""


class PlanNode:
    """Base marker. Nodes are frozen dataclasses; ``child`` is the
    upstream node (None only for Scan)."""

    child: Optional["PlanNode"]


@dataclasses.dataclass(frozen=True)
class Scan(PlanNode):
    """Pipeline source: one of the input Tables handed to execute_plan.
    ``ncols`` is declared up front so expression column refs validate at
    build time; ``input_index`` selects which table of a multi-input DAG
    this leaf reads (0 for single-input linear plans)."""

    ncols: int
    child: None = None
    input_index: int = 0

    def __post_init__(self):
        if self.ncols < 1:
            raise PlanError("Scan needs at least one column")
        if self.input_index < 0:
            raise PlanError("Scan input_index must be non-negative")


@dataclasses.dataclass(frozen=True)
class Filter(PlanNode):
    """Keep rows where ``predicate`` is true (null predicate drops the
    row — SQL WHERE). Fused lowering carries this as a mask; no
    compaction happens inside the program."""

    child: PlanNode
    predicate: ex.Expr

    def __post_init__(self):
        if not isinstance(self.predicate, ex.Expr):
            raise PlanError("Filter predicate must be a plan expression")


@dataclasses.dataclass(frozen=True)
class Project(PlanNode):
    """Replace the column set with ``exprs`` (evaluated against the
    child's columns)."""

    child: PlanNode
    exprs: Tuple[ex.Expr, ...]

    def __post_init__(self):
        object.__setattr__(self, "exprs", tuple(self.exprs))
        if not self.exprs:
            raise PlanError("Project needs at least one expression")
        for e in self.exprs:
            if not isinstance(e, ex.Expr):
                raise PlanError("Project entries must be plan expressions")


@dataclasses.dataclass(frozen=True)
class GroupBy(PlanNode):
    """Sort-based hash-groupby-aggregate over ``keys`` (column indices of
    the child). ``aggs`` are (value column index, op) with op in
    sum/mean/min/max/count. Output columns are keys then aggs, in order —
    same contract as ops/groupby.groupby_aggregate."""

    child: PlanNode
    keys: Tuple[int, ...]
    aggs: Tuple[Tuple[int, str], ...]

    _OPS = ("sum", "mean", "min", "max", "count")

    def __post_init__(self):
        object.__setattr__(self, "keys", tuple(self.keys))
        object.__setattr__(self, "aggs",
                           tuple((int(i), str(op)) for i, op in self.aggs))
        if not self.keys:
            raise PlanError("GroupBy needs at least one key column")
        if not self.aggs:
            raise PlanError("GroupBy needs at least one aggregation")
        for _, op in self.aggs:
            if op not in self._OPS:
                raise PlanError(f"unknown aggregation {op!r}")


@dataclasses.dataclass(frozen=True)
class Sort(PlanNode):
    """Stable multi-key sort by ``keys`` (column indices). Defaults match
    ops/sort.sort_order: ascending, nulls first on ascending keys."""

    child: PlanNode
    keys: Tuple[int, ...]
    ascending: Optional[Tuple[bool, ...]] = None
    nulls_first: Optional[Tuple[bool, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "keys", tuple(self.keys))
        if self.ascending is not None:
            object.__setattr__(self, "ascending", tuple(self.ascending))
            if len(self.ascending) != len(self.keys):
                raise PlanError("Sort ascending length mismatch")
        if self.nulls_first is not None:
            object.__setattr__(self, "nulls_first", tuple(self.nulls_first))
            if len(self.nulls_first) != len(self.keys):
                raise PlanError("Sort nulls_first length mismatch")
        if not self.keys:
            raise PlanError("Sort needs at least one key column")


@dataclasses.dataclass(frozen=True)
class Limit(PlanNode):
    """First ``count`` rows. Only valid where the fused state is
    prefix-compacted (after GroupBy/Sort) — checked at lower time."""

    child: PlanNode
    count: int

    def __post_init__(self):
        if self.count < 0:
            raise PlanError("Limit count must be non-negative")


@dataclasses.dataclass(frozen=True)
class Join(PlanNode):
    """Join the ``left`` pipeline (probe side — row order preserved)
    against a build of the ``right`` pipeline on equal key columns.

    ``how``:
      inner  output = left cols + right cols; probe rows without a build
             match are dropped (mask).
      left   output = left cols + right cols; unmatched probe rows keep
             their left values with null right payload.
      semi   output = left cols only; keep probe rows WITH a match.
      anti   output = left cols only; keep probe rows WITHOUT a match
             (NOT EXISTS — a null probe key never matches, so anti keeps
             it; same contract as ops/join's poison-hash nulls).

    Fused lowering gathers build rows onto probe lanes, so the output
    lane count equals the left side's: a build side with duplicate keys
    (row-expanding join) trips the overflow flag and falls back to the
    eager interpreter, which expands the rows.
    """

    left: PlanNode
    right: PlanNode
    left_on: Tuple[int, ...]
    right_on: Tuple[int, ...]
    how: str = "inner"

    _HOWS = ("inner", "left", "semi", "anti")

    def __post_init__(self):
        object.__setattr__(self, "left_on",
                           tuple(int(i) for i in self.left_on))
        object.__setattr__(self, "right_on",
                           tuple(int(i) for i in self.right_on))
        if self.how not in self._HOWS:
            raise PlanError(f"unknown join how={self.how!r}")
        if not self.left_on or len(self.left_on) != len(self.right_on):
            raise PlanError("Join needs equal, non-empty key index tuples")
        ln, rn = output_ncols(self.left), output_ncols(self.right)
        for i in self.left_on:
            if not (0 <= i < ln):
                raise PlanError(f"Join left_on {i} out of range [0,{ln})")
        for i in self.right_on:
            if not (0 <= i < rn):
                raise PlanError(f"Join right_on {i} out of range [0,{rn})")


def walk(plan: PlanNode) -> Tuple[PlanNode, ...]:
    """Deterministic post-order node sequence (left before right before
    node) over the plan DAG."""
    out = []

    def _rec(node):
        if isinstance(node, Join):
            _rec(node.left)
            _rec(node.right)
        elif not isinstance(node, Scan):
            _rec(node.child)
        out.append(node)

    _rec(plan)
    return tuple(out)


def is_dag(plan: PlanNode) -> bool:
    """True when the plan needs the multi-pipeline (DAG) lowering: it
    contains a Join or reads an input other than table 0."""
    return any(isinstance(n, Join) or
               (isinstance(n, Scan) and n.input_index != 0)
               for n in walk(plan))


def num_inputs(plan: PlanNode) -> int:
    """Number of input tables the DAG reads (max Scan input_index + 1)."""
    return 1 + max(n.input_index for n in walk(plan) if isinstance(n, Scan))


def output_ncols(node: PlanNode) -> int:
    """Column count of a node's output schema."""
    if isinstance(node, Scan):
        return node.ncols
    if isinstance(node, Project):
        return len(node.exprs)
    if isinstance(node, GroupBy):
        return len(node.keys) + len(node.aggs)
    if isinstance(node, Join):
        if node.how in ("semi", "anti"):
            return output_ncols(node.left)
        return output_ncols(node.left) + output_ncols(node.right)
    if isinstance(node, (Filter, Sort, Limit)):
        return output_ncols(node.child)
    raise PlanError(f"unknown plan node {type(node).__name__}")


def linearize(plan: PlanNode) -> Tuple[PlanNode, ...]:
    """Scan-first node sequence; validates the chain is rooted at Scan.
    Linear-pipeline consumers only — a DAG plan (Join) does not
    linearize."""
    nodes = []
    node: Optional[PlanNode] = plan
    while node is not None:
        if isinstance(node, Join):
            raise PlanError("plan contains a Join — DAG plans don't "
                            "linearize; use walk()/the DAG lowering")
        nodes.append(node)
        if isinstance(node, Scan):
            break
        node = node.child
        if node is None:
            raise PlanError(f"{type(nodes[-1]).__name__} has no child; "
                            f"plans must be rooted at Scan")
    if not isinstance(nodes[-1], Scan):
        raise PlanError("plan is not rooted at Scan")
    return tuple(reversed(nodes))


def _expr_repr(e: ex.Expr) -> str:
    if isinstance(e, ex.Col):
        return f"c{e.index}"
    if isinstance(e, ex.Lit):
        # bool is an int subclass; keep the three kinds distinct in the canon
        if isinstance(e.value, bool):
            return f"lb{int(e.value)}"
        if isinstance(e.value, str):
            return f"ls{e.value!r}"
        return f"l{e.value}"
    if isinstance(e, ex.Cast64):
        return f"i64({_expr_repr(e.operand)})"
    if isinstance(e, ex.Not):
        return f"not({_expr_repr(e.operand)})"
    if isinstance(e, ex.BinOp):
        return f"{e.op}({_expr_repr(e.left)},{_expr_repr(e.right)})"
    raise PlanError(f"not a plan expression: {e!r}")


def _node_repr(n: PlanNode) -> str:
    if isinstance(n, Scan):
        # input_index 0 keeps the JAX package's linear-plan spelling
        if n.input_index == 0:
            return f"scan[{n.ncols}]"
        return f"scan[{n.ncols}]@{n.input_index}"
    if isinstance(n, Join):
        lon = ",".join(map(str, n.left_on))
        ron = ",".join(map(str, n.right_on))
        return f"join[{n.how}|{lon}|{ron}]"
    if isinstance(n, Filter):
        return f"filter[{_expr_repr(n.predicate)}]"
    if isinstance(n, Project):
        return "project[" + ";".join(_expr_repr(e) for e in n.exprs) + "]"
    if isinstance(n, GroupBy):
        aggs = ";".join(f"{i}:{op}" for i, op in n.aggs)
        return f"groupby[{','.join(map(str, n.keys))}|{aggs}]"
    if isinstance(n, Sort):
        asc = "" if n.ascending is None else \
            "|a" + "".join("1" if a else "0" for a in n.ascending)
        nf = "" if n.nulls_first is None else \
            "|n" + "".join("1" if f else "0" for f in n.nulls_first)
        return f"sort[{','.join(map(str, n.keys))}{asc}{nf}]"
    if isinstance(n, Limit):
        return f"limit[{n.count}]"
    raise PlanError(f"unknown plan node {type(n).__name__}")


def canonical_repr(plan: PlanNode) -> str:
    """Deterministic structural repr — the fingerprint preimage. Data- and
    shape-free by construction: only node kinds, column indices, literal
    values, and flags appear. Linear plans are ">"-joined; a Join
    brackets its two sub-pipelines."""
    if isinstance(plan, Scan):
        return _node_repr(plan)
    if isinstance(plan, Join):
        return ("(" + canonical_repr(plan.left) + "|" +
                canonical_repr(plan.right) + ")>" + _node_repr(plan))
    return canonical_repr(plan.child) + ">" + _node_repr(plan)


# Identity memo: the same long-lived (frozen, immutable) plan objects are
# fingerprinted on every execute. Values hold a strong ref to the plan so
# an id() cannot be recycled while its entry lives; the clear-on-full
# keeps the worst case bounded.
_FP_CACHE: dict = {}
_FP_CACHE_MAX = 512


def fingerprint(plan: PlanNode) -> str:
    """sha1 hex of the canonical plan structure; the program-cache key
    component that is stable across processes, datasets and packages."""
    hit = _FP_CACHE.get(id(plan))
    if hit is not None and hit[0] is plan:
        return hit[1]
    fp = hashlib.sha1(canonical_repr(plan).encode()).hexdigest()
    if len(_FP_CACHE) >= _FP_CACHE_MAX:
        _FP_CACHE.clear()
    _FP_CACHE[id(plan)] = (plan, fp)
    return fp
