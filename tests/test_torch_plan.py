"""Port parity: the plan engine (spark_rapids_jni_tpu_torch.plan) against
the JAX package's plan/ on the CPU, bit-exact.

Plans are the JAX package's own test plans (tests/test_plan.py PLANS,
tests/test_plan_join.py's probe/build joins), translated node by node
into the port's constructors. Each is run by the port's eager interpreter
and by its fused executor, and both are held against the JAX package's
fused engine — which the JAX package's own tests hold bit-identical to its
eager engine, and which compiles in a fraction of the time of the eager
engine's first calls on the CPU. The fallbacks are held to the JAX
package's counters on the same inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks import tpch as jtpch
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnStats as JStats
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.ops.groupby import \
    groupby_direct_small_core as j_direct_small
from spark_rapids_jni_tpu.plan import (Filter, GroupBy, Join, Project,
                                       Scan, Sort, col, lit)
from spark_rapids_jni_tpu.plan import execute_plan as j_execute
from spark_rapids_jni_tpu.plan import expr as jex
from spark_rapids_jni_tpu.plan import fingerprint as j_fingerprint
from spark_rapids_jni_tpu.plan import optimize as j_optimize
from spark_rapids_jni_tpu.plan import plan_decisions as j_decisions
from spark_rapids_jni_tpu.plan import plan_metrics as j_metrics
from spark_rapids_jni_tpu.plan import run_eager as j_eager
from spark_rapids_jni_tpu.plan import walk as j_walk
from spark_rapids_jni_tpu.plan.compile import ProgramCache as JCache
from spark_rapids_jni_tpu.plan.nodes import \
    canonical_repr as j_canonical_repr
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import plan as P
from spark_rapids_jni_tpu_torch import tpch
from spark_rapids_jni_tpu_torch.columnar import dtype as dt
from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
from spark_rapids_jni_tpu_torch.ops.groupby import groupby_direct_small_core
from spark_rapids_jni_tpu_torch.plan import expr as pex
from spark_rapids_jni_tpu_torch.plan.compile import ProgramCache
from spark_rapids_jni_tpu_torch.utils import config

from tests.test_plan import PLANS, _table
from tests.test_plan_join import NB, _c, _join_plan, _probe_build
from torch_parity import (assert_col_equal, assert_table_equal,
                          expr_to_port, metric_counts, plan_to_port,
                          tables_to_port)

LINEAR_ROWS = 1000


def _port_both(plan, tables):
    """(port eager, port fused) results of one plan; the fused run must
    take the fused path with no fallback."""
    eager = P.run_eager(plan, tables)
    P.plan_metrics.reset()
    fused = P.execute_plan(plan, tables, cache=ProgramCache())
    snap = P.plan_metrics.snapshot()
    assert snap["plan_executes"] == 1 and snap["plan_fallbacks"] == 0, snap
    return eager, fused


def _hold(jplan, jtables, want=None):
    """Run ``jplan`` on both port engines and hold each against ``want``
    (default: the JAX package's fused result)."""
    if want is None:
        want = j_execute(jplan, jtables, cache=JCache())
    for got in _port_both(plan_to_port(jplan), tables_to_port(jtables)):
        assert_table_equal(want, got)


# ---------------------------------------------------------------------------
# fingerprints, decisions
# ---------------------------------------------------------------------------

_JOIN_PLANS = {f"join_{how}": (lambda how=how: _join_plan(how))
               for how in ("inner", "left", "semi", "anti")}
_TPCH = {
    "q1": (lambda: jtpch._q1_plan(2400), lambda: tpch._q1_plan(2400)),
    "q3": (lambda: jtpch._q3_plan(1200, 1, 10),
           lambda: tpch._q3_plan(1200, 1, 10)),
    "q5": (lambda: jtpch._q5_plan(2, 700, 1065),
           lambda: tpch._q5_plan(2, 700, 1065)),
    "q6": (lambda: jtpch._q6_plan(365, 730, 5, 7, 24),
           lambda: tpch._q6_plan(365, 730, 5, 7, 24)),
}


@pytest.mark.parametrize("name", sorted({**PLANS, **_JOIN_PLANS}))
def test_fingerprint_of_translated_plan_matches_jax(name):
    jplan = {**PLANS, **_JOIN_PLANS}[name]()
    pplan = plan_to_port(jplan)
    assert P.fingerprint(pplan) == j_fingerprint(jplan)
    assert P.nodes.canonical_repr(pplan) == j_canonical_repr(jplan)


@pytest.mark.parametrize("q", sorted(_TPCH))
def test_tpch_plan_fingerprint_matches_jax(q):
    jbuild, pbuild = _TPCH[q]
    assert P.fingerprint(pbuild()) == j_fingerprint(jbuild())


def _decision_rows(dec, plan, walk):
    """Per node in post-order: the planner's decision as plain values (a
    join id in an FD triple becomes the join's post-order position)."""
    nodes = walk(plan)
    pos = {id(n): i for i, n in enumerate(nodes)}
    rows = []
    for n in nodes:
        d = dec.of(n)
        if d is None:
            rows.append(None)
            continue
        f = {k: v for k, v in vars(d).items() if k != "dict_remap"}
        if "fd_drop" in f:
            f["fd_drop"] = tuple((p, pos[j], r) for p, j, r in f["fd_drop"])
        rows.append((type(d).__name__, tuple(sorted(f.items()))))
    return rows


@pytest.fixture(scope="module")
def q35_tables():
    return {"q3": jtpch.generate_q3_tables(4096, 17),
            "q5": jtpch.generate_q5_tables(4096, 18)}


@pytest.mark.parametrize("q", ["q3", "q5"])
def test_optimize_and_decisions_match_jax(q35_tables, q):
    jtabs = q35_tables[q]
    jplan = _TPCH[q][0]()
    ptabs = tables_to_port(jtabs)
    jopt = j_optimize(jplan, jtabs)
    popt = P.optimize(plan_to_port(jplan), ptabs)
    assert P.fingerprint(popt) == j_fingerprint(jopt)
    jdec = j_decisions(jopt, jtabs)
    pdec = P.plan_decisions(popt, ptabs)
    assert jdec.eager_reason is None and pdec.eager_reason is None
    assert (_decision_rows(pdec, popt, P.walk)
            == _decision_rows(jdec, jopt, j_walk))
    strategies = {type(d).__name__: d.strategy for d in pdec.by_node.values()}
    assert strategies["JoinDecision"] == "direct"
    want = {"q3": "direct_wide", "q5": "direct_small"}[q]
    assert strategies["GroupByDecision"] == want


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

_EXPRS = {
    "col_int8": lambda: jex.col(1),
    "wrap_mul": lambda: jex.i64(jex.col(2)) * jex.lit((1 << 62) + 1),
    "arith_nulls": lambda: (jex.i64(jex.col(0)) + jex.col(2))
    - jex.lit(7) * jex.col(3),
    "cmp_nulls": lambda: jex.col(0) >= jex.col(3),
    "and_or_not_strict": lambda: ~((jex.col(0) < jex.lit(3))
                                   | (jex.col(2) > jex.lit(500)))
    & (jex.col(4) != jex.lit(9)),
    "lit_only": lambda: jex.lit(5) - jex.lit(9),
    "bool_lit": lambda: jex.lit(True) & (jex.col(1) == jex.lit(2)),
}


@pytest.fixture(scope="module")
def linear_tables():
    jt = _table(n=LINEAR_ROWS)
    return jt, tables_to_port(jt)


@pytest.mark.parametrize("name", sorted(_EXPRS))
def test_expression_matches_jax(linear_tables, name):
    jt, pt = linear_tables
    e = _EXPRS[name]()
    jv = jex.eval_expr(e, jt.columns)
    pv = pex.eval_expr(expr_to_port(e), pt.columns)
    assert_col_equal(jex.materialize(jv, jt.num_rows),
                     pex.materialize(pv, pt.num_rows))
    if jv.dtype.id is jdt.TypeId.BOOL8 and jv.data.ndim:
        np.testing.assert_array_equal(np.asarray(jex.predicate_mask(jv)),
                                      pex.predicate_mask(pv).numpy())


def test_float_arithmetic_is_a_type_error():
    c = Column.from_numpy(np.arange(4, dtype=np.float64), device="cpu")
    with pytest.raises(TypeError):
        pex.eval_expr(pex.col(0) + 1, [c])


# ---------------------------------------------------------------------------
# linear plans and joins: both port engines against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PLANS))
def test_linear_plan_matches_jax(linear_tables, name):
    _hold(PLANS[name](), linear_tables[0])


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("build", ["sorted_null_keys", "direct_dense"])
def test_join_plan_matches_jax(how, build):
    dense = build == "direct_dense"
    jtabs = _probe_build(seed=11 + dense, null_keys=not dense, dense=dense)
    jplan = _join_plan(how)
    ptabs = tables_to_port(jtabs)
    pplan = plan_to_port(jplan)
    dec = P.plan_decisions(P.optimize(pplan, ptabs), ptabs)
    assert [d.strategy for d in dec.by_node.values()] == [
        "direct" if dense else "sorted"]
    _hold(jplan, jtabs)


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_join_empty_build_side_matches_jax(how):
    """The filter kills every build row: inner/semi go empty, left keeps
    all-null payload, anti keeps everything."""
    jtabs = _probe_build(seed=13, null_keys=True, dense=False)
    jplan = Join(Scan(3, input_index=0),
                 Filter(Scan(3, input_index=1), col(0) < lit(-1)),
                 (0,), (0,), how)
    _hold(jplan, jtabs)


def test_join_downstream_groupby_sort_matches_jax():
    jtabs = _probe_build(seed=14, null_keys=True, dense=True)
    jplan = Sort(GroupBy(
        Project(Join(Filter(Scan(3, input_index=0), col(1) < lit(40)),
                           Scan(3, input_index=1), (0,), (0,), "inner"),
                      (col(5), col(2))),
        (0,), ((1, "sum"), (1, "count"))), (0,))
    _hold(jplan, jtabs)


def test_zero_row_build_table_left_join_all_null_payload():
    """A 0-row build INPUT: every probe row survives a left join with
    all-null, zero payload; the executor's empty-input gate replays it
    eagerly."""
    rng = np.random.default_rng(3)
    probe = JTable((_c(rng.integers(0, 10, 8), jdt.INT64),
                    _c(rng.integers(0, 5, 8).astype(np.int32), jdt.INT32)))
    build = JTable((_c(np.zeros(0, np.int64), jdt.INT64),
                    _c(np.zeros(0, np.int32), jdt.INT32)))
    jtabs = (probe, build)
    ptabs = tables_to_port(jtabs)
    for how, nrows in (("left", 8), ("inner", 0), ("semi", 0), ("anti", 8)):
        jplan = Join(Scan(2, input_index=0), Scan(2, input_index=1),
                     (0,), (0,), how)
        want = j_eager(jplan, jtabs)
        assert want.num_rows == nrows
        pplan = plan_to_port(jplan)
        assert_table_equal(want, P.run_eager(pplan, ptabs))
        P.plan_metrics.reset()
        assert_table_equal(want, P.execute_plan(pplan, ptabs,
                                                cache=ProgramCache()))
        assert P.plan_metrics.snapshot()["plan_fallback_reasons"] == {
            "unsupported-input": 1}
    assert P.unsupported_reason(pplan, ptabs[1]) == "empty input"


# ---------------------------------------------------------------------------
# fallbacks: same counters as the JAX package, same answer
# ---------------------------------------------------------------------------

def _budget_case():
    n = 4096
    t = JTable((JColumn(jdt.INT64, n, data=jnp.asarray(np.arange(n))),
                JColumn(jdt.INT64, n,
                        data=jnp.asarray(np.arange(n) * 3 + 1))))
    plan = Sort(GroupBy(Scan(2), (0,), ((1, "sum"), (1, "count"))), (0,))
    return plan, t, 2


def _dup_case():
    return (_join_plan("inner"),
            _probe_build(seed=31, null_keys=False, dense=False, dup=True),
            None)


def _lying_case():
    probe, build = _probe_build(seed=32, null_keys=False, dense=False)
    bad_key = build.columns[0].with_stats(
        JStats(lo=0, hi=NB - 1, unique=True, ascending_dense=True))
    return (_join_plan("inner"),
            (probe, JTable((bad_key,) + build.columns[1:])), None)


def _multi_key_case():
    return (Join(Scan(3, input_index=0), Scan(3, input_index=1),
                 (0, 1), (0, 2), "inner"),
            _probe_build(seed=33, null_keys=False), None)


_FALLBACKS = {"group_budget_overflow": _budget_case,
              "duplicate_build_key": _dup_case,
              "lying_dense_stats": _lying_case,
              "planner_unsupported_join": _multi_key_case}


@pytest.mark.parametrize("case", sorted(_FALLBACKS))
def test_fallback_counters_match_jax(case):
    jplan, jtabs, max_groups = _FALLBACKS[case]()
    budget = max_groups or jconfig.get("plan.max_groups")
    j_metrics.reset()
    with jconfig.override("plan.max_groups", budget):
        want = j_execute(jplan, jtabs, cache=JCache())
    jsnap = metric_counts(j_metrics.snapshot())
    assert jsnap["plan_fallbacks"] == 1
    P.plan_metrics.reset()
    with config.override("plan.max_groups", budget):
        got = P.execute_plan(plan_to_port(jplan), tables_to_port(jtabs),
                             cache=ProgramCache())
    assert metric_counts(P.plan_metrics.snapshot()) == jsnap
    assert_table_equal(want, got)


# ---------------------------------------------------------------------------
# cores and contracts
# ---------------------------------------------------------------------------

def test_groupby_direct_small_checks_live_rows_only():
    """tests/test_plan_join.py's sentinel case: a DEAD out-of-span row
    neither fires ``bad`` nor touches a sum; a live one fires ``bad``.
    Same slots, sums, live count and flag as the JAX package's core."""
    lo, span, num_slots, chunk = 10, 6, 16, 8
    key = np.array([10, 11, 10, 15, 12, 11, 10, 99, 13, 14], np.int64)
    val = np.array([5, 7, 11, 2, 3, 1, 9, 1000, 8, 4], np.int64)
    for dead in (True, False):
        mask = np.ones(10, bool)
        mask[7] = not dead
        want = j_direct_small(jnp.asarray(key), jnp.asarray(val),
                              jnp.asarray(mask), lo, span, num_slots, chunk)
        got = groupby_direct_small_core(
            torch.from_numpy(key), torch.from_numpy(val),
            torch.from_numpy(mask), lo, span, num_slots, chunk)
        nlive = int(want[2])
        assert int(got[2]) == nlive and bool(got[3]) == bool(want[3]) == (
            not dead)
        if dead:
            for w, g in zip(want[:2], got[:2]):
                np.testing.assert_array_equal(np.asarray(w)[:nlive],
                                              g.numpy()[:nlive])


def test_limit_on_filter_is_a_plan_error(linear_tables):
    plan = P.Limit(P.Filter(P.Scan(5), P.col(1) == P.lit(1)), 3)
    with pytest.raises(P.PlanError):
        P.execute_plan(plan, linear_tables[1], cache=ProgramCache())


def test_program_cache_hits_on_same_shape(linear_tables):
    plan = plan_to_port(PLANS["groupby_sort"]())
    cache = ProgramCache()
    P.plan_metrics.reset()
    a = P.execute_plan(plan, linear_tables[1], cache=cache)
    b = P.execute_plan(plan, linear_tables[1], cache=cache)
    snap = P.plan_metrics.snapshot()
    assert (snap["plan_compiles"], snap["plan_cache_hits"]) == (1, 1)
    assert len(cache) == 1
    for x, y in zip(a.columns, b.columns):
        assert torch.equal(x.data, y.data)


def _dict32_join():
    codes = Column(dt.DType(dt.TypeId.DICT32), 4,
                   data=torch.arange(4, dtype=torch.int32))
    t = Table((codes,))
    return lambda: P.execute_plan(
        P.Join(P.Scan(1, input_index=0), P.Scan(1, input_index=1),
               (0,), (0,), "inner"), [t, t])


_NOT_PORTED = {
    "string_literal": ("A10", lambda: pex.eval_expr(
        pex.col(0) == pex.lit("x"),
        [Column.from_numpy(np.arange(3), device="cpu")])),
    "dictionary_join_key": ("A10", _dict32_join()),
    "dictionary_operand": ("A10", lambda: pex.eval_expr(
        pex.col(0) == pex.lit(1),
        [Column(dt.DType(dt.TypeId.DICT32), 2,
                data=torch.zeros(2, dtype=torch.int32))])),
    "donate_input": ("A7", lambda: P.execute_plan(
        P.Scan(1), Table((Column.from_numpy(np.arange(3), device="cpu"),)),
        donate_input=True)),
    "float_mean": ("A4", lambda: P.run_eager(
        P.GroupBy(P.Scan(2), (0,), ((1, "mean"),)),
        Table((Column.from_numpy(np.arange(3), device="cpu"),
               Column.from_numpy(np.arange(3.0), device="cpu"))))),
    "tpch_mesh": ("A15", lambda: tpch.run_q6(
        tpch.generate_q1_lineitem(16, 0, device="cpu"), mesh=object())),
    "tpch_sharded": ("A15", lambda: tpch.run_q1(
        tpch.generate_q1_lineitem(16, 0, device="cpu"), engine="sharded")),
}


@pytest.mark.parametrize("case", sorted(_NOT_PORTED))
def test_not_ported_names_its_roadmap_item(case):
    item, call = _NOT_PORTED[case]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        call()


def test_dag_lowering_reads_only_needed_columns(q35_tables):
    """The q3 program gathers none of the orders payload onto the 60M
    lineitem lanes: o_orderkey and o_custkey are never read, and
    o_orderdate and o_shippriority come back by the FD reprobe of the
    build side at the groupby slots."""
    from spark_rapids_jni_tpu_torch.plan.compile import _needed_columns
    ptabs = tables_to_port(q35_tables["q3"])
    opt = P.optimize(tpch._q3_plan(1200, 1, 10), ptabs)
    dec = P.plan_decisions(opt, ptabs)
    need = _needed_columns(opt, dec)
    top = next(n for n in P.walk(opt)
               if isinstance(n, P.Join) and n.how == "inner")
    assert need[id(top)] == {0, 2, 3}
    assert need[id(top.right)] >= {0, 2, 3}


def test_plan_cores_are_the_jax_packages_cores():
    """Every function the port's lowering composes is tagged with the name
    of a JAX package plan core."""
    from spark_rapids_jni_tpu.plan import registered_cores as j_cores
    from spark_rapids_jni_tpu_torch.plan import registered_cores
    import spark_rapids_jni_tpu_torch.plan.compile  # noqa: F401 (imports
    #                                                 every core module)
    mine = registered_cores()
    assert set(mine) == {"sort_lanes", "select_topk", "groupby",
                         "groupby_direct_small", "groupby_direct_wide",
                         "join_build_sorted", "join_probe_sorted",
                         "join_probe_direct"}
    assert set(mine) <= set(j_cores())
