"""Port parity: TPC-H q1, q3, q5 and q6 (spark_rapids_jni_tpu_torch.tpch)
on both of the port's engines against the JAX package's
benchmarks/tpch.py, bit-exact, at 8,192 lineitem rows on the CPU.

``engine="auto"`` takes the fused plan engine here because
``plan.min_rows`` is overridden below the row count, as it does at SF10
with the default floor. The JAX package's reference is its fused engine
(``engine="plan"``) for all four queries, and its eager engine too for q1
and q6 (its eager q3 and q5 spend seconds compiling their first calls on
the CPU; its own tests hold the two engines bit-identical, and
tests/test_torch_q3.py holds the port's eager q3 against its eager q3).
"""

import dataclasses

import numpy as np
import pytest

from benchmarks import tpch as jtpch
from spark_rapids_jni_tpu.plan import plan_metrics as j_metrics
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import tpch
from spark_rapids_jni_tpu_torch.plan import (GroupBy, optimize,
                                             plan_decisions, plan_metrics,
                                             walk)
from spark_rapids_jni_tpu_torch.utils import config

from torch_parity import assert_table_equal, metric_counts, tables_to_port

ROWS = 8192


@pytest.fixture(scope="module")
def jax_tables():
    return {"q1": (jtpch.generate_q1_lineitem(ROWS, 21),),
            "q3": jtpch.generate_q3_tables(ROWS, 22),
            "q5": jtpch.generate_q5_tables(ROWS, 23)}


_GEN = {"q1": lambda: (tpch.generate_q1_lineitem(ROWS, 21, device="cpu"),),
        "q3": lambda: tpch.generate_q3_tables(ROWS, 22, device="cpu"),
        "q5": lambda: tpch.generate_q5_tables(ROWS, 23, device="cpu")}


@pytest.mark.parametrize("q", sorted(_GEN))
def test_generators_same_data_and_stats_as_jax(jax_tables, q):
    mine = _GEN[q]()
    for jt, pt in zip(jax_tables[q], mine):
        assert_table_equal(jt, pt)
        for jc, pc in zip(jt.columns, pt.columns):
            js, ps = jc.stats(), pc.stats()
            assert (js is None) == (ps is None)
            if js is not None:
                assert dataclasses.asdict(js) == dataclasses.asdict(ps)


_RUN = {"q1": (jtpch.run_q1, tpch.run_q1, "q1"),
        "q6": (jtpch.run_q6, tpch.run_q6, "q1"),
        "q3": (jtpch.run_q3, tpch.run_q3, "q3"),
        "q5": (jtpch.run_q5, tpch.run_q5, "q5")}


def _same(want, got, presence=True):
    if isinstance(want, int):
        assert isinstance(got, int) and want == got
    else:
        assert_table_equal(want, got, presence)


@pytest.mark.parametrize("q", sorted(_RUN))
def test_query_both_engines_match_jax(jax_tables, q):
    jrun, prun, data = _RUN[q]
    jtabs = jax_tables[data]
    ptabs = tables_to_port(jtabs)
    wants = [jrun(*jtabs, engine="plan")]
    if q in ("q1", "q6"):
        wants.append(jrun(*jtabs, engine="eager"))
    plan_metrics.reset()
    with config.override("plan.min_rows", 1000):
        fused = prun(*ptabs)                      # engine="auto"
    snap = plan_metrics.snapshot()
    assert (snap["plan_executes"], snap["plan_fallbacks"],
            snap["plan_join_fallbacks"]) == (1, 0, 0), snap
    eager = prun(*ptabs, engine="eager")
    # engine against the same engine: validity presence too; across
    # engines: values and validity bits
    _same(wants[0], fused)
    _same(wants[0], eager, presence=False)
    if len(wants) > 1:
        _same(wants[1], eager)
        _same(wants[1], fused, presence=False)


def test_q6_empty_survivors_is_zero_on_both_engines(jax_tables):
    ptabs = tables_to_port(jax_tables["q1"])
    for engine in ("plan", "eager"):
        assert tpch.run_q6(*ptabs, date_lo=9000, date_hi=9001,
                           engine=engine) == 0


def test_auto_engine_respects_min_rows_floor(jax_tables):
    (li,) = tables_to_port(jax_tables["q1"])
    plan_metrics.reset()
    tpch.run_q1(li)
    assert plan_metrics.snapshot()["plan_executes"] == 0
    with config.override("plan.min_rows", ROWS):
        tpch.run_q1(li)
    assert plan_metrics.snapshot()["plan_executes"] == 1


def test_q3_generic_groupby_when_span_exceeds_wide_span(jax_tables):
    """q3's groupby key spans more than ``plan.groupby_wide_span``, as it
    does at SF10 (15M orders) with the default knob: the planner keeps the
    three keys and picks the generic sorted groupby in both packages, and
    the fused answers agree."""
    jtabs = jax_tables["q3"]
    ptabs = tables_to_port(jtabs)
    j_metrics.reset()
    with jconfig.override("plan.groupby_wide_span", 1000):
        want = jtpch.run_q3(*jtabs, engine="plan")
    plan_metrics.reset()
    with config.override("plan.groupby_wide_span", 1000):
        plan = tpch._q3_plan(tpch.CUTOFF_DAYS, 1, 10)
        opt = optimize(plan, ptabs)
        dec = plan_decisions(opt, ptabs)
        got = tpch.run_q3(*ptabs, engine="plan")
    gb = next(n for n in walk(opt) if isinstance(n, GroupBy))
    assert dec.of(gb).strategy == "generic"
    assert metric_counts(plan_metrics.snapshot()) == metric_counts(
        j_metrics.snapshot())
    assert_table_equal(want, got)


def test_q1_means_are_float64_sum_over_count(jax_tables):
    """A mean is the exact int64 sum divided once by the count in
    float64, on both engines."""
    (li,) = tables_to_port(jax_tables["q1"])
    g = tpch.run_q1(li, engine="eager")
    sums = g.columns[2].to_numpy()
    cnt = g.columns[9].to_numpy()
    np.testing.assert_array_equal(g.columns[6].to_numpy(),
                                  sums.astype(np.float64)
                                  / cnt.astype(np.float64))
