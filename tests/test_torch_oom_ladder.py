"""The port's OOM degradation ladder against the JAX package's:
``with_retry`` over scripted OOM sequences, the split machinery of
plan/split.py (the cases of tests/test_plan_split.py), and the fused
executor under injected OOMs (injectionType 6), a real adaptor pool and
the unmergeable gates — equal output bits, equal ``plan_oom_*`` counters,
equal fallback reasons, equal typed sheds.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import tpch as jtpch
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.columnar.encodings import rle_encode
from spark_rapids_jni_tpu.faultinj import injector as JI
from spark_rapids_jni_tpu.faultinj import watchdog as JW
from spark_rapids_jni_tpu.memory import exceptions as JE
from spark_rapids_jni_tpu.memory.retry import with_retry as j_with_retry
from spark_rapids_jni_tpu.memory.rmm_spark import RmmSpark as JRmm
from spark_rapids_jni_tpu.plan import (Filter, GroupBy, Scan, Sort, col,
                                       lit)
from spark_rapids_jni_tpu.plan import execute_plan as j_execute
from spark_rapids_jni_tpu.plan import plan_metrics as j_metrics
from spark_rapids_jni_tpu.plan import run_eager as j_eager
from spark_rapids_jni_tpu.plan import split as JSP
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import tpch as ptpch
from spark_rapids_jni_tpu_torch.faultinj import injector as PI
from spark_rapids_jni_tpu_torch.faultinj import watchdog as PW
from spark_rapids_jni_tpu_torch.memory import exceptions as PE
from spark_rapids_jni_tpu_torch.memory.retry import with_retry as p_with_retry
from spark_rapids_jni_tpu_torch.memory.rmm_spark import RmmSpark as PRmm
from spark_rapids_jni_tpu_torch.plan import execute_plan as p_execute
from spark_rapids_jni_tpu_torch.plan import plan_metrics as p_metrics
from spark_rapids_jni_tpu_torch.plan import run_eager as p_eager
from spark_rapids_jni_tpu_torch.plan import split as PSP
from spark_rapids_jni_tpu_torch.utils import config as pconfig

from torch_parity import assert_table_equal, plan_to_port, tables_to_port

N = 4096  # even: equal halves share one input signature
JAX = dict(with_retry=j_with_retry, E=JE, C=jconfig, W=JW, I=JI,
           execute=j_execute, metrics=j_metrics, eager=j_eager, SP=JSP,
           Rmm=JRmm)
PORT = dict(with_retry=p_with_retry, E=PE, C=pconfig, W=PW, I=PI,
            execute=p_execute, metrics=p_metrics, eager=p_eager, SP=PSP,
            Rmm=PRmm)


@pytest.fixture(autouse=True)
def _clean():
    yield
    for p in (JAX, PORT):
        p["I"].uninstall()
        p["W"].reset()
        p["Rmm"].clear_event_handler()


# ---------------------------------------------------------------------------
# with_retry: the protocol core over scripted OOM sequences
# ---------------------------------------------------------------------------

def _retry_scenarios(p):
    """Each scenario's record: results, callback counts, or the raised
    type, message and cause type."""
    wr, E, C, W = p["with_retry"], p["E"], p["C"], p["W"]
    out = {}

    def record(name, fn):
        try:
            out[name] = ("ok", fn())
        except Exception as e:  # noqa: BLE001 - the record
            out[name] = (type(e).__name__, str(e),
                         type(e.__cause__).__name__)

    calls = {"a": 0, "r": 0}

    def flaky(a):
        calls["a"] += 1
        if calls["a"] <= 2:
            raise E.TpuRetryOOM("injected")
        return a

    def rolled():
        calls["r"] += 1

    record("rollback", lambda: (wr(flaky, "ok", rollback=rolled),
                                dict(calls)))

    def halves(piece):
        if len(piece) > 2:
            raise E.TpuSplitAndRetryOOM("too big")
        return list(piece)

    record("order", lambda: wr(halves, list(range(8)),
                               split=lambda q: [q[:len(q) // 2],
                                                q[len(q) // 2:]]))

    def never(piece):
        raise E.TpuSplitAndRetryOOM("never fits")

    def split1(q):
        h = max(1, len(q) // 2)
        return [q[:h], q[h:]]

    with C.override("rmm.max_split_depth", 2):
        record("depth config", lambda: wr(never, list(range(64)),
                                          split=split1, max_retries=50))
    record("depth param", lambda: wr(never, [1, 2, 3, 4],
                                     split=lambda q: [q[:2], q[2:]],
                                     max_split_depth=0))
    record("one piece", lambda: wr(never, [1], split=lambda q: [q]))

    def demand(a):
        raise E.TpuSplitAndRetryOOM("the demand")

    record("no split callback", lambda: wr(demand, 1))

    def storm(a):
        raise E.TpuRetryOOM("storm")

    record("budget", lambda: wr(storm, 1, max_retries=3))
    state = {"n": 0}

    def host(piece):
        state["n"] += 1
        if state["n"] == 1:
            raise E.CpuRetryOOM("host pool")
        if state["n"] == 2:
            raise E.CpuSplitAndRetryOOM("host pool")
        return sum(piece)

    record("cpu variants", lambda: wr(host, [1, 2, 3, 4],
                                      split=lambda q: [q[:2], q[2:]],
                                      rollback=lambda: None))
    seen = {}

    def once(a):
        if "w" not in seen:
            raise E.TpuRetryOOM("once")
        return a

    record("oom wait", lambda: (wr(once, 5, rollback=lambda: seen.update(
        w=W.in_oom_wait())), seen["w"]))
    return out


def test_with_retry_scenarios_match():
    j = _retry_scenarios(JAX)
    p = _retry_scenarios(PORT)
    assert p == j
    assert p["rollback"] == ("ok", (["ok"], {"a": 3, "r": 2}))
    assert p["budget"][:2] == ("TpuRetryOOM", "gave up after 3 retries")


# ---------------------------------------------------------------------------
# plan/split.py: the cases of tests/test_plan_split.py, both packages
# ---------------------------------------------------------------------------

def _force_split(p, plan, table):
    SP = p["SP"]
    spec = SP.prepare(plan)
    pieces = SP.split_table(table)
    results = [p["eager"](spec.piece_plan, q) for q in pieces]
    return SP.merge_pieces(spec, results, table.num_rows,
                           int(p["C"].get("plan.max_groups")))


def _small(keys, vals):
    return JTable((JColumn.from_pylist(keys, jdt.INT64),
                   JColumn.from_pylist(vals, jdt.INT64)))


SPLIT_CASES = {
    "concat, one empty piece": (
        Filter(Scan(2), col(0) < lit(100)),
        ([1, 2, 3, 4, 500, 600, 700, 800], [10, 20, 30, 40, 50, 60, 70, 80])),
    "concat, all pieces empty": (
        Filter(Scan(2), col(0) > lit(1000)), ([1, 2, 3, 4], [9, 9, 9, 9])),
    "mean, one zero-row piece": (
        GroupBy(Filter(Scan(2), col(0) < lit(100)), (0,),
                ((1, "mean"), (1, "count"), (1, "sum"))),
        ([1, 1, 2, 2, 900, 900, 900, 900], [3, 4, 10, 21, 5, 5, 5, 5])),
    "mean, straddling group": (
        Sort(GroupBy(Scan(2), (0,), ((1, "mean"), (1, "count"))), (0,)),
        ([1, 1, 1, 2, 1, 2, 2, 2], [1, 2, 3, 100, 6, 101, 102, 97])),
    "single row": (Filter(Scan(2), col(0) > lit(0)), ([7], [42])),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_machinery_matches(case):
    jplan, (keys, vals) = SPLIT_CASES[case]
    jt = _small(keys, vals)
    pt = tables_to_port(jt)
    pplan = plan_to_port(jplan)
    got = _force_split(PORT, pplan, pt)
    assert_table_equal(_force_split(JAX, jplan, jt), got, presence=False)
    assert_table_equal(p_eager(pplan, pt), got, presence=False)
    assert len(PSP.split_table(pt)) == len(JSP.split_table(jt))


def test_all_pieces_zero_groups_is_typed_in_both():
    jplan = GroupBy(Filter(Scan(2), col(0) > lit(1000)), (0,),
                    ((1, "sum"),))
    msgs = []
    for p, plan, t in ((JAX, jplan, _small([1, 2, 3, 4], [9, 9, 9, 9])),
                       (PORT, plan_to_port(jplan), tables_to_port(
                           _small([1, 2, 3, 4], [9, 9, 9, 9])))):
        with pytest.raises(p["SP"].SplitMergeError) as ei:
            _force_split(p, plan, t)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] == "every piece aggregated to zero groups"


# ---------------------------------------------------------------------------
# the fused executor under injected OOMs and a real pool
# ---------------------------------------------------------------------------

def _table(n=N, seed=7):
    rng = np.random.default_rng(seed)

    def c(arr, d, null_p=0.0):
        v = jnp.asarray(rng.random(n) >= null_p) if null_p > 0 else None
        return JColumn(d, n, data=jnp.asarray(arr), validity=v)

    return JTable((
        c(rng.integers(0, 7, n).astype(np.int32), jdt.INT32, 0.1),
        c(rng.integers(0, 3, n).astype(np.int8), jdt.INT8),
        c(rng.integers(1, 1000, n), jdt.INT64, 0.2),
        c(rng.integers(0, 11, n).astype(np.int32), jdt.INT32),
        c(rng.integers(0, 2500, n).astype(np.int32), jdt.INT32),
    ))


P_FILTER = Filter(Scan(5), col(4) < lit(1800))
P_GB = GroupBy(Filter(Scan(5), col(4) < lit(1800)), (0,),
               ((2, "sum"), (2, "mean"), (2, "count")))
P_GB_SORT = Sort(GroupBy(Filter(Scan(5), col(4) < lit(1800)), (0,),
                         ((2, "sum"), (2, "mean"), (2, "count"))), (0,))
P_SORT_PRE = Sort(Filter(Scan(5), col(4) < lit(1800)), (0,))
OOM_KEYS = ("plan_oom_retries", "plan_oom_splits", "plan_oom_pieces",
            "plan_fallbacks")


def _oom_rule(mode, count=1, **extra):
    rule = {"percent": 100, "injectionType": 6, "interceptionCount": count,
            "oomMode": mode}
    rule.update(extra)
    return {"xlaRuntimeFaults": {"plan_execute": rule}}


def _governed_run(p, plan, table, cfg_path, overrides=()):
    """(result or (raised type, message), counter deltas) of one
    execute_plan under the fault config."""
    m = p["metrics"]
    before = m.snapshot()
    if cfg_path:
        p["I"].install(cfg_path, seed=0)
    try:
        import contextlib
        with contextlib.ExitStack() as stack:
            for k, v in overrides:
                stack.enter_context(p["C"].override(k, v))
            try:
                out = p["execute"](plan, table)
            except Exception as e:  # noqa: BLE001 - the record
                out = (type(e).__name__, str(e))
    finally:
        p["I"].uninstall()
    after = m.snapshot()
    delta = {k: after[k] - before[k] for k in OOM_KEYS}
    reasons = {k: v - before["plan_fallback_reasons"].get(k, 0)
               for k, v in after["plan_fallback_reasons"].items()
               if v != before["plan_fallback_reasons"].get(k, 0)}
    return out, delta, reasons


def _both(tmp_path, jplan, jtable, cfg, overrides=()):
    path = None
    if cfg is not None:
        path = str(tmp_path / "oom.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
    j = _governed_run(JAX, jplan, jtable, path, overrides)
    p = _governed_run(PORT, plan_to_port(jplan), tables_to_port(jtable),
                      path, overrides)
    assert p[1:] == j[1:]
    if isinstance(j[0], tuple):
        assert p[0] == j[0]
    else:
        assert_table_equal(j[0], p[0], presence=False)
    return p


def test_injected_retry_oom_redispatches(tmp_path):
    _, delta, reasons = _both(tmp_path, P_GB, _table(),
                              _oom_rule("retry", count=2))
    assert delta == {"plan_oom_retries": 2, "plan_oom_splits": 0,
                     "plan_oom_pieces": 0, "plan_fallbacks": 0}


@pytest.mark.parametrize("plan", ["filter", "groupby_sort"])
def test_injected_split_merges(tmp_path, plan):
    jplan = {"filter": P_FILTER, "groupby_sort": P_GB_SORT}[plan]
    _, delta, _ = _both(tmp_path, jplan, _table(), _oom_rule("split"))
    assert delta == {"plan_oom_retries": 0, "plan_oom_splits": 1,
                     "plan_oom_pieces": 2, "plan_fallbacks": 0}


def test_shrink_cap_forces_the_split(tmp_path):
    t = _table()
    cap = int(1.5 * t.device_nbytes())
    _, delta, _ = _both(tmp_path, P_GB, t, _oom_rule("shrink",
                                                     poolBytes=cap))
    assert delta["plan_oom_splits"] == 1 and delta["plan_oom_pieces"] == 2


def test_exhausted_split_depth_and_retry_budget_shed_typed(tmp_path):
    out, _, _ = _both(tmp_path, P_FILTER, _table(),
                      _oom_rule("shrink", poolBytes=1),
                      overrides=[("rmm.max_split_depth", 1)])
    assert out[0] == "TpuSplitAndRetryOOM"
    out, delta, _ = _both(tmp_path, P_GB, _table(),
                          _oom_rule("retry", count=9),
                          overrides=[("plan.oom_retry_budget", 2)])
    assert out == ("TpuRetryOOM", "gave up after 2 retries")
    assert delta["plan_oom_retries"] == 2


def test_donated_run_sheds_oom_typed(tmp_path):
    """A donated run stays outside the ladder: an injected OOM propagates
    typed from both packages, no rung runs, and the input, which the
    program never received, keeps its columns."""
    jplan = GroupBy(Filter(Scan(5), col(4) < lit(1800)), (0,),
                    ((2, "sum"), (2, "count")))
    path = str(tmp_path / "oom.json")
    with open(path, "w") as f:
        json.dump(_oom_rule("retry"), f)
    jt = _table()
    pt = tables_to_port(jt)
    outs = []
    for p, plan, table in ((JAX, jplan, jt), (PORT, plan_to_port(jplan), pt)):
        before = p["metrics"].snapshot()["plan_oom_retries"]
        p["I"].install(path, seed=0)
        try:
            with pytest.raises(p["E"].TpuRetryOOM) as err:
                p["execute"](plan, table, donate_input=True)
        finally:
            p["I"].uninstall()
        outs.append((type(err.value).__name__,
                     p["metrics"].snapshot()["plan_oom_retries"] - before))
    assert outs[0] == outs[1] == ("TpuRetryOOM", 0)
    assert not pt.is_donated


def _rle_table():
    rng = np.random.default_rng(9)
    runs = JColumn.from_numpy(
        np.repeat(rng.integers(0, 5, 64), 64).astype(np.int64), jdt.INT64)
    return JTable((rle_encode(runs), JColumn(
        jdt.INT64, runs.size,
        data=jnp.asarray(rng.integers(0, 100, runs.size)))))


def _float_table():
    rng = np.random.default_rng(11)
    return JTable((
        JColumn(jdt.INT32, 2048, data=jnp.asarray(
            rng.integers(0, 5, 2048).astype(np.int32))),
        JColumn(jdt.FLOAT32, 2048, data=jnp.asarray(
            rng.random(2048).astype(np.float32)))))


@pytest.mark.parametrize("gate", ["sort prefix", "float aggregate",
                                  "rle input"])
def test_unmergeable_gates_fall_back_with_the_same_reason(tmp_path, gate):
    jplan, jtable = {
        "sort prefix": (P_SORT_PRE, _table()),
        "float aggregate": (GroupBy(Scan(2), (0,), ((1, "sum"),)),
                            _float_table()),
        "rle input": (GroupBy(Scan(2), (0,), ((1, "sum"), (1, "count"))),
                      _rle_table()),
    }[gate]
    _, delta, reasons = _both(tmp_path, jplan, jtable, _oom_rule("split"))
    assert delta["plan_fallbacks"] == 1 and delta["plan_oom_splits"] == 0
    assert reasons == {"oom-split-unmergeable": 1}
    assert (PSP.split_unmergeable_reason(plan_to_port(jplan),
                                         tables_to_port(jtable))
            == JSP.split_unmergeable_reason(jplan, jtable))


def test_q5_dag_split_gates_to_eager(tmp_path, monkeypatch):
    """A split demand on the q5 join DAG takes the named eager gate in
    both packages. The JAX package's eager q5 is not run (its first-call
    compiles take ~15 s here): its executor's fallback is recorded with
    the reason it was given and answered with its fused q5, which its own
    tests hold equal to its eager q5."""
    from spark_rapids_jni_tpu.plan import executor as JX
    jtabs = jtpch.generate_q5_tables(4096, 11)
    ptabs = ptpch.generate_q5_tables(4096, 11, "cpu")
    jbase = jtpch.run_q5(*jtabs, engine="plan")
    pbase = ptpch.run_q5(*ptabs, engine="plan")
    assert_table_equal(jbase, pbase, presence=False)
    jreasons = []

    def recorded(plan, tables, fallback_reason=None):
        jreasons.append(fallback_reason)
        return j_execute(plan, tables)  # the fused q5, injector removed
    monkeypatch.setattr(JX, "run_eager", recorded)
    path = str(tmp_path / "oom.json")
    with open(path, "w") as f:
        json.dump(_oom_rule("split"), f)
    JI.install(path, seed=0)
    jout = jtpch.run_q5(*jtabs, engine="plan")
    JI.uninstall()
    before = p_metrics.snapshot()
    PI.install(path, seed=0)
    pout = ptpch.run_q5(*ptabs, engine="plan")
    PI.uninstall()
    after = p_metrics.snapshot()
    assert jreasons == ["oom-split-unmergeable"]
    assert after["plan_fallbacks"] - before["plan_fallbacks"] == 1
    assert (after["plan_fallback_reasons"].get("oom-split-unmergeable", 0)
            - before["plan_fallback_reasons"].get(
                "oom-split-unmergeable", 0)) == 1
    assert after["plan_oom_splits"] == before["plan_oom_splits"]
    assert_table_equal(jout, pout, presence=False)


def test_real_pool_splits_the_fused_plan(tmp_path):
    """A pool of 0.75 x the 2x envelope: the reservation itself escalates
    to TpuSplitAndRetryOOM through the adaptor's state machine, the ladder
    splits into two pieces, and the pool drains to 0 — the same in both
    packages."""
    jt = _table()
    runs = []
    for p, plan, table in ((JAX, P_GB_SORT, jt),
                           (PORT, plan_to_port(P_GB_SORT),
                            tables_to_port(jt))):
        R = p["Rmm"]
        R.set_event_handler(pool_bytes=int(0.75 * 2 * table.device_nbytes()),
                            watchdog_period_s=0.01)
        R.current_thread_is_dedicated_to_task(1)
        try:
            out, delta, reasons = _governed_run(p, plan, table, None)
            runs.append((out, delta, reasons, R.pool_used(),
                         R.get_and_reset_num_split_retry(1) >= 1))
        finally:
            R.remove_current_thread_association()
            R.task_done(1)
            R.clear_event_handler()
    (jo, *jrest), (po, *prest) = runs
    assert prest == jrest
    assert prest[0] == {"plan_oom_retries": 0, "plan_oom_splits": 1,
                        "plan_oom_pieces": 2, "plan_fallbacks": 0}
    assert prest[2:] == [0, True]
    assert_table_equal(jo, po, presence=False)
    assert_table_equal(j_eager(P_GB_SORT, jt), po, presence=False)
    assert torch.equal(po.columns[0].data,
                       p_execute(plan_to_port(P_GB_SORT),
                                 tables_to_port(jt)).columns[0].data)
