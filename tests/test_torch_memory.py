"""The port's memory layer against the JAX package's: the OOM taxonomy,
the resource adaptor (each package builds its own copy of
native/resource_adaptor.cpp and runs its own RmmSpark singleton in this
process), the op reservation brackets, the HBM audit on the CPU and the
Monte-Carlo scheduler stress.

Every scripted sequence runs through both packages from the same start
and records what each step returned or raised; the two records must be
equal. Both adaptors are cleared after every test.
"""

import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.memory import exceptions as JE
from spark_rapids_jni_tpu.memory import rmm_spark as JR
from spark_rapids_jni_tpu.memory.retry import with_retry as j_with_retry
from spark_rapids_jni_tpu.ops import groupby as JG
from spark_rapids_jni_tpu.ops import join as JJ
from spark_rapids_jni_tpu.ops import row_conversion as JRC
from spark_rapids_jni_tpu.ops import sort as JS
from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
from spark_rapids_jni_tpu_torch.memory import exceptions as PE
from spark_rapids_jni_tpu_torch.memory import hbm
from spark_rapids_jni_tpu_torch.memory import monte_carlo as PMC
from spark_rapids_jni_tpu_torch.memory import native as PN
from spark_rapids_jni_tpu_torch.memory import reservation as PRES
from spark_rapids_jni_tpu_torch.memory import rmm_spark as PR
from spark_rapids_jni_tpu_torch.memory.retry import with_retry as p_with_retry
from spark_rapids_jni_tpu_torch.ops import groupby as PG
from spark_rapids_jni_tpu_torch.ops import join as PJ
from spark_rapids_jni_tpu_torch.ops import row_conversion as PRC
from spark_rapids_jni_tpu_torch.ops import sort as PS
from spark_rapids_jni_tpu_torch.utils import config as pconfig

from torch_parity import assert_col_equal, table_to_port

MB = 1 << 20


@pytest.fixture(autouse=True)
def _clear_adaptors():
    yield
    JR.RmmSpark.clear_event_handler()
    PR.RmmSpark.clear_event_handler()


def _name(exc):
    return None if exc is None else type(exc).__name__


# ---------------------------------------------------------------------------
# the taxonomy
# ---------------------------------------------------------------------------

def test_exception_taxonomy_and_status_codes():
    names = ("TpuOOM", "TpuRetryOOM", "TpuSplitAndRetryOOM", "OffHeapOOM",
             "CpuRetryOOM", "CpuSplitAndRetryOOM", "RetryStateException",
             "TaskRemovedException")
    for n in names:
        jm = [c.__name__ for c in getattr(JE, n).__mro__]
        pm = [c.__name__ for c in getattr(PE, n).__mro__]
        assert jm == pm, n
    for code in range(-2, 10):
        got = []
        for E in (JE, PE):
            try:
                E.raise_for_status(code, f"ctx {code}" if code % 2 else "")
                got.append(None)
            except Exception as e:  # noqa: BLE001 - compared below
                got.append((type(e).__name__, str(e)))
        assert got[0] == got[1], code
    assert [getattr(JE, k) for k in dir(JE) if k.startswith("RM_")] == \
        [getattr(PE, k) for k in dir(PE) if k.startswith("RM_")]


def test_port_builds_its_own_adaptor():
    """The port loads the library it built from native/resource_adaptor.cpp
    under build/torch_native/, not the JAX package's."""
    lib = PN.load()
    assert PN.so_path().parent.name == "torch_native"
    assert PN.so_path().exists()
    assert lib._name == str(PN.so_path())


# ---------------------------------------------------------------------------
# scripted RmmSpark sequences
# ---------------------------------------------------------------------------

def _script_single_thread(R):
    """One task thread through alloc, forced retry and split OOMs, the
    BUFN gate and the metrics; returns what each step gave."""
    S = R.RmmSpark
    out = []

    def step(label, fn):
        try:
            v = fn()
            out.append((label, "ok", v))
        except Exception as e:  # noqa: BLE001 - part of the record
            out.append((label, _name(e), None))

    S.set_event_handler(pool_bytes=8 * MB, watchdog_period_s=0.01)
    tid = S.get_current_thread_id()
    step("state before", lambda: R.ThreadState.name(S.get_state_of(tid)))
    step("dedicate", lambda: S.current_thread_is_dedicated_to_task(1))
    step("state", lambda: R.ThreadState.name(S.get_state_of(tid)))
    step("alloc 3MB", lambda: S.alloc(3 * MB))
    step("pool_used", S.pool_used)
    step("force retry", lambda: S.force_retry_oom(tid, 1))
    step("alloc 1MB (forced)", lambda: S.alloc(MB))
    step("state after throw",
         lambda: R.ThreadState.name(S.get_state_of(tid)))
    step("block until ready", S.block_thread_until_ready)
    step("alloc 1MB", lambda: S.alloc(MB))
    step("force split", lambda: S.force_split_and_retry_oom(tid, 1))
    step("alloc 1MB (forced split)", lambda: S.alloc(MB))
    step("block until ready", S.block_thread_until_ready)
    step("force exception", lambda: S.force_exception(tid, 1))
    step("alloc (forced exception)", lambda: S.alloc(MB))
    step("dealloc 4MB", lambda: S.dealloc(4 * MB))
    step("pool_used", S.pool_used)
    step("retry block", lambda: (S.start_retry_block(), S.end_retry_block()))
    step("num retry", lambda: S.get_and_reset_num_retry(1))
    step("num split retry", lambda: S.get_and_reset_num_split_retry(1))
    step("num retry again", lambda: S.get_and_reset_num_retry(1))
    step("max reserved", lambda: S.get_and_reset_max_device_reserved(1))
    step("lost time > 0",
         lambda: S.get_and_reset_compute_time_lost_to_retry_ns(1) >= 0)
    step("cpu prealloc", lambda: S.pre_cpu_alloc(MB))
    step("cpu postalloc", lambda: S.post_cpu_alloc_success(MB))
    step("cpu dealloc", lambda: S.cpu_dealloc(MB))
    step("remove", S.remove_current_thread_association)
    step("task done", lambda: S.task_done(1))
    step("state after", lambda: R.ThreadState.name(S.get_state_of(tid)))
    step("oversized untracked alloc", lambda: S.alloc(64 * MB))
    step("pool pressure", S.pool_pressure)
    S.clear_event_handler()
    step("installed", S.is_installed)
    return out


def test_scripted_single_thread_sequence_matches():
    j = _script_single_thread(JR)
    p = _script_single_thread(PR)
    assert p == j
    # the script reaches every outcome it is written for
    outcomes = {o for _, o, _ in p}
    assert {"ok", "TpuRetryOOM", "TpuSplitAndRetryOOM",
            "RetryStateException", "TpuOOM"} <= outcomes


def _script_two_tasks(R):
    """Task 2's reservation waits for task 1's release: the record of who
    held what, in order."""
    S = R.RmmSpark
    S.set_event_handler(pool_bytes=8 * MB, watchdog_period_s=0.01)
    events = []
    held = threading.Event()
    released = threading.Event()

    def task1():
        S.current_thread_is_dedicated_to_task(1)
        S.alloc(6 * MB)
        events.append(("t1 holds", S.pool_used()))
        held.set()
        # a busy wait: a thread parked in threading's waits counts as
        # blocked, and the deadlock sweep would then throw at task 2
        while not released.is_set():
            time.sleep(0.001)
        S.dealloc(6 * MB)
        S.remove_current_thread_association()
        S.task_done(1)

    def task2():
        S.current_thread_is_dedicated_to_task(2)
        held.wait(5)
        try:
            with_retry = j_with_retry if R is JR else p_with_retry
            with_retry(lambda n: S.alloc(n), 4 * MB)
            events.append(("t2 holds", S.pool_used()))
            S.dealloc(4 * MB)
        finally:
            S.remove_current_thread_association()
            S.task_done(2)

    a = threading.Thread(target=task1)
    b = threading.Thread(target=task2)
    a.start()
    b.start()
    held.wait(5)
    time.sleep(0.05)
    # task 2 cannot fit while task 1 holds 6 of 8 MB: it waits
    events.append(("t2 waiting", b.is_alive()))
    released.set()
    a.join(10)
    b.join(10)
    events.append(("end", S.pool_used()))
    S.clear_event_handler()
    return events


def test_scripted_two_task_wait_matches():
    assert _script_two_tasks(PR) == _script_two_tasks(JR) == [
        ("t1 holds", 6 * MB), ("t2 waiting", True), ("t2 holds", 4 * MB),
        ("end", 0)]


# ---------------------------------------------------------------------------
# op reservation brackets: the same estimates, the same releases
# ---------------------------------------------------------------------------

def _inputs(rows=3000, seed=0):
    rng = np.random.default_rng(seed)
    jt = JTable((
        JColumn.from_numpy(rng.integers(0, 50, rows), jdt.INT64),
        JColumn.from_numpy(rng.integers(-1000, 1000, rows), jdt.INT64),
        JColumn.from_numpy(rng.integers(0, 9, rows).astype(np.int32),
                           jdt.INT32,
                           validity=rng.random(rows) > 0.1),
    ))
    return jt, table_to_port(jt)


def _governed_deltas(R, run):
    """(result, [reservation deltas]) of ``run()`` on a task thread."""
    S = R.RmmSpark
    S.set_event_handler(pool_bytes=512 * MB, watchdog_period_s=0.01)
    deltas = []
    S.set_alloc_listener(lambda tid, d: deltas.append(d))
    S.current_thread_is_dedicated_to_task(1)
    try:
        out = run()
        assert S.pool_used() == 0
    finally:
        S.set_alloc_listener(None)
        S.remove_current_thread_association()
        S.task_done(1)
        S.clear_event_handler()
    return out, deltas


def _port_ops(pt):
    uniq = Column.from_numpy(np.arange(1500, dtype=np.int64), device="cpu")
    return {
        "sort": lambda: PS.sort_table(pt, [0]),
        "groupby": lambda: PG.groupby_aggregate(pt, [0], [(1, "sum"),
                                                         (2, "count")]),
        "join": lambda: PJ.inner_join([pt[0]], [uniq]),
        "to_rows": lambda: PRC.convert_to_rows(pt),
        "from_rows": lambda: PRC.convert_from_rows(
            PRC.convert_to_rows(pt)[0], [c.dtype for c in pt]),
    }


def _jax_ops(jt):
    uniq = JColumn.from_numpy(np.arange(1500, dtype=np.int64), jdt.INT64)
    return {
        "sort": lambda: JS.sort_table(jt, [0]),
        "groupby": lambda: JG.groupby_aggregate(jt, [0], [(1, "sum"),
                                                         (2, "count")]),
        "join": lambda: JJ.inner_join([jt[0]], [uniq]),
        "to_rows": lambda: JRC.convert_to_rows(jt),
        "from_rows": lambda: JRC.convert_from_rows(
            JRC.convert_to_rows(jt)[0], [c.dtype for c in jt]),
    }


@pytest.mark.parametrize("op", ["sort", "groupby", "join", "to_rows",
                                "from_rows"])
def test_op_brackets_reserve_what_the_jax_package_reserves(op):
    jt, pt = _inputs()
    jout, jd = _governed_deltas(JR, _jax_ops(jt)[op])
    pout, pd = _governed_deltas(PR, _port_ops(pt)[op])
    assert pd == jd and len(pd) >= 2
    assert all(d > 0 for d in pd[0::2]) and sum(pd) == 0
    # the governed result is the ungoverned one
    free = _port_ops(pt)[op]()
    for a, b in ((pout, free),):
        if isinstance(a, Table):
            for x, y in zip(a.columns, b.columns):
                assert torch.equal(x.data, y.data)
                assert torch.equal(x.valid_mask(), y.valid_mask())
        elif isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_brackets_are_noops_without_a_handler_or_a_task():
    assert not PRES.reservations_active()
    with PRES.device_reservation(MB) as took:
        assert not took
    PR.RmmSpark.set_event_handler(pool_bytes=8 * MB, watchdog_period_s=0.01)
    assert not PRES.reservations_active()  # no task on this thread
    with PRES.device_reservation(MB) as took:
        assert not took
    assert PR.RmmSpark.pool_used() == 0


def test_nested_brackets_count_once_and_release_barrier_is_free_on_cpu():
    PR.RmmSpark.set_event_handler(pool_bytes=8 * MB, watchdog_period_s=0.01)
    PR.RmmSpark.current_thread_is_dedicated_to_task(3)
    try:
        with PRES.device_reservation(2 * MB) as outer:
            with PRES.device_reservation(3 * MB) as inner:
                assert outer and not inner
                assert PR.RmmSpark.pool_used() == 2 * MB
            t = torch.arange(5)
            assert PRES.release_barrier(t, outer) is t
        assert PR.RmmSpark.pool_used() == 0
    finally:
        PR.RmmSpark.remove_current_thread_association()
        PR.RmmSpark.task_done(3)


def test_hbm_audit_counts_brackets_and_validates_none_on_cpu():
    hbm.reset()
    PR.RmmSpark.set_event_handler(pool_bytes=8 * MB, watchdog_period_s=0.01)
    PR.RmmSpark.current_thread_is_dedicated_to_task(4)
    try:
        with pconfig.override("rmm.validate_hbm", True):
            with PRES.device_reservation(MB) as took:
                assert took
        rep = hbm.report()
        assert (rep["brackets"], rep["validated"], rep["underestimates"],
                rep["worst"]) == (1, 0, 0, [])
    finally:
        PR.RmmSpark.remove_current_thread_association()
        PR.RmmSpark.task_done(4)
        hbm.reset()


def _split_sort(R, sort_table, table, slice_col, make_table):
    """test_reservation.py's split: sort under an 8 MB pool whose 2x
    estimate cannot fit, halved until it does."""
    S = R.RmmSpark
    with_retry = j_with_retry if R is JR else p_with_retry
    S.set_event_handler(pool_bytes=8 * MB, watchdog_period_s=0.01)
    S.current_thread_is_dedicated_to_task(7)
    try:
        def split(t):
            h = t.num_rows // 2
            return [make_table(tuple(slice_col(c, 0, h) for c in t.columns)),
                    make_table(tuple(slice_col(c, h, t.num_rows)
                                     for c in t.columns))]
        pieces = with_retry(lambda t: sort_table(t, [0]), table, split=split)
        return (pieces, S.get_and_reset_num_split_retry(7), S.pool_used())
    finally:
        S.remove_current_thread_association()
        S.task_done(7)
        S.clear_event_handler()


def test_sort_table_splits_under_an_8mb_pool_as_the_jax_package():
    rows = 400_000  # 2 columns x 8 B = 6.4 MB; estimate 12.8 MB > 8 MB
    rng = np.random.default_rng(0)
    jt = JTable((JColumn.from_numpy(rng.integers(0, 50, rows), jdt.INT64),
                 JColumn.from_numpy(rng.integers(-1000, 1000, rows),
                                    jdt.INT64)))
    pt = table_to_port(jt)
    jp, jsplits, jused = _split_sort(
        JR, JS.sort_table, jt,
        lambda c, a, b: JColumn(c.dtype, b - a, data=c.data[a:b]), JTable)
    pp, psplits, pused = _split_sort(
        PR, PS.sort_table, pt,
        lambda c, a, b: Column(c.dtype, b - a, data=c.data[a:b]), Table)
    assert len(pp) == len(jp) >= 2
    assert psplits == jsplits >= 1 and pused == jused == 0
    for a, b in zip(jp, pp):
        for x, y in zip(a.columns, b.columns):
            assert_col_equal(x, y)


# ---------------------------------------------------------------------------
# Monte-Carlo stress (the reference test's invariants)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_monte_carlo_stress(seed):
    stats = PMC.run_monte_carlo(PMC.MonteCarloConfig(
        pool_mib=64, task_max_mib=48, num_tasks=8, ops_per_task=60,
        seed=seed))
    assert stats.ok, stats.to_json()
    assert stats.block_time_ns > 0 or stats.retries > 0
    assert stats.pool_leak == 0
