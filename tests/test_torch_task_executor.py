"""The port's task executor (spark_rapids_jni_tpu_torch/parallel/
task_executor.py) against the JAX package's, on the CPU, where the port's
workers have no CUDA stream: the same scenarios through both executors,
with the same results bit for bit and the same outcomes — rejections,
ladder counters, degraded task ids and drain reports.

Scenarios: the six cases of tests/test_task_executor.py (overlap,
same-task order, RmmSpark registration, error propagation, the closed
rejection, the lost worker's release); the ladder under one seeded
injector schedule (poison re-dispatch and retries, degradation after
``task.degrade_after``, a retry-OOM rolled back through a spill store);
the deadline carried across threads, a hang storm that degrades and an
uncancellable wedge re-queued (test_watchdog.py); a crash storm replayed
through the sandbox (test_crash.py); the corruption retry
(test_integrity.py); ``drain``'s report with a spill store; and the
sandbox's bridge-op group: a sandboxed op equals the op in process, and a
killed bridge worker is replayed. Where the packages differ only in
timing, the counters are compared, not the order.

Each package keeps its own executor, injector, metrics, watchdog,
sandbox and RmmSpark; all are reset around every test.
"""

import json
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_jni_tpu import bridge as jbridge
from spark_rapids_jni_tpu import faultinj as JF
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.memory import transport as JT
from spark_rapids_jni_tpu.memory.rmm_spark import RmmSpark as JRmm
from spark_rapids_jni_tpu.ops import groupby as JGB
from spark_rapids_jni_tpu.ops import parse_uri as JPU
from spark_rapids_jni_tpu.ops import sort as JS
from spark_rapids_jni_tpu.parallel.task_executor import \
    TaskExecutor as JTaskExecutor
from spark_rapids_jni_tpu.parquet import read_parquet as jread_parquet
from spark_rapids_jni_tpu.serving import AdmissionRejected as JRejected
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import bridge as pbridge
from spark_rapids_jni_tpu_torch import faultinj as PF
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_jni_tpu_torch.columnar.column import Table as PTable
from spark_rapids_jni_tpu_torch.memory import transport as PT
from spark_rapids_jni_tpu_torch.memory.rmm_spark import RmmSpark as PRmm
from spark_rapids_jni_tpu_torch.ops import groupby as PGB
from spark_rapids_jni_tpu_torch.ops import parse_uri as PPU
from spark_rapids_jni_tpu_torch.ops import sort as PS
from spark_rapids_jni_tpu_torch.parallel import TaskExecutor as PTaskExecutor
from spark_rapids_jni_tpu_torch.parquet import read_parquet as pread_parquet
from spark_rapids_jni_tpu_torch.serving import AdmissionRejected as PRejected
from spark_rapids_jni_tpu_torch.utils import config as pconfig

MB = 1 << 20


def _cpu(fn):
    def call(*a, **kw):
        return fn(*a, device="cpu", **kw)
    return call


PKGS = {
    "jax": dict(F=JF, C=jconfig, R=JRmm, T=JT, GB=JGB, S=JS, PU=JPU,
                B=jbridge, X=JTaskExecutor, Rej=JRejected,
                read=jread_parquet, table=JTable,
                col=lambda v, d: JColumn.from_numpy(np.asarray(v), d),
                strings=lambda v: JColumn.from_pylist(v, jdt.STRING),
                dt=jdt, call=jbridge.call),
    "port": dict(F=PF, C=pconfig, R=PRmm, T=PT, GB=PGB, S=PS, PU=PPU,
                 B=pbridge, X=_cpu(PTaskExecutor), Rej=PRejected,
                 read=_cpu(pread_parquet), table=PTable,
                 col=lambda v, d: PColumn.from_numpy(np.asarray(v), d,
                                                     device="cpu"),
                 strings=lambda v: PColumn.from_pylist(v, pdt.STRING,
                                                       device="cpu"),
                 dt=pdt, call=_cpu(pbridge.call)),
}
FAST = {"faultinj.backoff_base_s": 0.0002, "faultinj.backoff_max_s": 0.002,
        "watchdog.poll_period_s": 0.02}


def _reset(p):
    F = p["F"]
    F.uninstall()
    F.sandbox.shutdown_all()
    F.sandbox.reset_quarantine()
    F.breaker.reset_all()
    F.watchdog.reset()
    p["R"].clear_event_handler()
    p["R"].reset_fault_domain_metrics()


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS.values():
        _reset(p)
    yield
    for p in PKGS.values():
        _reset(p)


def _overrides(C, **kv):
    import contextlib
    stack = contextlib.ExitStack()
    for k, v in {**FAST, **kv}.items():
        stack.enter_context(C.override(k.replace("__", "."), v))
    return stack


def _metrics(p, keys):
    m = p["R"].get_fault_domain_metrics()
    return {k: m[k] for k in keys}


def _rows(table):
    return [c.to_pylist() for c in table.columns]


def _table(p, rows, seed):
    rng = np.random.default_rng(seed)
    d = p["dt"]
    return p["table"]((p["col"](rng.integers(0, 97, rows), d.INT64),
                       p["col"](rng.integers(-10**6, 10**6, rows), d.INT64)))


def _write(tmp_path, name, cfg):
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return str(path)


def _both(fn, *a, **kw):
    """``fn`` run through each package, its injector removed after."""
    out = {}
    for name, p in PKGS.items():
        try:
            out[name] = fn(p, *a, **kw)
        finally:
            p["F"].uninstall()
    return out


# ---------------------------------------------------------------------------
# tests/test_task_executor.py's six cases
# ---------------------------------------------------------------------------

def _overlap(p):
    """Two tasks meet at a barrier inside their bodies: sequential
    execution cannot pass it. Each then sorts and aggregates its table."""
    meet = threading.Barrier(2)

    def op(table):
        meet.wait(timeout=20)
        return _rows(p["GB"].groupby_aggregate(
            p["S"].sort_table(table, [0]), [0], [(1, "sum")]))

    with p["X"]() as ex:
        f1 = ex.submit(1, op, _table(p, 2048, 0))
        f2 = ex.submit(2, op, _table(p, 2048, 10))
        return f1.result(timeout=60), f2.result(timeout=60)


def test_two_tasks_overlap_in_time():
    got = _both(_overlap)
    assert got["port"] == got["jax"]


def _order(p):
    order = []

    def op(i):
        time.sleep(0.002 if i % 2 == 0 else 0.0)
        order.append(i)
        return i

    with p["X"]() as ex:
        futs = [ex.submit(5, op, i) for i in range(16)]
        results = [f.result(timeout=30) for f in futs]
    return results, order


def test_same_task_preserves_submission_order():
    got = _both(_order)
    assert got["port"] == got["jax"] == (list(range(16)), list(range(16)))


def _registered(p):
    R = p["R"]
    R.set_event_handler(pool_bytes=64 * MB, watchdog_period_s=0.02)
    try:
        with p["X"]() as ex:
            f1 = ex.submit(11, p["S"].sort_table, _table(p, 4096, 0), [0])
            f2 = ex.submit(12, p["S"].sort_table, _table(p, 4096, 1), [0])
            out = (_rows(f1.result(timeout=60)), _rows(f2.result(timeout=60)))
            reserved = (R.get_and_reset_max_device_reserved(11),
                        R.get_and_reset_max_device_reserved(12))
            ex.task_done(11)
            ex.task_done(12)
        return out, reserved, R.pool_used()
    finally:
        R.clear_event_handler()


def test_workers_are_governed_by_rmm_spark():
    got = _both(_registered)
    assert got["port"] == got["jax"]
    _, reserved, used = got["port"]
    assert min(reserved) > 0 and used == 0


def _error(p):
    def boom():
        raise ValueError("op failed")

    with p["X"]() as ex:
        f = ex.submit(3, boom)
        with pytest.raises(ValueError, match="op failed"):
            f.result(timeout=30)
        return ex.submit(3, lambda: 42).result(timeout=30)


def test_error_propagates_and_executor_survives():
    assert _both(_error) == {"jax": 42, "port": 42}


def _closed(p):
    ex = p["X"]()
    ex.close()
    with pytest.raises(p["Rej"], match="closed") as ei:
        ex.submit(1, lambda: 1)
    e = ei.value
    return (type(e).__name__, e.reason, e.retry_after_s, str(e),
            isinstance(e, RuntimeError), ex.last_drain["already_closed"])


def test_closed_executor_rejects_submits():
    got = _both(_closed)
    assert got["port"] == got["jax"]
    assert got["port"][1] == "closed" and got["port"][4]


def _lost_release(p):
    R = p["R"]
    tids = []

    def wedge():
        tids.append(R.get_current_thread_id())
        if len(tids) == 1:
            time.sleep(1.0)  # deaf to the cancel token on purpose
            return "wedged"
        return "recovered"

    R.set_event_handler(pool_bytes=64 * MB, watchdog_period_s=0.02)
    try:
        with _overrides(p["C"], task__budget_s=0.2,
                        watchdog__lost_after_s=0.2, task__retry_budget=3), \
                p["X"]() as ex:
            out = ex.submit(21, wedge).result(timeout=30)
            # the wedged thread still sleeps, its association already gone
            state = R.get_state_of(tids[0])
            degraded = ex.degraded_task_ids()
    finally:
        R.clear_event_handler()
    return out, state, degraded, _metrics(p, ("workers_lost",))


def test_lost_worker_releases_rmm_thread_association():
    got = _both(_lost_release)
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ("recovered", -1, [21])


# ---------------------------------------------------------------------------
# the ladder under one seeded injector schedule
# ---------------------------------------------------------------------------

LADDER = ("guarded_calls", "injected_faults", "poisoned_programs",
          "redispatches", "degradations", "task_retries", "injected_ooms",
          "stall_detected", "stall_cancelled", "injected_delays",
          "injected_crashes", "crash_detected", "worker_respawns",
          "corruption_detected", "quarantined_buffers", "drains")


def _murmur(p, n=256):
    col = p["col"](np.arange(n, dtype=np.int64), p["dt"].INT64)
    return p["call"]("hash.murmur3", json.dumps({"seed": 42}),
                     [p["B"].col_to_wire(col)])


def _seeded_ladder(p, tmp_path):
    """Task 1 hashes through the bridge under an 85% trap rule: some
    submissions re-dispatch in the guard, some poison and retry, and two
    consecutive poisons degrade the task. Task 2 then meets two retry
    OOMs, each rolled back through the spill store."""
    F = p["F"]
    F.install(_write(tmp_path, f"{id(p)}.json", {"xlaRuntimeFaults": {
        "hash.murmur3": {"percent": 85, "injectionType": 0,
                         "interceptionCount": 40},
        "oom_site": {"percent": 100, "injectionType": 6,
                     "interceptionCount": 2}}}), seed=0)
    store = p["T"].SpillStore()
    st = store.register(_table(p, 64, 3))

    def with_oom():
        F.fault_point("oom_site")
        return st.is_spilled

    with _overrides(p["C"], task__retry_budget=4, task__degrade_after=2), \
            p["X"](spill_store=store) as ex:
        outs = []
        for _ in range(6):
            try:
                outs.append(ex.submit(1, _murmur, p).result(timeout=60))
            except BaseException as e:  # noqa: BLE001 — an outcome
                outs.append(type(e).__name__)
        degraded = ex.degraded_task_ids()
        spilled = ex.submit(2, with_oom).result(timeout=60)
    return outs, degraded, spilled, _metrics(p, LADDER)


def test_ladder_under_a_seeded_schedule(tmp_path):
    got = _both(_seeded_ladder, tmp_path)
    assert got["port"] == got["jax"]
    outs, degraded, spilled, m = got["port"]
    assert degraded == [1] and m["degradations"] == 1
    assert m["poisoned_programs"] > m["redispatches"] > 0
    assert spilled and m["injected_ooms"] == 2
    clean = _murmur(PKGS["port"])
    assert all(o == clean for o in outs)


def _degrade_after(p, tmp_path):
    """An unbounded trap: every attempt poisons, the second degrades the
    task, and the degraded attempt (injection suppressed) succeeds."""
    p["F"].install(_write(tmp_path, f"t{id(p)}.json", {"xlaRuntimeFaults": {
        "hash.murmur3": {"percent": 100, "injectionType": 0,
                         "interceptionCount": 10_000}}}), seed=0)
    with _overrides(p["C"], task__retry_budget=4, task__degrade_after=2), \
            p["X"]() as ex:
        out = ex.submit(4, _murmur, p).result(timeout=60)
        other = ex.submit(5, lambda: 7).result(timeout=30)
        return out, other, ex.degraded_task_ids(), _metrics(p, LADDER)


def test_degradation_after_degrade_after(tmp_path):
    got = _both(_degrade_after, tmp_path)
    assert got["port"] == got["jax"]
    out, other, degraded, m = got["port"]
    assert out == _murmur(PKGS["port"]) and other == 7
    assert degraded == [4]  # task 5 shares the process, not the downgrade
    assert (m["degradations"], m["task_retries"], m["poisoned_programs"],
            m["redispatches"]) == (1, 1, 6, 4)


# ---------------------------------------------------------------------------
# deadlines, stalls and lost workers (test_watchdog.py)
# ---------------------------------------------------------------------------

def _deadline_carried(p):
    W = p["F"].watchdog

    def body():
        dl = W.current_deadline()
        return None if dl is None else (dl.expires_at, dl.token)

    with p["X"]() as ex:
        with W.Deadline(30.0, "stage") as dl:
            got = ex.submit(1, body).result(timeout=30)
            want = (dl.expires_at, dl.token)
        bare = ex.submit(1, body).result(timeout=30)
    return got == want, bare


def test_deadline_is_carried_across_threads():
    assert _both(_deadline_carried) == {"jax": (True, None),
                                        "port": (True, None)}


def _hang_storm(p, tmp_path):
    p["F"].install(_write(tmp_path, f"h{id(p)}.json", {"xlaRuntimeFaults": {
        "hash.murmur3": {"percent": 100, "injectionType": 4, "delayMs": -1,
                         "interceptionCount": 10_000}}}), seed=0)
    with _overrides(p["C"], task__budget_s=0.3, task__retry_budget=6,
                    task__degrade_after=2), p["X"]() as ex:
        out = ex.submit(1, _murmur, p).result(timeout=60)
        degraded = ex.degraded_task_ids()
    m = _metrics(p, LADDER)
    # a degraded attempt that outlives its budget on a loaded host is one
    # more stall detected (timing, not the ladder): compared apart
    stalls = (m.pop("stall_detected"), m.pop("stall_cancelled"))
    return (out, degraded, m), stalls


def test_hang_storm_unbounded_degrades_to_host_path(tmp_path):
    got = _both(_hang_storm, tmp_path)
    assert got["port"][0] == got["jax"][0]
    (out, degraded, m), _ = got["port"]
    assert out == _murmur(PKGS["port"]) and degraded == [1]
    assert (m["injected_delays"], m["degradations"]) == (2, 1)
    for name, (_, (detected, cancelled)) in got.items():
        assert detected >= 2 and cancelled >= 2, name


def _wedge_requeued(p):
    calls = []

    def body():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(1.0)  # deaf to the cancel token on purpose
            return "first"
        return "recovered"

    with _overrides(p["C"], task__budget_s=0.2, watchdog__lost_after_s=0.2,
                    task__retry_budget=3, task__degrade_after=0), \
            p["X"]() as ex:
        out = ex.submit(7, body).result(timeout=30)
        degraded = ex.degraded_task_ids()
    return out, degraded, _metrics(p, ("stall_detected", "stall_cancelled",
                                       "workers_lost"))


def test_uncancellable_wedge_declares_worker_lost_and_requeues():
    got = _both(_wedge_requeued)
    assert got["port"] == got["jax"]
    assert got["port"] == ("recovered", [7], {
        "stall_detected": 1, "stall_cancelled": 1, "workers_lost": 1})


# ---------------------------------------------------------------------------
# crashes, corruption, drain
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def crash_file(tmp_path_factory):
    rng = np.random.default_rng(11)
    table = pa.table({"v": pa.array(rng.integers(-10**9, 10**9, 4000),
                                    pa.int64())})
    path = str(tmp_path_factory.mktemp("crash") / "crash.parquet")
    pq.write_table(table, path, write_page_checksum=True,
                   compression="snappy")
    return path, table.column("v").to_pylist()


URLS = [f"https://host{i}.example.com:80{i % 10}/p/{i}?q={i}"
        for i in range(64)]


def _crash_storm(p, tmp_path, path):
    p["F"].install(_write(tmp_path, f"c{id(p)}.json", {"xlaRuntimeFaults": {
        api: {"percent": 100, "injectionType": 5, "interceptionCount": 2,
              "crashMode": "kill"}
        for api in ("parquet_page_decode", "parse_uri")}}), seed=0)
    col = p["strings"](URLS)
    with p["C"].override("sandbox.enabled", True), p["X"]() as ex:
        f_pq = ex.submit(1, p["read"], path)
        f_uri = ex.submit(2, p["PU"].parse_uri_to_host, col)
        got = (f_pq.result(timeout=60)[0].to_pylist(),
               f_uri.result(timeout=60).to_pylist())
        alive = ex.submit(3, lambda: 42).result(timeout=30)
        verdict = ex.drain()
    keep = ("clean", "already_closed", "stragglers", "lost_workers")
    return (got, alive, {k: verdict[k] for k in keep},
            _metrics(p, ("injected_crashes", "crash_detected",
                         "worker_respawns", "task_retries", "drains")))


def test_crash_storm_replays_bit_identical_and_drains_clean(tmp_path,
                                                            crash_file):
    path, want = crash_file
    got = _both(_crash_storm, tmp_path, path)
    assert got["port"] == got["jax"]
    (col, hosts), alive, verdict, m = got["port"]
    assert col == want and alive == 42 and verdict["clean"]
    assert hosts == [f"host{i}.example.com" for i in range(64)]
    assert m["injected_crashes"] == m["crash_detected"] == 4
    assert m["worker_respawns"] == 4 and m["task_retries"] >= 4


def _bridge_crash(p, tmp_path):
    """The sandbox's bridge-op group: the first worker is killed before it
    answers, the executor replays the submission on a fresh worker, whose
    wire result equals the op in process."""
    clean = _murmur(p)
    p["F"].install(_write(tmp_path, f"b{id(p)}.json", {"xlaRuntimeFaults": {
        "hash.murmur3": {"percent": 100, "injectionType": 5,
                         "interceptionCount": 1, "crashMode": "kill"}}}),
        seed=0)
    with p["C"].override("sandbox.enabled", True), \
            p["C"].override("sandbox.bridge_ops", "hash.murmur3"), \
            p["X"]() as ex:
        stormed = ex.submit(1, _murmur, p).result(timeout=120)
        again = _murmur(p)  # the respawned worker, reused
    return (stormed == clean, again == clean, clean,
            _metrics(p, ("injected_crashes", "crash_detected",
                         "worker_respawns", "task_retries")))


def test_bridge_op_group_replays_a_killed_worker(tmp_path):
    """The port's bridge worker against the JAX package's op in process
    (its own bridge worker, which imports JAX, costs seconds more and
    keeps the same counters: tests/test_crash.py)."""
    try:
        got = _bridge_crash(PKGS["port"], tmp_path)
    finally:
        PF.uninstall()
    assert got[:3] == (True, True, _murmur(PKGS["jax"]))
    assert got[3] == {"injected_crashes": 1, "crash_detected": 1,
                      "worker_respawns": 1, "task_retries": 1}


def _corruption(p, tmp_path):
    p["F"].install(_write(tmp_path, f"f{id(p)}.json", {"xlaRuntimeFaults": {
        "unspill": {"percent": 100, "injectionType": 3,
                    "interceptionCount": 1}}}), seed=0)

    def op():
        st = p["T"].SpillableTable(_table(p, 256, 5))  # from source
        st.spill()
        return _rows(st.get())

    with p["C"].override("task.retry_budget", 3), \
            p["X"](mark_tasks_done=False) as ex:
        out = ex.submit(1, op).result(timeout=60)
    return out, _metrics(p, ("corruption_detected", "quarantined_buffers",
                             "task_retries"))


def test_task_executor_retries_corruption(tmp_path):
    got = _both(_corruption, tmp_path)
    assert got["port"] == got["jax"]
    assert got["port"][0] == _rows(_table(PKGS["port"], 256, 5))
    assert got["port"][1] == {"corruption_detected": 1,
                              "quarantined_buffers": 1, "task_retries": 1}


def _drain(p, tmp_path):
    store = p["T"].SpillStore(disk_dir=str(tmp_path / f"d{id(p)}"),
                              host_limit_bytes=0)
    ex = p["X"](spill_store=store)
    sts = [store.register(_table(p, 128, s)) for s in range(3)]
    outs = [ex.submit(t, lambda s=s: _rows(s.get())).result(timeout=30)
            for t, s in enumerate(sts)]
    verdict = ex.drain()
    second = ex.drain()
    drop = ("elapsed_s",)
    return (outs, {k: v for k, v in verdict.items() if k not in drop},
            {k: v for k, v in second.items() if k not in drop},
            [s.is_on_disk for s in sts])


def test_drain_report_with_a_spill_store(tmp_path):
    got = _both(_drain, tmp_path)
    assert got["port"] == got["jax"]
    _, verdict, second, on_disk = got["port"]
    assert verdict["clean"] and verdict["tasks_completed"] == 3
    assert not verdict["already_closed"] and second["already_closed"]
    assert on_disk == [True] * 3


def test_task_done_timeout_marks_at_close(monkeypatch):
    """A worker still inside its op outlives task_done's join: the task is
    marked done only once close() has joined it (both packages)."""
    for name, p in PKGS.items():
        R = p["R"]
        marked = []
        monkeypatch.setattr(R, "is_installed", classmethod(lambda c: True))
        monkeypatch.setattr(R, "task_done",
                            classmethod(lambda c, tid: marked.append(tid)))
        monkeypatch.setattr(
            R, "current_thread_is_dedicated_to_task",
            classmethod(lambda c, tid: (_ for _ in ()).throw(
                RuntimeError())))
        gate = threading.Event()
        ex = p["X"]()
        fut = ex.submit(7, gate.wait)
        ex.task_done(7, timeout=0.05)
        assert marked == [], name
        gate.set()
        fut.result(timeout=10)
        ex.close(timeout=10)
        assert marked == [7], name
        monkeypatch.undo()


def test_cpu_workers_have_no_stream():
    with PTaskExecutor(device="cpu") as ex:
        ex.submit(1, lambda: None).result(timeout=30)
        ex.submit(2, lambda: None).result(timeout=30)
        assert ex.task_streams() == {1: None, 2: None}
