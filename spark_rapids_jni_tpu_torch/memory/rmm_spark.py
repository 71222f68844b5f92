"""RmmSpark-equivalent facade over the native resource adaptor (the JAX
package's memory/rmm_spark.py, a faithful copy: there is no device code in
it, and the native adaptor is the same C++ source, built for this package
by memory/native.py).

Reference surface: RmmSpark.java (static facade: thread/task registration
:131-236, retry-block bracketing :242-274, blockThreadUntilReady :417-428,
OOM injection :435-515, per-task metrics :533-590, CPU alloc hooks :601-664)
plus SparkResourceAdaptor.java (owns the native handle and a 100 ms watchdog
daemon calling checkAndBreakDeadlocks, :35-79).

Adaptation, as in the JAX package: the "RMM pool" is a device-memory
*reservation* budget. Device work is bracketed by ``alloc(bytes)`` /
``dealloc(bytes)`` reservations taken before the op's kernels launch
(memory/reservation.py); the CUDA caching allocator's own mallocs are not
intercepted per buffer the way RMM intercepts cudaMalloc, and
memory/hbm.py audits the estimates against its counters. The state
machine, priorities, BUFN and split-and-retry escalation behave as in the
reference.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import weakref
from typing import Callable, Dict, Optional, Tuple

from . import native
from .exceptions import (
    RM_INJECTED_EXCEPTION,
    RM_OK,
    RM_RETRY_OOM,
    RM_SPLIT_AND_RETRY_OOM,
    raise_for_status,
)


class ThreadState:
    """Java mirror: RmmSparkThreadState.java:23-34."""
    UNKNOWN = -1
    RUNNING = 0
    ALLOC = 1
    ALLOC_FREE = 2
    BLOCKED = 3
    BUFN_THROW = 4
    BUFN_WAIT = 5
    BUFN = 6
    SPLIT_THROW = 7
    REMOVE_THROW = 8

    _NAMES = {
        -1: "UNKNOWN", 0: "RUNNING", 1: "ALLOC", 2: "ALLOC_FREE",
        3: "BLOCKED", 4: "BUFN_THROW", 5: "BUFN_WAIT", 6: "BUFN",
        7: "SPLIT_THROW", 8: "REMOVE_THROW",
    }

    @classmethod
    def name(cls, v: int) -> str:
        return cls._NAMES.get(v, "UNKNOWN")


# metric selectors shared with the native side (rm_get_metric)
_METRIC_RETRY = 0
_METRIC_SPLIT_RETRY = 1
_METRIC_BLOCK_TIME = 2
_METRIC_LOST_TIME = 3
_METRIC_MAX_RESERVED = 4

# oom_mode bits for injection
OOM_MODE_TPU = 1
OOM_MODE_CPU = 2


class ThreadStateRegistry:
    """Engine-thread-id → python Thread map consulted by the native deadlock
    sweep (reference ThreadStateRegistry.java:33-66 +
    SparkResourceAdaptorJni.cpp:1498-1500).

    The detector's "all task threads blocked" predicate counts threads the
    state machine sees as RUNNING but that are actually OS-blocked for
    non-memory reasons (I/O, locks, pool waits) — without this, one task
    thread stuck in a lock while holding reservations stalls BUFN/SPLIT
    escalation forever.

    Java reads Thread.getState(); CPython has no equivalent, so blockedness
    is inferred from the thread's current innermost frame: well-known
    blocking callables (lock/event waits, queue gets, selectors, socket
    reads, sleeps) or frames inside the threading/queue/selectors modules.
    A dead thread is blocked ("dead is as good as blocked", ref :46-48).
    Unlike the reference, an *unknown* id reports NOT blocked: the facade
    registers every thread it names (get_current_thread_id), so unknown ids
    here are external callers (tests, jvm_sim) whose escalation semantics
    must not change underneath them.

    Known false-negative class: a thread blocked in a C-level primitive
    called directly from *user* code (e.g. a bare ``lock.acquire()`` in a
    task function) shows the caller's own module as its innermost frame, so
    module-based detection misses it and the deadlock sweep may stall
    waiting on it. Conversely a thread actively *executing* python code
    inside queue/socket/etc. counts blocked. Task code holding reservations
    around a known-blocking section should wrap it in :meth:`mark_blocked`
    to make blockedness explicit and exact.
    """

    _by_tid: Dict[int, "weakref.ref"] = {}
    _marked_blocked: Dict[int, int] = {}  # tid -> nesting depth
    _lock = threading.Lock()

    # Module-based detection only: blocking *C* primitives (lock.acquire,
    # socket.recv, time.sleep) never appear as python frame names — the
    # innermost python frame is their *caller* — so a bare-name list would
    # only ever match ordinary running functions that happen to share a
    # name ("get", "read", ...), i.e. pure false positives. The python-level
    # blocking wrappers that DO frame (Event.wait, Condition.wait,
    # Queue.get, selector loops, executor waits) all live in these modules.
    _BLOCKING_MODULES = frozenset({
        "threading", "queue", "selectors", "select", "socket",
        "concurrent.futures._base", "concurrent.futures.thread",
    })

    @classmethod
    def add_thread(cls, tid: int, thread: threading.Thread) -> None:
        with cls._lock:
            cls._by_tid[tid] = weakref.ref(thread)
            # opportunistic prune: tids are never reused, so dead-thread
            # entries would otherwise accumulate for the process lifetime
            dead = [k for k, r in cls._by_tid.items() if r() is None]
            for k in dead:
                del cls._by_tid[k]

    @classmethod
    def remove_thread(cls, tid: int) -> None:
        with cls._lock:
            cls._by_tid.pop(tid, None)

    @classmethod
    @contextlib.contextmanager
    def mark_blocked(cls, tid: int):
        """Explicitly mark `tid` blocked for the duration of a with-block.

        Closes the frame heuristic's false-negative class: task code about
        to block in a C primitive invisible to frame inspection (a bare
        ``lock.acquire()``, a C-extension wait) wraps the section so the
        deadlock sweep sees it as blocked immediately and exactly.
        Re-entrant (nesting depth counted)."""
        with cls._lock:
            cls._marked_blocked[tid] = cls._marked_blocked.get(tid, 0) + 1
        try:
            yield
        finally:
            with cls._lock:
                d = cls._marked_blocked.get(tid, 1) - 1
                if d <= 0:
                    cls._marked_blocked.pop(tid, None)
                else:
                    cls._marked_blocked[tid] = d

    @classmethod
    def is_thread_blocked(cls, tid: int) -> bool:
        with cls._lock:
            if cls._marked_blocked.get(tid, 0) > 0:
                return True
            ref = cls._by_tid.get(tid)
        if ref is None:
            return False  # unknown: external caller, stay out of its way
        th = ref()
        if th is None or not th.is_alive():
            return True
        import sys
        frame = sys._current_frames().get(th.ident)
        if frame is None:
            return True
        return frame.f_globals.get("__name__", "") in cls._BLOCKING_MODULES

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._by_tid.clear()
            cls._marked_blocked.clear()


# module-level so the callback object outlives any single adaptor and the
# native side never holds a dangling function pointer
_EXT_BLOCKED_CB = native.EXT_BLOCKED_CB(
    lambda tid: 1 if ThreadStateRegistry.is_thread_blocked(int(tid)) else 0)


class SparkResourceAdaptor:
    """Owns the native adaptor handle and the deadlock watchdog daemon.

    Reference: SparkResourceAdaptor.java:35-79 — the watchdog polls
    checkAndBreakDeadlocks every 100 ms (system property
    ``ai.rapids.cudf.spark.rmmWatchdogPollingPeriod``); here the period is the
    ``watchdog_period_s`` constructor arg.
    """

    def __init__(self, pool_bytes: int, log_loc: Optional[str] = None,
                 watchdog_period_s: Optional[float] = None):
        if watchdog_period_s is None:
            from ..utils import config
            watchdog_period_s = float(config.get("rmm.watchdog_period_s"))
        self._lib = native.load()
        self.pool_bytes = int(pool_bytes)   # capacity, for pressure ratios
        loc = (log_loc or "").encode()
        self._handle = self._lib.rm_create(pool_bytes, loc)
        if not self._handle:
            raise RuntimeError("failed to create native resource adaptor")
        self._lib.rm_set_external_blocked_cb(self._handle, _EXT_BLOCKED_CB)
        self._closed = threading.Event()
        self._watchdog = threading.Thread(
            target=self._watch, args=(watchdog_period_s,),
            name="rmm-spark-watchdog", daemon=True)
        self._watchdog.start()

    def _watch(self, period: float) -> None:
        while not self._closed.wait(period):
            h = self._handle
            if h:
                self._lib.rm_check_and_break_deadlocks(h)

    def close(self) -> None:
        self._closed.set()
        # join without a timeout: the wait-loop exits promptly once _closed is
        # set, and destroying the handle while the watchdog may still be inside
        # rm_check_and_break_deadlocks would be a use-after-free
        if self._watchdog is not threading.current_thread():
            self._watchdog.join()
        h, self._handle = self._handle, None
        if h:
            self._lib.rm_destroy(h)

    # -- thin checked wrappers ------------------------------------------------

    def _ck(self, code: int, what: str) -> None:
        raise_for_status(code, what)

    def start_dedicated_task_thread(self, tid: int, task_id: int) -> None:
        self._ck(self._lib.rm_start_dedicated_task_thread(
            self._handle, tid, task_id), "start_dedicated_task_thread")

    def pool_thread_working_on_task(self, tid: int, task_id: int) -> None:
        self._ck(self._lib.rm_pool_thread_working_on_task(
            self._handle, tid, task_id), "pool_thread_working_on_task")

    def pool_thread_finished_for_tasks(self, tid: int, task_ids) -> None:
        arr = (ctypes.c_long * len(task_ids))(*task_ids)
        self._ck(self._lib.rm_pool_thread_finished_for_tasks(
            self._handle, tid, arr, len(task_ids)),
            "pool_thread_finished_for_tasks")

    def start_shuffle_thread(self, tid: int) -> None:
        self._ck(self._lib.rm_start_shuffle_thread(self._handle, tid),
                 "start_shuffle_thread")

    def remove_thread_association(self, tid: int, task_id: int = -1) -> None:
        self._ck(self._lib.rm_remove_thread_association(
            self._handle, tid, task_id), "remove_thread_association")

    def task_done(self, task_id: int) -> None:
        self._ck(self._lib.rm_task_done(self._handle, task_id), "task_done")

    def alloc(self, tid: int, nbytes: int) -> None:
        self._ck(self._lib.rm_alloc(self._handle, tid, nbytes),
                 f"device reservation of {nbytes} bytes")

    def dealloc(self, tid: int, nbytes: int) -> None:
        self._ck(self._lib.rm_dealloc(self._handle, tid, nbytes), "dealloc")

    def block_thread_until_ready(self, tid: int) -> None:
        self._ck(self._lib.rm_block_thread_until_ready(self._handle, tid),
                 "block_thread_until_ready")

    def get_state_of(self, tid: int) -> int:
        return self._lib.rm_get_state_of(self._handle, tid)

    def pool_used(self) -> int:
        return self._lib.rm_pool_used(self._handle)


class RmmSpark:
    """Static facade (reference RmmSpark.java). One process-wide adaptor."""

    _adaptor: Optional[SparkResourceAdaptor] = None
    _lock = threading.Lock()
    _tid_counter = 0
    _tid_map: Dict[int, tuple] = {}  # ident -> (weakref to Thread, tid)

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def set_event_handler(cls, pool_bytes: Optional[int] = None,
                          log_loc: Optional[str] = None,
                          watchdog_period_s: Optional[float] = None) -> None:
        """Install the adaptor (reference RmmSpark.setEventHandler :59-116).
        ``pool_bytes`` defaults to the ``rmm.pool_bytes`` config flag."""
        if pool_bytes is None:
            from ..utils import config
            pool_bytes = int(config.get("rmm.pool_bytes"))
            if pool_bytes <= 0:
                raise ValueError(
                    "pool_bytes not given and rmm.pool_bytes config unset")
        with cls._lock:
            if cls._adaptor is not None:
                raise RuntimeError("event handler already installed")
            cls._adaptor = SparkResourceAdaptor(
                pool_bytes, log_loc, watchdog_period_s)

    @classmethod
    def is_installed(cls) -> bool:
        """True when an event handler (adaptor) is installed — the public
        predicate for optional-governance callers (reservation brackets,
        TaskExecutor)."""
        return cls._adaptor is not None

    @classmethod
    def clear_event_handler(cls) -> None:
        # pop the adaptor under the lock, close it outside: close() joins
        # the rmm watchdog thread, and holding cls._lock across that join
        # would wedge every thread-registration call until the watchdog
        # exits (srjt-race SRJTR02)
        with cls._lock:
            adaptor, cls._adaptor = cls._adaptor, None
            cls._tid_map.clear()
        if adaptor is not None:
            adaptor.close()

    @classmethod
    def _adp(cls) -> SparkResourceAdaptor:
        a = cls._adaptor
        if a is None:
            raise RuntimeError("RmmSpark event handler is not installed")
        return a

    @classmethod
    def get_current_thread_id(cls) -> int:
        """Stable small id for the current python thread (the reference uses
        the native OS thread id, RmmSpark.getCurrentThreadId).

        CPython reuses ``get_ident`` values after thread death, so entries are
        keyed to the current ``Thread`` object (held weakly): a fresh thread
        that inherits a dead thread's ident gets a fresh id rather than the
        dead thread's native state.
        """
        ident = threading.get_ident()
        cur = threading.current_thread()
        with cls._lock:
            entry = cls._tid_map.get(ident)
            if entry is not None:
                ref, tid = entry
                if ref() is cur:
                    return tid
            cls._tid_counter += 1
            tid = cls._tid_counter
            cls._tid_map[ident] = (weakref.ref(cur), tid)
            ThreadStateRegistry.add_thread(tid, cur)
            # Opportunistically drop entries whose threads died.
            dead = [k for k, (r, _) in cls._tid_map.items() if r() is None]
            for k in dead:
                del cls._tid_map[k]
            return tid

    # -- registration (reference RmmSpark.java:131-236) ----------------------

    @classmethod
    def current_thread_is_dedicated_to_task(cls, task_id: int) -> None:
        cls._adp().start_dedicated_task_thread(
            cls.get_current_thread_id(), task_id)

    @classmethod
    def shuffle_thread_working_on_tasks(cls, task_ids) -> None:
        tid = cls.get_current_thread_id()
        cls._adp().start_shuffle_thread(tid)
        for t in task_ids:
            cls._adp().pool_thread_working_on_task(tid, t)

    @classmethod
    def pool_thread_working_on_task(cls, task_id: int) -> None:
        cls._adp().pool_thread_working_on_task(
            cls.get_current_thread_id(), task_id)

    @classmethod
    def pool_thread_finished_for_tasks(cls, task_ids) -> None:
        cls._adp().pool_thread_finished_for_tasks(
            cls.get_current_thread_id(), list(task_ids))

    @classmethod
    def remove_current_thread_association(cls, task_id: int = -1) -> None:
        cls._adp().remove_thread_association(
            cls.get_current_thread_id(), task_id)

    @classmethod
    def thread_id_of(cls, thread: threading.Thread) -> Optional[int]:
        """Registered tid of another python thread, or None when it never
        registered. Keyed to the Thread OBJECT (same aliasing guard as
        ``get_current_thread_id``): a fresh thread that inherited a dead
        thread's ident is not that thread."""
        ident = thread.ident
        if ident is None:
            return None
        with cls._lock:
            entry = cls._tid_map.get(ident)
            if entry is None:
                return None
            ref, tid = entry
            return tid if ref() is thread else None

    @classmethod
    def remove_thread_association_for(cls, thread: threading.Thread,
                                      task_id: int = -1) -> bool:
        """Release ANOTHER thread's association (the lost-worker path: a
        thread the watchdog declared lost never runs its own cleanup, and
        the native deadlock sweep would count its tid as BLOCKED forever).
        Safe against the thread waking later — the adaptor treats removal
        of an unknown tid as a no-op. Returns False when the thread never
        registered."""
        tid = cls.thread_id_of(thread)
        if tid is None:
            return False
        cls._adp().remove_thread_association(tid, task_id)
        return True

    @classmethod
    def task_done(cls, task_id: int) -> None:
        cls._adp().task_done(task_id)

    # -- device reservations -------------------------------------------------

    @classmethod
    def alloc(cls, nbytes: int) -> None:
        tid = cls.get_current_thread_id()
        cls._adp().alloc(tid, nbytes)
        cls._track(tid, nbytes)

    @classmethod
    def dealloc(cls, nbytes: int) -> None:
        tid = cls.get_current_thread_id()
        cls._adp().dealloc(tid, nbytes)
        cls._track(tid, -nbytes)

    # -- per-thread reservation ledger (serving tenancy) ---------------------

    # Python-side mirror of the adaptor's per-thread accounting: the serving
    # tier attributes each dispatch thread's live reservation bytes to the
    # tenant whose query runs on it (serving/sessions.py binds thread ->
    # tenant for the duration of a dispatch). A dedicated lock, never held
    # across the listener call, keeps this off the adaptor lock graph.
    _ledger_lock = threading.Lock()
    _thread_reserved: Dict[int, int] = {}
    _alloc_listener: Optional[Callable[[int, int], None]] = None

    @classmethod
    def _track(cls, tid: int, delta: int) -> None:
        with cls._ledger_lock:
            now = cls._thread_reserved.get(tid, 0) + delta
            if now <= 0:
                cls._thread_reserved.pop(tid, None)
            else:
                cls._thread_reserved[tid] = now
            listener = cls._alloc_listener
        if listener is not None:
            listener(tid, delta)

    @classmethod
    def thread_reserved_bytes(cls, tid: Optional[int] = None) -> int:
        """Live reservation bytes attributed to ``tid`` (default: the
        calling thread) — 0 for threads with no open bracket."""
        if tid is None:
            tid = cls.get_current_thread_id()
        with cls._ledger_lock:
            return cls._thread_reserved.get(tid, 0)

    @classmethod
    def set_alloc_listener(
            cls, cb: Optional[Callable[[int, int], None]]) -> None:
        """Install (or clear, with None) the single allocation listener:
        called as ``cb(tid, delta_bytes)`` after every tracked alloc or
        dealloc, outside the ledger lock. Serving sessions use this to
        charge observed per-thread reservations to the owning tenant."""
        with cls._ledger_lock:
            cls._alloc_listener = cb

    @classmethod
    def block_thread_until_ready(cls) -> None:
        """Reference RmmSpark.blockThreadUntilReady :417-428 — called after a
        retry-OOM rollback, before resuming work."""
        cls._adp().block_thread_until_ready(cls.get_current_thread_id())

    # -- retry-block bracketing (reference :242-274) -------------------------

    @classmethod
    def start_retry_block(cls, tid: Optional[int] = None) -> None:
        a = cls._adp()
        raise_for_status(a._lib.rm_start_retry_block(
            a._handle, tid if tid is not None else cls.get_current_thread_id()),
            "start_retry_block")

    @classmethod
    def end_retry_block(cls, tid: Optional[int] = None) -> None:
        a = cls._adp()
        raise_for_status(a._lib.rm_end_retry_block(
            a._handle, tid if tid is not None else cls.get_current_thread_id()),
            "end_retry_block")

    # -- pool-wait markers (python-UDF protocol, reference :632-650) ---------

    @classmethod
    def submitting_to_pool(cls, flag: bool = True) -> None:
        a = cls._adp()
        raise_for_status(a._lib.rm_submitting_to_pool(
            a._handle, cls.get_current_thread_id(), int(flag)),
            "submitting_to_pool")

    @classmethod
    def waiting_on_pool(cls, flag: bool = True) -> None:
        a = cls._adp()
        raise_for_status(a._lib.rm_waiting_on_pool(
            a._handle, cls.get_current_thread_id(), int(flag)),
            "waiting_on_pool")

    @classmethod
    def done_waiting(cls) -> None:
        a = cls._adp()
        tid = cls.get_current_thread_id()
        raise_for_status(a._lib.rm_submitting_to_pool(a._handle, tid, 0),
                         "done_waiting")
        raise_for_status(a._lib.rm_waiting_on_pool(a._handle, tid, 0),
                         "done_waiting")

    # -- CPU off-heap hooks (reference RmmSpark.java:601-664) ----------------

    @classmethod
    def pre_cpu_alloc(cls, nbytes: int, blocking: bool = True) -> None:
        a = cls._adp()
        raise_for_status(a._lib.rm_cpu_prealloc(
            a._handle, cls.get_current_thread_id(), nbytes, int(blocking)),
            "pre_cpu_alloc")

    @classmethod
    def post_cpu_alloc_success(cls, nbytes: int) -> None:
        a = cls._adp()
        raise_for_status(a._lib.rm_cpu_postalloc_success(
            a._handle, cls.get_current_thread_id(), nbytes),
            "post_cpu_alloc_success")

    @classmethod
    def post_cpu_alloc_failed(cls, was_oom: bool = True,
                              blocking: bool = True) -> None:
        """Raises the mapped OOM if the state machine escalates; returns when
        the caller should simply retry the host allocation."""
        a = cls._adp()
        raise_for_status(a._lib.rm_cpu_postalloc_failed(
            a._handle, cls.get_current_thread_id(), int(was_oom),
            int(blocking)), "post_cpu_alloc_failed")

    @classmethod
    def cpu_dealloc(cls, nbytes: int) -> None:
        a = cls._adp()
        raise_for_status(a._lib.rm_cpu_dealloc(
            a._handle, cls.get_current_thread_id(), nbytes), "cpu_dealloc")

    # -- OOM / exception injection (reference :435-515) ----------------------

    @classmethod
    def force_retry_oom(cls, tid: int, num_ooms: int = 1,
                        oom_mode: int = OOM_MODE_TPU, skip: int = 0) -> None:
        a = cls._adp()
        raise_for_status(a._lib.rm_force_oom(
            a._handle, tid, RM_RETRY_OOM, num_ooms, oom_mode, skip),
            "force_retry_oom")

    @classmethod
    def force_split_and_retry_oom(cls, tid: int, num_ooms: int = 1,
                                  oom_mode: int = OOM_MODE_TPU,
                                  skip: int = 0) -> None:
        a = cls._adp()
        raise_for_status(a._lib.rm_force_oom(
            a._handle, tid, RM_SPLIT_AND_RETRY_OOM, num_ooms, oom_mode, skip),
            "force_split_and_retry_oom")

    @classmethod
    def force_exception(cls, tid: int, num: int = 1,
                        oom_mode: int = OOM_MODE_TPU, skip: int = 0) -> None:
        a = cls._adp()
        raise_for_status(a._lib.rm_force_oom(
            a._handle, tid, RM_INJECTED_EXCEPTION, num, oom_mode, skip),
            "force_exception")

    # -- state / metrics (reference :533-590) --------------------------------

    @classmethod
    def get_state_of(cls, tid: int) -> int:
        return cls._adp().get_state_of(tid)

    @classmethod
    def _metric(cls, task_id: int, which: int, reset: bool) -> int:
        a = cls._adp()
        return a._lib.rm_get_metric(a._handle, task_id, which, int(reset))

    @classmethod
    def get_and_reset_num_retry(cls, task_id: int) -> int:
        return cls._metric(task_id, _METRIC_RETRY, True)

    @classmethod
    def get_and_reset_num_split_retry(cls, task_id: int) -> int:
        return cls._metric(task_id, _METRIC_SPLIT_RETRY, True)

    @classmethod
    def get_and_reset_block_time_ns(cls, task_id: int) -> int:
        return cls._metric(task_id, _METRIC_BLOCK_TIME, True)

    @classmethod
    def get_and_reset_compute_time_lost_to_retry_ns(cls, task_id: int) -> int:
        return cls._metric(task_id, _METRIC_LOST_TIME, True)

    @classmethod
    def get_and_reset_max_device_reserved(cls, task_id: int) -> int:
        return cls._metric(task_id, _METRIC_MAX_RESERVED, True)

    @classmethod
    def get_fault_domain_metrics(cls) -> dict:
        """Process-wide fault-domain counters (faultinj/guard.py): guarded
        calls, injected faults, transient retries, backoff ns, poisoned
        programs, re-dispatches, resource-exhausted routings, task retries
        and degradations. Available without a native adaptor installed."""
        from ..faultinj.guard import metrics
        return metrics.snapshot()

    @classmethod
    def reset_fault_domain_metrics(cls) -> None:
        from ..faultinj.guard import metrics
        metrics.reset()

    @classmethod
    def pool_used(cls) -> int:
        return cls._adp().pool_used()

    @classmethod
    def pool_pressure(cls) -> Tuple[int, int]:
        """(used_bytes, capacity_bytes) of the installed pool, or (0, 0)
        when ungoverned — the fleet's replica-pressure telemetry input
        (advisory: routing weights only, never correctness)."""
        a = cls._adaptor
        if a is None:
            return (0, 0)
        try:
            return (a.pool_used(), a.pool_bytes)
        except Exception:
            return (0, 0)

    @classmethod
    def check_and_break_deadlocks(cls) -> None:
        a = cls._adp()
        a._lib.rm_check_and_break_deadlocks(a._handle)
