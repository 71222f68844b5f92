"""Deadline propagation + hang watchdog: nothing blocks forever (the JAX
package's faultinj/watchdog.py).

The fault-domain supervisor (guard.py) survives *errors*; this module
survives *silence*. Reference analog: Spark's task-level timeouts plus
RmmSpark's blocked-thread bookkeeping (the native deadlock watchdog in
memory/rmm_spark.py breaks BUFN deadlocks — this one catches everything
else: a hung collective, a stuck CUDA call, a deadlocked spill).

In this package the guarded surfaces are the transfers of
memory/transport.py, the fused executor's ``plan_execute``, the Parquet
reader's page decodes, the bridge's ops and ``parse_uri``; the
TaskExecutor (parallel/task_executor.py) carries deadlines across threads
and owns the recovery ladder. The sharded exchange named below is not
ported yet (ROADMAP A15b), and the text keeps its role.

Three cooperating pieces:

``Deadline``
    A thread-local time-budget context. Entering ``Deadline(30.0)`` gives
    the calling task 30 s of wall clock; every blocking surface beneath it
    (``guarded_dispatch`` attempts and backoff sleeps, transport column
    loops, the parquet reader's completion waits, ``TaskExecutor`` joins)
    derives its timeout from ``remaining()`` instead of a hardcoded
    constant, and checks ``checkpoint()`` at retry/chunk boundaries.
    Nested deadlines take the tighter expiry; the budget propagates across
    threads by ``snapshot()`` (submit side) + ``Deadline.adopt()`` (worker
    side) — see parallel/task_executor.py.

the watchdog thread
    A process-wide daemon that heartbeats per-dispatch progress: every
    ``guarded_dispatch`` attempt registers an in-flight record
    (``begin_dispatch``/``end_dispatch``). When a record outlives its
    deadline the watchdog escalates — capture a diagnostics bundle
    (all-thread stack dump, fault-domain + RmmSpark metric snapshot,
    active dispatch/spill/exchange state), then cancel the stalled work's
    token so the next cooperative checkpoint raises
    ``StallCancelledError``; if the thread is truly wedged in C and
    ignores the cancel past ``watchdog.lost_after_s``, the worker is
    declared lost and the registered ``on_lost`` callback fires (the
    TaskExecutor re-queues the task against its retry budget, consistent
    with ``task_done`` zombie tracking).

``injected_delay``
    The execution point for ``injectionType: 4`` rules
    (faultinj/injector.py): a configurable sleep (``delayMs``) or a
    permanent hang (``delayMs: -1``) at any guarded surface, honoring the
    cancel token — so the watchdog's detect → diagnose → cancel ladder is
    provable under storms exactly like fault domains 0-3.

Escalation ladder (STALL domain, guard.py):

    deadline expires
        │ watchdog: stall_detected++, diagnostics bundle written
        ▼
    cooperative cancel (token; checked at retry/chunk boundaries)
        │ StallCancelledError → TaskExecutor counts a device failure
        ▼
    host-path downgrade (guard.degraded: injection suppressed)
        │ still wedged (cancel ignored > watchdog.lost_after_s)
        ▼
    worker declared lost → task re-queued against task.retry_budget

Config keys (utils/config.py): watchdog.enabled, watchdog.poll_period_s,
watchdog.default_budget_s, watchdog.diagnostics_dir,
watchdog.max_stall_retries, watchdog.lost_after_s, task.budget_s.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "CancelToken",
    "Deadline",
    "DeadlineExceededError",
    "StallCancelledError",
    "begin_dispatch",
    "checkpoint",
    "current_deadline",
    "deadline_sleep",
    "derive_timeout",
    "end_dispatch",
    "ensure_deadline",
    "in_oom_wait",
    "injected_delay",
    "last_bundles",
    "oom_wait",
    "remaining",
    "replica_id",
    "reset",
    "set_lost_handler",
    "set_replica_id",
]


class DeadlineExceededError(RuntimeError):
    """The calling task's time budget expired (fault domain STALL)."""

    def __init__(self, what: str, budget_s: float):
        super().__init__(
            f"{what}: deadline exceeded (budget {budget_s:.3f}s spent)")
        self.budget_s = budget_s


class StallCancelledError(RuntimeError):
    """The watchdog cancelled this work after a stall past its deadline
    (fault domain STALL) — raised at the next cooperative checkpoint."""


class CancelToken:
    """Cooperative cancellation: the watchdog sets it, blocked work checks
    it at retry/chunk boundaries (or waits on it instead of sleeping)."""

    def __init__(self):
        self._ev = threading.Event()
        self.reason: Optional[str] = None

    def cancel(self, reason: str) -> None:
        self.reason = reason
        self._ev.set()

    def cancelled(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: Optional[float]) -> bool:
        return self._ev.wait(timeout)

    def check(self) -> None:
        if self._ev.is_set():
            raise StallCancelledError(self.reason or "cancelled")


def _cfg(key: str):
    from ..utils import config
    return config.get(key)


def _bump(field: str, by: int = 1) -> None:
    from . import guard
    guard.metrics.bump(field, by)


# -- deadline context --------------------------------------------------------

_tls = threading.local()


class Deadline:
    """Thread-local per-task time budget (context manager, re-entrant).

    ``Deadline(budget_s)`` starts the clock at ``__enter__``; a nested
    deadline never extends an enclosing one (the tighter expiry wins).
    ``Deadline.adopt(snapshot)`` re-enters a budget captured on another
    thread with ``snapshot()`` — expiry is absolute (monotonic), so the
    queue time a task spends waiting for its worker counts against it.
    """

    def __init__(self, budget_s: float, what: str = "task"):
        self.budget_s = float(budget_s)
        self.what = what
        self.expires_at: Optional[float] = None
        self.token = CancelToken()
        self._outer: Optional["Deadline"] = None
        self._counted = False  # deadline_exceeded bumps once per deadline

    @classmethod
    def adopt(cls, snap: Tuple[float, float, CancelToken, str]) -> "Deadline":
        """Rebuild from ``snapshot()`` (cross-thread propagation): shares
        the origin's absolute expiry AND its cancel token, so cancelling
        the submitter cancels the worker."""
        budget, expires_at, token, what = snap
        dl = cls(budget, what)
        dl.expires_at = expires_at
        dl.token = token
        return dl

    def snapshot(self) -> Tuple[float, float, CancelToken, str]:
        assert self.expires_at is not None, "snapshot() before __enter__"
        return (self.budget_s, self.expires_at, self.token, self.what)

    @classmethod
    def adopt_wire(cls, snap: Tuple[float, float, str]) -> "Deadline":
        """Rebuild from ``snapshot_wire()`` received from another process.
        The absolute expiry survives the hop (``time.monotonic`` is
        CLOCK_MONOTONIC, system-wide on Linux) so router queue time counts
        against the replica's budget; the cancel token cannot cross a
        process boundary, so the adopted deadline gets a fresh one."""
        budget, expires_at, what = snap
        dl = cls(budget, what)
        dl.expires_at = expires_at
        return dl

    def snapshot_wire(self) -> Tuple[float, float, str]:
        """Picklable snapshot for cross-process propagation (fleet IPC):
        ``(budget_s, expires_at, what)`` — everything but the token."""
        assert self.expires_at is not None, "snapshot_wire() before __enter__"
        return (self.budget_s, self.expires_at, self.what)

    def __enter__(self) -> "Deadline":
        if self.expires_at is None:  # adopt() arrives pre-armed
            self.expires_at = time.monotonic() + self.budget_s
        self._outer = getattr(_tls, "deadline", None)
        if self._outer is not None:
            # the tighter budget wins; share the outer token so one cancel
            # reaches every nesting level
            self.expires_at = min(self.expires_at, self._outer.expires_at)
            self.token = self._outer.token
        _tls.deadline = self
        return self

    def __exit__(self, *a) -> bool:
        _tls.deadline = self._outer
        return False

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self) -> None:
        self.token.check()
        if self.expired():
            if not self._counted:
                self._counted = True
                _bump("deadline_exceeded")
            raise DeadlineExceededError(self.what, self.budget_s)


def current_deadline() -> Optional[Deadline]:
    return getattr(_tls, "deadline", None)


# -- process identity (fleet mode) -------------------------------------------

_replica_id: Optional[str] = None


def set_replica_id(rid: Optional[str]) -> None:
    """Tag this process as fleet replica ``rid`` (None to clear) — stall
    diagnostics bundles become attributable to a replica."""
    global _replica_id
    _replica_id = None if rid is None else str(rid)


def replica_id() -> Optional[str]:
    return _replica_id


def remaining() -> Optional[float]:
    """Seconds left in the active deadline; None = unbounded."""
    dl = current_deadline()
    return None if dl is None else dl.remaining()


def derive_timeout(default: Optional[float]) -> Optional[float]:
    """Timeout for one blocking wait: the remaining budget when a deadline
    is active (floored at 0 so an expired deadline polls, not blocks),
    else ``default`` — every hardcoded wait constant routes through here."""
    left = remaining()
    if left is None:
        return default
    left = max(0.0, left)
    return left if default is None else min(default, left)


def checkpoint() -> None:
    """Cooperative cancel + deadline check (retry/chunk boundaries)."""
    dl = current_deadline()
    if dl is not None:
        dl.check()


def deadline_sleep(seconds: float) -> None:
    """Sleep that a watchdog cancel or deadline expiry can interrupt —
    replaces bare time.sleep on guarded paths (backoff, injected delays).
    """
    dl = current_deadline()
    if dl is None:
        time.sleep(seconds)
        return
    end = time.monotonic() + seconds
    while True:
        dl.check()
        left = end - time.monotonic()
        if left <= 0:
            return
        # token.wait doubles as the sleep: a cancel wakes it immediately
        dl.token.wait(min(left, max(0.005, dl.remaining())))


# -- in-flight dispatch registry + watchdog thread ---------------------------

class _Inflight:
    __slots__ = ("api", "thread_id", "thread_name", "t_start", "deadline",
                 "stalled", "lost", "on_lost")

    def __init__(self, api: str, deadline: Optional[Deadline],
                 on_lost: Optional[Callable[[], None]]):
        self.api = api
        self.thread_id = threading.get_ident()
        self.thread_name = threading.current_thread().name
        self.t_start = time.monotonic()
        self.deadline = deadline
        self.stalled: Optional[float] = None  # monotonic time of escalation
        self.lost = False
        self.on_lost = on_lost


_lock = threading.Lock()
_inflight: Dict[int, _Inflight] = {}
_ids = itertools.count(1)
_thread: Optional[threading.Thread] = None
_bundles: deque = deque(maxlen=16)
# thread ident -> nesting depth while inside the retry-OOM protocol's
# blocking sections (memory/retry.py rollback + BUFN gate): the stall scan
# must never count a legitimately blocked-until-ready thread as wedged
_oom_waits: Dict[int, int] = {}


class oom_wait:
    """Context manager marking the calling thread as blocked inside the
    RmmSpark retry-OOM protocol (re-entrant). While marked, the watchdog's
    stall sweep skips the thread entirely — a BUFN thread waiting at the
    pool gate is the protocol working, not a hang; its deadline budget is
    still enforced cooperatively at the next checkpoint after the wait."""

    def __enter__(self) -> "oom_wait":
        tid = threading.get_ident()
        with _lock:
            _oom_waits[tid] = _oom_waits.get(tid, 0) + 1
        return self

    def __exit__(self, *a) -> bool:
        tid = threading.get_ident()
        with _lock:
            n = _oom_waits.get(tid, 1) - 1
            if n <= 0:
                _oom_waits.pop(tid, None)
            else:
                _oom_waits[tid] = n
        return False


def in_oom_wait(thread_ident: Optional[int] = None) -> bool:
    """True while ``thread_ident`` (default: the caller) is inside the
    retry-OOM protocol's blocking sections."""
    tid = threading.get_ident() if thread_ident is None else thread_ident
    with _lock:
        return _oom_waits.get(tid, 0) > 0


def set_lost_handler(handler: Optional[Callable[[], None]]) -> None:
    """Register this thread's worker-lost callback: if a dispatch on this
    thread ignores a cancel past ``watchdog.lost_after_s``, the watchdog
    invokes it (from the watchdog thread) exactly once per stall."""
    _tls.on_lost = handler


class _NullContext:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def ensure_deadline(what: str):
    """Context manager arming ``watchdog.default_budget_s`` as an implicit
    deadline when the caller carries none — every dispatch then has SOME
    bound when the default budget is configured. No-op (and free) when a
    deadline is already active or the default budget is 0."""
    if current_deadline() is not None:
        return _NullContext()
    budget = float(_cfg("watchdog.default_budget_s"))
    if budget <= 0:
        return _NullContext()
    return Deadline(budget, what)


def begin_dispatch(api: str) -> Optional[int]:
    """Register one in-flight dispatch attempt with the watchdog (a
    heartbeat: retries re-register, so forward progress is visible).
    Returns None — no monitoring — when the watchdog is off or no
    deadline is active."""
    if not _cfg("watchdog.enabled"):
        return None
    dl = current_deadline()
    if dl is None:
        return None
    rec = _Inflight(api, dl, getattr(_tls, "on_lost", None))
    with _lock:
        handle = next(_ids)
        _inflight[handle] = rec
    _ensure_thread()
    return handle


def end_dispatch(handle: Optional[int]) -> None:
    if handle is None:
        return
    with _lock:
        _inflight.pop(handle, None)


def last_bundles() -> List[Dict[str, Any]]:
    """The most recent diagnostics bundles (in-memory ring, newest last)."""
    with _lock:
        return list(_bundles)


def reset() -> None:
    """Test hook: drop in-flight records and captured bundles (the watchdog
    thread itself is left running; it idles on an empty registry)."""
    global _replica_id
    with _lock:
        _inflight.clear()
        _bundles.clear()
        _oom_waits.clear()
    _replica_id = None


def _ensure_thread() -> None:
    global _thread
    with _lock:
        if _thread is not None and _thread.is_alive():
            return
        _thread = threading.Thread(target=_watch, name="srjt-hang-watchdog",
                                   daemon=True)
        _thread.start()


def _watch() -> None:
    """Singleton watchdog loop: scan in-flight dispatches, escalate stalls.

    Escalation is per *thread*, not per record — a task body and the
    guarded dispatch nested inside it both expire at once (they share the
    deadline), but that is ONE stall: one counter bump, one bundle, one
    cancel of the shared token."""
    while True:
        try:
            period = float(_cfg("watchdog.poll_period_s"))
        except Exception:
            period = 0.05
        time.sleep(max(0.005, period))
        try:
            _scan()
        except Exception:  # the watchdog must never die of a bad snapshot
            traceback.print_exc(file=sys.stderr)


def _scan() -> None:
    now = time.monotonic()
    with _lock:
        recs = list(_inflight.values())
        oom_blocked = {t for t, n in _oom_waits.items() if n > 0}
    by_thread: Dict[int, List[_Inflight]] = {}
    for r in recs:
        by_thread.setdefault(r.thread_id, []).append(r)
    lost_after = float(_cfg("watchdog.lost_after_s"))
    for tid, group in by_thread.items():
        if tid in oom_blocked:
            # the thread is inside the retry-OOM protocol (rollback or the
            # BUFN pool gate, memory/retry.py) — blocked-until-ready is the
            # protocol working, never a stall to escalate
            continue
        expired = [r for r in group
                   if r.deadline is not None and r.deadline.expired()]
        if not expired:
            continue
        fresh = [r for r in expired if r.stalled is None]
        if fresh:
            # innermost record names the stall (it is where the thread is
            # actually blocked); every expired record is marked together
            inner = max(expired, key=lambda r: r.t_start)
            _escalate(inner, expired)
        # cancel delivered but the thread never progressed: it is wedged
        # beyond cooperative reach (inside C with the GIL released) —
        # declare the worker lost so its task can be re-queued
        for r in expired:
            if (r.stalled is not None and not r.lost
                    and now - r.stalled > max(0.0, lost_after)):
                r.lost = True
                if r.on_lost is not None:
                    _bump("workers_lost")
                    cb, r.on_lost = r.on_lost, None
                    try:
                        cb()
                    except Exception:
                        traceback.print_exc(file=sys.stderr)


def _escalate(inner: _Inflight, expired: List[_Inflight]) -> None:
    from ..utils.tracing import trace_range
    now = time.monotonic()
    for r in expired:
        r.stalled = now
    _bump("stall_detected")
    with trace_range(f"watchdog:stall:{inner.api}"):
        _capture_bundle(inner)
    inner.deadline.token.cancel(
        f"{inner.api} stalled on {inner.thread_name}: no progress within "
        f"the {inner.deadline.budget_s:.3f}s deadline")
    _bump("stall_cancelled")


# -- diagnostics bundles -----------------------------------------------------

def _capture_bundle(rec: _Inflight) -> None:
    """Freeze what the process was doing at the moment of the stall; kept
    in the in-memory ring and, when ``watchdog.diagnostics_dir`` is set,
    written as one JSON file per stall."""
    bundle: Dict[str, Any] = {
        "kind": "srjt-watchdog-stall",
        "unix_time": time.time(),
        "api": rec.api,
        "thread": rec.thread_name,
        "budget_s": rec.deadline.budget_s,
        "inflight_s": round(time.monotonic() - rec.t_start, 4),
        "pid": os.getpid(),
        "replica_id": _replica_id,
    }
    try:
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        bundle["stacks"] = {
            f"{names.get(tid, '?')}:{tid}":
                traceback.format_stack(frame)[-12:]
            for tid, frame in frames.items()
        }
    except Exception as e:
        bundle["stacks"] = {"error": repr(e)}
    try:
        from . import guard
        bundle["fault_domain_metrics"] = guard.metrics.snapshot()
    except Exception as e:
        bundle["fault_domain_metrics"] = {"error": repr(e)}
    try:
        from ..memory.rmm_spark import RmmSpark
        bundle["rmm_spark_installed"] = RmmSpark.is_installed()
    except Exception as e:
        bundle["rmm_spark_installed"] = repr(e)
    try:
        with _lock:
            bundle["active_dispatches"] = [
                {"api": r.api, "thread": r.thread_name,
                 "inflight_s": round(time.monotonic() - r.t_start, 4),
                 "stalled": r.stalled is not None}
                for r in _inflight.values()]
    except Exception as e:
        bundle["active_dispatches"] = [{"error": repr(e)}]
    try:
        from ..memory import transport
        bundle["spill_stores"] = transport.spill_state()
    except Exception as e:
        bundle["spill_stores"] = {"error": repr(e)}
    try:
        from ..parallel import exchange
        bundle["exchange_programs"] = exchange.program_state()
    except Exception as e:
        bundle["exchange_programs"] = {"error": repr(e)}
    with _lock:
        _bundles.append(bundle)
    _bump("diagnostics_bundles")
    out_dir = str(_cfg("watchdog.diagnostics_dir") or "")
    if out_dir:
        try:
            os.makedirs(out_dir, exist_ok=True)
            name = (f"stall-{int(bundle['unix_time'] * 1000)}-"
                    f"{rec.api.replace('/', '_').replace('.', '_')}.json")
            with open(os.path.join(out_dir, name), "w") as f:
                json.dump(bundle, f, indent=1, default=repr)
        except OSError:
            pass  # diagnostics must never turn a stall into a crash


# -- injectionType 4 (delay/hang) execution point ----------------------------

def injected_delay(api: str, delay_s: float) -> None:
    """Execute one fired delay/hang rule (injector.py injectionType 4).

    ``delay_s >= 0``: sleep that long, honoring cancel + deadline — a
    finite delay inside the budget completes and the call proceeds.
    ``delay_s < 0``: permanent hang; blocks until the watchdog cancels it
    (the provable stall). With no deadline and no default budget armed, a
    backstop self-raise fires once the dispatch's own record would have —
    never, so configure a deadline when injecting hangs."""
    _bump("injected_delays")
    dl = current_deadline()
    if delay_s >= 0:
        deadline_sleep(delay_s)
        return
    if dl is None:
        # hang with nothing watching: blocks forever by design — the
        # storm configs always run under a deadline (guarded_dispatch
        # arms watchdog.default_budget_s when the caller carries none)
        CancelToken().wait(None)  # pragma: no cover
        return
    # wait for the watchdog's cancel (exact stall accounting: the watchdog
    # is the one that detects); the deadline-expiry backstop below only
    # fires if the watchdog is disabled
    while True:
        if dl.token.wait(0.05):
            dl.token.check()
        if dl.expired() and not _cfg("watchdog.enabled"):
            dl.check()
