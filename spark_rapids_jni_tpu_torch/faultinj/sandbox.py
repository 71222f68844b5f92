"""Crash containment: process-isolated native dispatch (the JAX package's
faultinj/sandbox.py).

The native Parquet decoder (libsparkpqd) is dlopen'd into the executor
process, so a SIGSEGV in a page decode would take every in-flight task
with it. This module hosts such crash-prone native dispatch surfaces in
a supervised worker SUBPROCESS, behind ``guarded_dispatch``:

  * bytes move as pickled buffers over a pipe pair (the numpy arrays the
    surfaces marshal anyway ARE the IPC encoding);
  * worker death is detected by exitcode/signal and surfaces as
    :class:`WorkerCrashError`, which guard.py classifies into the CRASH
    fault domain, never retried in place: the worker respawns lazily on
    the next call, the caller replays, and an input that keeps killing
    workers is quarantined after ``sandbox.max_replays`` exactly like
    CORRUPTION (:class:`QuarantinedInputError`);
  * ``injectionType 5`` makes crashes injectable at every sandboxed
    surface: the PARENT samples the rule (injector.crash_spec) and the
    directive executes INSIDE the worker (os.abort / SIGKILL / exit), so
    a storm proves containment of real process death;
  * each surface carries a circuit breaker (faultinj/breaker.py): a
    surface whose workers keep dying routes straight to its in-process
    path once the breaker opens;
  * a sandbox call adopts the caller's Deadline: the response wait is a
    bounded poll with watchdog checkpoints, and a HUNG worker escalates
    stall -> kill -> CRASH.

Two worker groups keep respawn cost proportional to what crashed:

  * "native" workers load their targets by file path
    (faultinj/_sandbox_targets.py): bare python + numpy, no torch, and no
    card visible to them;
  * "bridge" workers import this package (``mod_target``) to run the
    bridge's opted-in ops (``sandbox.bridge_ops``; bridge.py) on wire
    columns, which are flat bytes, so the wire format is the pickle
    payload. A bridge worker is spawned (a fresh interpreter, never a
    fork of the caller) and sees the card: it runs the op on the card
    when the caller's columns are bound there, in its own CUDA context,
    so a device fault in the op kills the worker and not the caller. The
    JAX package pins its bridge workers to the CPU because a TPU admits
    one process; a GPU admits several.

Config: ``sandbox.enabled`` (default off: in-process dispatch is
bit-identical and faster when crash containment is not required),
``sandbox.surfaces``, ``sandbox.bridge_ops``, ``sandbox.max_replays``,
``sandbox.call_timeout_s``; breaker knobs in breaker.py.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..memory.integrity import CorruptionError
from . import breaker, watchdog

_HERE = os.path.dirname(os.path.abspath(__file__))
_WORKER_PY = os.path.join(_HERE, "_sandbox_worker.py")
_TARGETS_PY = os.path.join(_HERE, "_sandbox_targets.py")
# the directory that holds this package: a bridge worker imports it
_PKG_PARENT = os.path.dirname(os.path.dirname(_HERE))


class WorkerCrashError(RuntimeError):
    """A sandbox worker died (signal / nonzero exit / severed pipe) while
    hosting a native dispatch — fault domain CRASH."""

    def __init__(self, api: str, detail: str,
                 signum: Optional[int] = None,
                 exitcode: Optional[int] = None):
        super().__init__(f"{api}: sandbox worker crashed ({detail})")
        self.api = api
        self.signum = signum
        self.exitcode = exitcode


class QuarantinedInputError(CorruptionError):
    """An input crashed ``sandbox.max_replays`` workers in a row: like a
    checksum-failed buffer, the bytes in hand are presumed poison — the
    only recovery is rebuilding them from a different source, so this
    classifies (and is handled) exactly like CORRUPTION."""

    def __init__(self, api: str, key: str, replays: int):
        super().__init__(
            f"{api}: input {key!r} quarantined after crashing "
            f"{replays} sandbox workers")
        self.api = api
        self.key = key


def file_target(func: str) -> Tuple[str, str, str]:
    """Target spec for a function in _sandbox_targets.py ("native"
    group)."""
    return ("file", _TARGETS_PY, func)


def mod_target(dotted: str, func: str) -> Tuple[str, str, str]:
    """Target spec for a function of a package module ("bridge" group)."""
    return ("mod", dotted, func)


def _metrics():
    from .guard import metrics
    return metrics


class SandboxWorker:
    """One supervised worker subprocess (lazy spawn, serialized calls).

    A crashed worker is reaped immediately and respawned on the NEXT call
    (the crash's own dispatch never retries in place), so respawn cost is
    paid by the replay, not by the failure."""

    def __init__(self, group: str):
        self.group = group
        self._lock = threading.RLock()
        self._proc: Optional[subprocess.Popen] = None
        self._tx = None  # parent -> worker Connection
        self._rx = None  # worker -> parent Connection
        self._rid = 0
        self._ever_spawned = False

    # -- lifecycle -------------------------------------------------------

    def _spawn(self):
        from multiprocessing.connection import Connection
        req_r, req_w = os.pipe()
        rsp_r, rsp_w = os.pipe()
        env = dict(os.environ)
        if self.group == "bridge":
            # imports the package, and keeps the card
            env["PYTHONPATH"] = _PKG_PARENT + (
                os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
                else "")
        else:
            # a native worker holds no card: nothing it runs may touch
            # the device
            env["CUDA_VISIBLE_DEVICES"] = ""
        try:
            self._proc = subprocess.Popen(
                [sys.executable, _WORKER_PY, str(req_r), str(rsp_w)],
                pass_fds=(req_r, rsp_w), env=env, cwd=_HERE)
        finally:
            os.close(req_r)
            os.close(rsp_w)
        self._tx = Connection(req_w, readable=False)
        self._rx = Connection(rsp_r, writable=False)
        if self._ever_spawned:
            _metrics().bump("worker_respawns")
        self._ever_spawned = True

    def alive(self) -> bool:
        with self._lock:
            return self._proc is not None and self._proc.poll() is None

    def pid(self) -> Optional[int]:
        with self._lock:
            return None if self._proc is None else self._proc.pid

    def _teardown(self):
        """Drop the dead/killed worker's plumbing (under self._lock)."""
        for conn in (self._tx, self._rx):
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
        self._tx = self._rx = None
        self._proc = None

    def _kill(self):
        if self._proc is not None:
            self._proc.kill()
            try:
                self._proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
        self._teardown()

    def _death_verdict(self, api: str) -> WorkerCrashError:
        rc = None
        if self._proc is not None:
            try:
                # the pipe EOF can beat the exit status by a few ms: wait
                # briefly so the verdict carries the real signal/exitcode
                rc = self._proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                rc = self._proc.poll()
        signum = -rc if rc is not None and rc < 0 else None
        detail = (f"killed by signal {signum}" if signum is not None
                  else f"exit code {rc}" if rc is not None
                  else "pipe severed")
        err = WorkerCrashError(api, detail, signum=signum, exitcode=rc)
        self._teardown()
        return err

    # -- dispatch --------------------------------------------------------

    def call(self, api: str, target: Tuple[str, str, str], args: tuple,
             kwargs: Optional[dict] = None, crash: Optional[dict] = None,
             timeout_s: Optional[float] = None) -> Any:
        with self._lock:
            if not self.alive():
                if self._proc is not None:
                    self._teardown()
                self._spawn()
            self._rid += 1
            rid = self._rid
            msg = {"id": rid, "target": target, "args": args,
                   "kwargs": kwargs or {}, "crash": crash}
            try:
                self._tx.send(msg)
            except (OSError, ValueError):
                raise self._death_verdict(api)
            return self._wait(api, rid, timeout_s)

    def _wait(self, api: str, rid: int, timeout_s: Optional[float]) -> Any:
        """Bounded response wait: 50 ms polls with watchdog checkpoints, so
        the caller's Deadline governs the sandbox call like an in-process
        dispatch, and a hung worker is killed (a CRASH the supervisor can
        recover from)."""
        t0 = time.monotonic()
        while True:
            got = None
            try:
                # pipe errors only inside this try: a relayed OSError from
                # the target must NOT be mistaken for a severed pipe
                if self._rx.poll(0.05):
                    kind, got, payload = self._rx.recv()
            except (EOFError, OSError):
                raise self._death_verdict(api)
            if got is not None:
                if got != rid:
                    continue  # stale response from a pre-crash call
                if kind == "ok":
                    return payload
                # the target's own exception, re-raised in the parent for
                # the normal fault-domain classification
                raise payload
            rc = self._proc.poll()
            if rc is not None:
                # died between poll windows; drain one last response that
                # may have raced the death
                try:
                    if self._rx.poll(0):
                        kind, got, payload = self._rx.recv()
                        if got == rid and kind == "ok":
                            self._teardown()
                            return payload
                except (EOFError, OSError):
                    pass
                raise self._death_verdict(api)
            try:
                watchdog.checkpoint()
            except (watchdog.DeadlineExceededError,
                    watchdog.StallCancelledError) as e:
                self._kill()
                raise WorkerCrashError(
                    api, "hung worker killed by the deadline/watchdog "
                    "escalation") from e
            if timeout_s is not None and time.monotonic() - t0 > timeout_s:
                self._kill()
                raise WorkerCrashError(
                    api, f"no response within sandbox.call_timeout_s="
                    f"{timeout_s}; worker killed")

    def close(self) -> None:
        with self._lock:
            if self._proc is None:
                return
            if self._proc.poll() is None:
                try:
                    self._tx.send(None)  # orderly shutdown sentinel
                except (OSError, ValueError):
                    pass
                try:
                    self._proc.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    self._proc.kill()
                    try:
                        self._proc.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        pass
            self._teardown()


# -- worker registry ---------------------------------------------------------

_workers: Dict[str, SandboxWorker] = {}
_wlock = threading.Lock()


def get_worker(group: str = "native") -> SandboxWorker:
    with _wlock:
        w = _workers.get(group)
        if w is None:
            w = SandboxWorker(group)
            _workers[group] = w
        return w


def shutdown_all() -> int:
    """Terminate every sandbox worker (drain step / test isolation).
    Returns how many live workers were shut down."""
    with _wlock:
        workers = list(_workers.values())
        _workers.clear()
    n = 0
    for w in workers:
        alive = w.alive()
        w.close()
        if alive:
            n += 1
    return n


# -- quarantine --------------------------------------------------------------

_crash_counts: Dict[Tuple[str, str], int] = {}
_qlock = threading.Lock()


def reset_quarantine() -> None:
    with _qlock:
        _crash_counts.clear()


def _quarantine_check(api: str, key: Optional[str]) -> None:
    if key is None:
        return
    from ..utils import config
    max_replays = int(config.get("sandbox.max_replays"))
    if max_replays <= 0:
        return
    with _qlock:
        n = _crash_counts.get((api, key), 0)
    if n >= max_replays:
        raise QuarantinedInputError(api, key, n)


def _quarantine_bump(api: str, key: Optional[str]) -> None:
    if key is None:
        return
    from ..utils import config
    max_replays = int(config.get("sandbox.max_replays"))
    with _qlock:
        n = _crash_counts.get((api, key), 0) + 1
        _crash_counts[(api, key)] = n
    if max_replays > 0 and n == max_replays:
        _metrics().bump("quarantined_inputs")


# -- routing -----------------------------------------------------------------

def active(api: str, kind: str = "surface") -> bool:
    """Route decision for one dispatch: True = send it to the sandbox;
    False = take the in-process path (sandbox disabled for this surface,
    or its circuit breaker is open — the degraded route). ``kind``
    "surface" reads ``sandbox.surfaces``, "bridge" ``sandbox.bridge_ops``.
    A True from a HALF_OPEN breaker admits THE probe, so the caller must
    follow through with sandbox_call."""
    from ..utils import config
    if not bool(config.get("sandbox.enabled")):
        return False
    key = "sandbox.bridge_ops" if kind == "bridge" else "sandbox.surfaces"
    names = {s.strip() for s in str(config.get(key)).split(",")
             if s.strip()}
    if api not in names:
        return False
    if not breaker.get_breaker(api).allow():
        _metrics().bump("breaker_short_circuits")
        return False
    return True


def sandbox_call(api: str, target: Tuple[str, str, str], *args,
                 group: str = "native", quarantine_key: Optional[str] = None,
                 **kwargs) -> Any:
    """Dispatch one native call through the sandbox worker.

    Run under ``guarded_dispatch(api, ...)`` so a WorkerCrashError
    classifies CRASH with the api name attached. The breaker records the
    outcome here: a crash (or hang-kill) is a surface failure; a worker
    that ANSWERS, even with the target's exception, is a healthy
    surface."""
    _quarantine_check(api, quarantine_key)
    crash = None
    from .guard import degraded_mode
    from .injector import get_injector
    inj = get_injector()
    if inj is not None and not degraded_mode():
        crash = inj.crash_spec(api)
        if crash is not None:
            _metrics().bump("injected_crashes")
    from ..utils import config
    timeout_s = float(config.get("sandbox.call_timeout_s"))
    timeout_s = timeout_s if timeout_s > 0 else None
    br = breaker.get_breaker(api)
    w = get_worker(group)
    try:
        out = w.call(api, target, args, kwargs, crash=crash,
                     timeout_s=timeout_s)
    except WorkerCrashError:
        br.record_failure()
        _quarantine_bump(api, quarantine_key)
        raise
    except BaseException:
        br.record_success()
        raise
    br.record_success()
    return out
