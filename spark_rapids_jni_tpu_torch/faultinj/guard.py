"""Fault-domain supervisor: classified, recoverable dispatch (the JAX
package's faultinj/guard.py).

The reference ships ``libcufaultinj.so`` because a production executor must
survive device traps, transient runtime errors, and OOM mid-query — and the
plugin's answer to each is DIFFERENT (faultinj/README.md + the spark-rapids
retry framework): OOM rolls back to a spillable state and re-enters the
RmmSpark retry/split protocol, transient API errors are retried in place,
and a device trap poisons the CUDA context so work must be re-dispatched or
degraded to the CPU. This module is that classification table for the TPU
port, applied uniformly at every dispatch surface:

  ============================  =======================================
  domain                        handling
  ============================  =======================================
  RESOURCE_EXHAUSTED            raise into the RmmSpark retry protocol
                                (TpuRetryOOM — callers under
                                memory.retry.with_retry or the
                                TaskExecutor ladder roll back + retry)
  TRANSIENT (UNAVAILABLE /      bounded exponential backoff with jitter,
  plain ABORTED /               retried in place; FaultStormError after
  InjectedApiError)             ``faultinj.max_transient_retries``
  POISON (DeviceTrapError /     current program is poisoned: bounded
  DeviceAssertError)            re-dispatch (``faultinj.max_poison_
                                redispatch``), then the error propagates
                                to the TaskExecutor degradation ladder
  CORRUPTION                    checksum/fingerprint verification failed
  (CorruptionError /            (memory/integrity.py): the bytes in hand
  DATA_LOSS statuses)           are wrong, so retry-in-place can only
                                re-return them — count the detection and
                                propagate for discard-and-reconstruct
                                from source (re-read / re-exchange /
                                re-materialize upstream)
  STALL (DeadlineExceeded /     the call outlived its time budget or was
  StallCancelled /              cancelled by the hang watchdog
  DEADLINE_EXCEEDED /           (faultinj/watchdog.py): bounded
  ABORTED-with-timeout)         re-dispatch (``watchdog.max_stall_
                                retries``) while deadline budget remains,
                                else propagate into the cancellation →
                                degradation → worker-lost ladder
  CRASH (WorkerCrashError)      a sandbox worker process died (signal /
                                nonzero exit / hung-and-killed —
                                faultinj/sandbox.py): never retry in
                                place (the dead worker cannot answer) —
                                count the detection and propagate; the
                                sandbox respawns the worker lazily, the
                                TaskExecutor replays against the task
                                retry budget, and repeat offenders are
                                quarantined like CORRUPTION
  FATAL (everything else)       propagate unchanged
  ============================  =======================================

Dispatch surfaces guarded in this package (the api names a JSON fault
config can target, in addition to the injector's patched op entry points):

  * ``memory/transport.py`` — "h2d", "d2h", "spill", "unspill",
                         "spill_disk", "unspill_disk" (checksummed disk
                         spill tier)
  * ``plan/executor.py`` — "plan_execute" (the plan engine's single
                         fused-program boundary; op cores inside the
                         program are pure and carry no guards)
  * ``parquet/reader.py`` — "parquet_page_decode",
                         "parquet_device_decode"
  * ``bridge.py``        — each engine op by its name ("hash.murmur3",
                         "cast.string_to_float", ...), around the op
                         and after the columns are marshalled
  * ``ops/parse_uri.py`` — "parse_uri" (the native host tier, in process
                         or in a sandbox worker)

The JAX package's other surfaces (the sharded exchange) are not ported
yet (ROADMAP A15b).

Payload bit-flip surfaces (``injectionType: 3`` rules consumed by the
memory/integrity.py hooks, not by exception checkpoints): "spill",
"unspill", "disk_promote".

Real runtime exceptions classify through the same table as injected ones:
a CUDA ``torch.cuda.OutOfMemoryError`` ("CUDA out of memory. ...", the
counterpart of XLA's ``RESOURCE_EXHAUSTED``) routes into the retry
protocol exactly like an injected OOM, so chaos configs exercise the
identical recovery paths production failures take. Its traceback is
cleared before the re-raise as ``TpuRetryOOM``: the frames of the failed
attempt hold its tensors, and a retry must not find that memory pinned by
the exception the ladder keeps.

Degraded mode: after the TaskExecutor's ladder gives up on the device
(parallel/task_executor.py: ``task.degrade_after`` consecutive poison,
storm or stall failures), the task re-runs inside ``degraded()`` — fault
injection is suppressed and ``utils.backend.tier_is_device`` resolves
"auto" tiers to the host tier. The mode is per thread, so it degrades
that task alone. Metrics for every domain are kept here and
surfaced through ``RmmSpark.get_fault_domain_metrics`` and profiler
ranges (utils/tracing.py) so chaos runs are observable.
"""

from __future__ import annotations

import random
import threading
import time
import traceback
from typing import Any, Callable, Dict

import torch

from ..memory.exceptions import OffHeapOOM, TpuOOM, TpuRetryOOM
from ..utils.tracing import trace_range
from . import watchdog
from .injector import (
    DeviceAssertError,
    DeviceTrapError,
    InjectedApiError,
    get_injector,
)

# -- fault domains -----------------------------------------------------------

RESOURCE_EXHAUSTED = "resource_exhausted"
TRANSIENT = "transient"
POISON = "poison"
CORRUPTION = "corruption"
STALL = "stall"
CRASH = "crash"
FATAL = "fatal"

# substrings of real runtime-error messages that mark a domain. XLA/PJRT
# surface gRPC-style status names inside RuntimeError text in BOTH
# spellings depending on the layer ("RESOURCE_EXHAUSTED: ..." from the
# PJRT C API, "Resource exhausted: ..." / "Unavailable:" from the status
# formatting path), so matching is case-insensitive: every variant of a
# status must land in the same fault domain.
_TRANSIENT_MARKERS = ("unavailable", "aborted")
_EXHAUSTED_MARKERS = ("resource_exhausted", "resource exhausted",
                      "out_of_memory", "out of memory")
# real-runtime corruption spellings: gRPC DATA_LOSS statuses, plus the
# native parquet decoder's page-crc verdict ("page crc mismatch
# (corruption)") — both mean the payload bytes are wrong, not the call
_CORRUPTION_MARKERS = ("data_loss", "data loss", "crc mismatch",
                       "(corruption)")
# a DEADLINE_EXCEEDED status (either spelling) means the call outlived a
# time budget — the hang watchdog's domain, not a plain transient retry;
# ABORTED joins it only when the text says the abort was a timeout
_STALL_MARKERS = ("deadline_exceeded", "deadline exceeded", "deadline")
_TIMEOUT_WORDS = ("timeout", "timed out")


class FaultStormError(RuntimeError):
    """Transient-fault retry budget exhausted at one dispatch point."""

    def __init__(self, api: str, attempts: int, last: BaseException):
        super().__init__(
            f"{api}: still failing after {attempts} transient retries "
            f"(last: {type(last).__name__}: {last})")
        self.api = api
        self.attempts = attempts
        self.last = last


class ProgramPoisonedError(RuntimeError):
    """Device trap/assert persisted through every re-dispatch of a
    program — the TaskExecutor ladder decides degradation from here."""

    def __init__(self, api: str, attempts: int, last: BaseException):
        super().__init__(
            f"{api}: program poisoned after {attempts} re-dispatches "
            f"(last: {type(last).__name__}: {last})")
        self.api = api
        self.attempts = attempts
        self.last = last


def classify(exc: BaseException) -> str:
    """Map an exception (injected or real) to its fault domain."""
    from ..memory.integrity import CorruptionError
    from .sandbox import WorkerCrashError
    if isinstance(exc, WorkerCrashError):
        return CRASH  # before CorruptionError: QuarantinedInputError is a
        # CorruptionError on purpose (quarantine rides that handling), but
        # a raw worker death is its own domain
    if isinstance(exc, CorruptionError):
        return CORRUPTION
    if isinstance(exc, (watchdog.DeadlineExceededError,
                        watchdog.StallCancelledError)):
        return STALL
    if isinstance(exc, (TpuOOM, OffHeapOOM, MemoryError,
                        torch.cuda.OutOfMemoryError)):
        return RESOURCE_EXHAUSTED
    if isinstance(exc, (DeviceTrapError, DeviceAssertError)):
        return POISON
    if isinstance(exc, (FaultStormError, ProgramPoisonedError)):
        return FATAL  # budgets already spent at an inner guard — never
        # re-absorb an exhausted storm into a fresh retry loop
    if isinstance(exc, InjectedApiError):
        return TRANSIENT
    if isinstance(exc, (RuntimeError, OSError)):
        msg = str(exc).lower()
        if any(m in msg for m in _EXHAUSTED_MARKERS):
            return RESOURCE_EXHAUSTED
        if any(m in msg for m in _CORRUPTION_MARKERS):
            return CORRUPTION
        if any(m in msg for m in _STALL_MARKERS):
            return STALL
        if "aborted" in msg and any(w in msg for w in _TIMEOUT_WORDS):
            return STALL  # ABORTED raised *because* a wait timed out
        if any(m in msg for m in _TRANSIENT_MARKERS):
            return TRANSIENT
    return FATAL


# -- metrics -----------------------------------------------------------------

class FaultDomainMetrics:
    """Process-wide fault-domain counters (reference analog: the RmmSpark
    per-task retry metrics, RmmSpark.java:533-590 — these cover the domains
    the native state machine cannot see: transient backoff, poisoning,
    degradation). Thread-safe; surfaced via RmmSpark.get_fault_domain_metrics
    so chaos runs read one metrics facade."""

    _FIELDS = ("guarded_calls", "injected_faults", "transient_retries",
               "backoff_time_ns", "poisoned_programs", "redispatches",
               "resource_exhausted", "degradations", "task_retries",
               "corruption_detected", "quarantined_buffers",
               "injected_delays", "deadline_exceeded", "stall_detected",
               "stall_cancelled", "stall_retries", "diagnostics_bundles",
               "workers_lost", "injected_crashes", "crash_detected",
               "worker_respawns", "quarantined_inputs", "breaker_opened",
               "breaker_closed", "breaker_short_circuits", "drains",
               "batch_solo_replays", "injected_ooms", "oom_retries",
               "oom_splits")

    def __init__(self):
        self._lock = threading.Lock()
        self._c: Dict[str, int] = {f: 0 for f in self._FIELDS}

    def bump(self, field: str, by: int = 1) -> None:
        with self._lock:
            self._c[field] += by

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)

    def reset(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._c)
            for f in self._c:
                self._c[f] = 0
            return out


metrics = FaultDomainMetrics()

# -- degraded mode -----------------------------------------------------------

_tls = threading.local()


def degraded_mode() -> bool:
    """True while the calling thread runs on the degradation ladder's
    host/CPU fallback path (fault injection suppressed, auto tiers host)."""
    return getattr(_tls, "degraded", 0) > 0


class degraded:
    """Context manager marking this thread degraded (re-entrant)."""

    def __enter__(self):
        _tls.degraded = getattr(_tls, "degraded", 0) + 1
        return self

    def __exit__(self, *a):
        _tls.degraded = getattr(_tls, "degraded", 1) - 1
        return False


# -- guarded dispatch --------------------------------------------------------

_jitter = random.Random()


def _backoff_s(attempt: int, base: float, cap: float) -> float:
    """Bounded exponential backoff with full jitter (AWS-style: uniform in
    (0, min(cap, base·2^attempt)]) — concurrent tasks hitting one transient
    fault must not retry in lockstep."""
    span = min(cap, base * (2.0 ** attempt))
    return _jitter.uniform(0, span) if span > 0 else 0.0


def _limits():
    from ..utils import config
    return (int(config.get("faultinj.max_transient_retries")),
            float(config.get("faultinj.backoff_base_s")),
            float(config.get("faultinj.backoff_max_s")),
            int(config.get("faultinj.max_poison_redispatch")),
            int(config.get("watchdog.max_stall_retries")))


def _drop_frames(exc: BaseException) -> None:
    """Clear the locals of the finished frames in ``exc``'s traceback (and
    in its causes' and contexts'), then the tracebacks themselves. The
    type, message and chain stay; the failed attempt's intermediates,
    which only those frames still reference, are freed."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if exc.__traceback__ is not None:
            traceback.clear_frames(exc.__traceback__)
            exc.__traceback__ = None
        exc = exc.__cause__ or exc.__context__


def guarded_dispatch(api_name: str, fn: Callable[..., Any], *args,
                     **kwargs) -> Any:
    """Run one device dispatch under the fault-domain supervisor.

    Consults the installed ``FaultInjector``'s rules for ``api_name``
    before every attempt (so a JSON config targeting this name actually
    fires here), classifies anything raised — injected or real — and
    applies the domain's recovery: transient errors back off and retry in
    place, poison errors re-dispatch a bounded number of times, resource
    exhaustion re-raises into the RmmSpark retry protocol as TpuRetryOOM,
    fatal errors propagate. ``fn`` must be effect-free up to its return
    value (true of every guarded surface: pure dispatches and idempotent
    transfers), since recovery re-runs it.

    Deadline/watchdog integration (faultinj/watchdog.py): every attempt
    registers an in-flight record (the watchdog's per-dispatch heartbeat)
    and starts with a cooperative checkpoint, so a cancel or an expired
    deadline surfaces at the retry boundary; backoff sleeps are
    cancellable and capped by the remaining budget. STALL-classified
    failures re-dispatch at most ``watchdog.max_stall_retries`` times
    while budget remains, then propagate to the degradation ladder.
    """
    max_transient, base_s, cap_s, max_poison, max_stall = _limits()
    metrics.bump("guarded_calls")
    inj = get_injector()
    suppressed = degraded_mode()
    transient_seen = 0
    poison_seen = 0
    stall_seen = 0
    with watchdog.ensure_deadline(f"dispatch:{api_name}"):
        while True:
            handle = watchdog.begin_dispatch(api_name)
            try:
                watchdog.checkpoint()  # cancel/deadline at retry boundary
                if inj is not None and not suppressed:
                    inj.check(api_name)
                return fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — classified below
                domain = classify(e)
                injected = isinstance(
                    e, (InjectedApiError, DeviceTrapError,
                        DeviceAssertError))
                if injected:
                    metrics.bump("injected_faults")
                if domain == RESOURCE_EXHAUSTED:
                    metrics.bump("resource_exhausted")
                    if isinstance(e, (TpuOOM, OffHeapOOM)):
                        raise  # already speaks the retry protocol's
                        # taxonomy
                    # a real runtime OOM (a CUDA OutOfMemoryError) enters
                    # the same rollback/split protocol as a denial; the
                    # failed attempt's frames let go of its tensors first
                    _drop_frames(e)
                    raise TpuRetryOOM(
                        f"{api_name}: {type(e).__name__}: {e}") from e
                if domain == TRANSIENT:
                    transient_seen += 1
                    if transient_seen > max_transient:
                        raise FaultStormError(api_name, transient_seen - 1,
                                              e) from e
                    delay = _backoff_s(transient_seen - 1, base_s, cap_s)
                    delay = watchdog.derive_timeout(delay) or 0.0
                    metrics.bump("transient_retries")
                    metrics.bump("backoff_time_ns", int(delay * 1e9))
                    with trace_range(f"fault:transient:{api_name}"):
                        if delay:
                            watchdog.deadline_sleep(delay)
                    continue
                if domain == POISON:
                    poison_seen += 1
                    metrics.bump("poisoned_programs")
                    if poison_seen > max_poison:
                        raise ProgramPoisonedError(api_name,
                                                   poison_seen - 1,
                                                   e) from e
                    metrics.bump("redispatches")
                    with trace_range(f"fault:redispatch:{api_name}"):
                        pass
                    continue
                if domain == CORRUPTION:
                    # never retry-in-place: the corrupted copy would
                    # simply be re-verified (and re-fail) — count the
                    # detection and hand the error up for discard-and-
                    # reconstruct (TaskExecutor re-materializes from
                    # source; readers re-read the file)
                    metrics.bump("corruption_detected")
                    with trace_range(f"fault:corruption:{api_name}"):
                        pass
                    raise
                if domain == CRASH:
                    # the worker that held the native state is dead —
                    # retry-in-place would dispatch into a void. Count the
                    # containment and propagate: the sandbox respawns on
                    # the next call and the TaskExecutor replays the task
                    # against its retry budget (quarantine after
                    # sandbox.max_replays crashes of one input).
                    metrics.bump("crash_detected")
                    with trace_range(f"fault:crash:{api_name}"):
                        pass
                    raise
                if domain == STALL:
                    # a cancelled dispatch or spent budget cannot be
                    # retried in place; an RPC-level DEADLINE_EXCEEDED
                    # while the task still has budget gets a bounded
                    # re-dispatch
                    stall_seen += 1
                    dl = watchdog.current_deadline()
                    spent = dl is not None and (dl.token.cancelled()
                                                or dl.expired())
                    if spent or stall_seen > max_stall:
                        raise
                    metrics.bump("stall_retries")
                    with trace_range(f"fault:stall:{api_name}"):
                        pass
                    continue
                raise  # FATAL
            finally:
                watchdog.end_dispatch(handle)
