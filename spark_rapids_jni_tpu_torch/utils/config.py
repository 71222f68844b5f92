"""The port's knobs: the entries of the JAX package's utils/config.py
that this port reads (``plan.*``, ``trace.enabled``, ``rmm.*``,
``native.so_override``, ``faultinj.*``, ``watchdog.*``, ``task.*``,
``drain.timeout_s``, ``spill.*``, ``parquet.*``, ``sandbox.*``,
``breaker.*``, the string tiers'
``parse_uri.tier``, ``get_json.tier`` and ``from_json.tier``), with
the same names, defaults and environment variables. Each resolves
programmatic override -> environment variable -> default.

    from spark_rapids_jni_tpu_torch.utils import config
    config.get("plan.max_groups")
    with config.override("plan.max_groups", 16):
        ...
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict


def _parse_bool(s: str) -> bool:
    return s not in ("0", "", "false", "False", "no")


@dataclass(frozen=True)
class _Entry:
    env: str
    default: Any
    parse: Callable[[str], Any]
    doc: str


_REGISTRY: Dict[str, _Entry] = {
    "plan.max_groups": _Entry(
        "SRJT_PLAN_MAX_GROUPS", 4096, int,
        "static group-slot budget of the generic fused groupby: slots = "
        "bucket_size(min(this, rows)); a query with more live groups "
        "trips the overflow flag and replays eagerly"),
    "plan.min_rows": _Entry(
        "SRJT_PLAN_MIN_ROWS", 262144, int,
        "row floor at or above which the TPC-H entry points' engine=\"auto\" "
        "takes the fused plan engine"),
    "plan.topk_max": _Entry(
        "SRJT_PLAN_TOPK_MAX", 64, int,
        "largest Limit count the planner lowers as k selection rounds "
        "instead of a full sort"),
    "plan.groupby_small_span": _Entry(
        "SRJT_PLAN_GROUPBY_SMALL_SPAN", 64, int,
        "largest key span (hi-lo+1) of the direct_small groupby"),
    "plan.groupby_wide_span": _Entry(
        "SRJT_PLAN_GROUPBY_WIDE_SPAN", 1 << 21, int,
        "largest key span of the direct_wide (scatter-add) groupby; above "
        "it the planner picks the generic sorted groupby"),
    "plan.groupby_chunk": _Entry(
        "SRJT_PLAN_GROUPBY_CHUNK", 1024, int,
        "rows per block of the direct_small groupby: each block scatters "
        "into its own row of slot accumulators"),
    "plan.oom_retry_budget": _Entry(
        "SRJT_PLAN_OOM_RETRY_BUDGET", 100, int,
        "retry-OOM protocol at the fused plan_execute surface: rollbacks "
        "plus splits per execute_plan call before the OOM is terminal "
        "(with_retry's max_retries)"),
    "trace.enabled": _Entry(
        "SPARK_RAPIDS_TPU_TRACE", False, _parse_bool,
        "profiler ranges on ops (torch.profiler.record_function; ref: "
        "ai.rapids.cudf.nvtx.enabled)"),
    # ---- memory (memory/) -------------------------------------------------
    "rmm.watchdog_period_s": _Entry(
        "SRJT_RMM_WATCHDOG_PERIOD_S", 0.1, float,
        "deadlock watchdog poll period "
        "(ref: ai.rapids.cudf.spark.rmmWatchdogPollingPeriod, 100ms)"),
    "rmm.pool_bytes": _Entry(
        "SRJT_RMM_POOL_BYTES", 0, int,
        "default device reservation pool size; 0 = caller must pass one"),
    "rmm.validate_hbm": _Entry(
        "SRJT_RMM_VALIDATE_HBM", False, _parse_bool,
        "audit taken reservations against the CUDA caching allocator's "
        "allocated-bytes current/peak counters (memory/hbm.py report)"),
    "rmm.max_split_depth": _Entry(
        "SRJT_RMM_MAX_SPLIT_DEPTH", 8, int,
        "retry-OOM protocol: how many times one input may be halved under "
        "TpuSplitAndRetryOOM before with_retry declares the demand "
        "unsatisfiable (memory/retry.py)"),
    "native.so_override": _Entry(
        "SRJT_NATIVE_SO_OVERRIDE", "", str,
        "load a prebuilt resource-adaptor .so instead of building one"),
    # ---- fault domains (faultinj/) ----------------------------------------
    "faultinj.config": _Entry(
        "FAULT_INJECTOR_CONFIG_PATH", "", str,
        "fault-injection JSON config path (ref: cufaultinj LD_PRELOAD arg)"),
    "faultinj.max_transient_retries": _Entry(
        "SRJT_FAULT_MAX_TRANSIENT", 5, int,
        "in-place retries per dispatch for TRANSIENT faults before "
        "FaultStormError"),
    "faultinj.backoff_base_s": _Entry(
        "SRJT_FAULT_BACKOFF_BASE_S", 0.005, float,
        "transient-fault backoff base; attempt k sleeps "
        "uniform(0, min(max, base*2^k))"),
    "faultinj.backoff_max_s": _Entry(
        "SRJT_FAULT_BACKOFF_MAX_S", 0.25, float,
        "transient-fault backoff cap per sleep"),
    "faultinj.max_poison_redispatch": _Entry(
        "SRJT_FAULT_MAX_POISON", 2, int,
        "re-dispatches of a poisoned program (DeviceTrap/DeviceAssert) "
        "before ProgramPoisonedError"),
    "watchdog.enabled": _Entry(
        "SRJT_WATCHDOG_ENABLED", True, _parse_bool,
        "hang watchdog: monitor in-flight guarded dispatches against their "
        "deadlines (faultinj/watchdog.py)"),
    "watchdog.poll_period_s": _Entry(
        "SRJT_WATCHDOG_POLL_PERIOD_S", 0.05, float,
        "watchdog scan period for stalled dispatches"),
    "watchdog.default_budget_s": _Entry(
        "SRJT_WATCHDOG_DEFAULT_BUDGET_S", 0.0, float,
        "implicit per-dispatch deadline when the caller carries none; "
        "0 = only explicit Deadline contexts are enforced"),
    "watchdog.diagnostics_dir": _Entry(
        "SRJT_WATCHDOG_DIAG_DIR", "", str,
        "directory for per-stall diagnostics bundles (JSON); '' keeps "
        "bundles only in the in-memory ring"),
    "watchdog.max_stall_retries": _Entry(
        "SRJT_WATCHDOG_MAX_STALL_RETRIES", 1, int,
        "re-dispatches of a STALL-classified failure while budget remains"),
    "watchdog.lost_after_s": _Entry(
        "SRJT_WATCHDOG_LOST_AFTER_S", 5.0, float,
        "grace after a cooperative cancel before a non-responding thread "
        "is declared lost"),
    # ---- the task executor (parallel/task_executor.py) ---------------------
    "task.budget_s": _Entry(
        "SRJT_TASK_BUDGET_S", 0.0, float,
        "per-submission wall-clock deadline for TaskExecutor task bodies; "
        "0 = inherit only the submitter's Deadline (if any)"),
    "task.retry_budget": _Entry(
        "SRJT_TASK_RETRY_BUDGET", 4, int,
        "TaskExecutor per-submission retry budget across all fault "
        "domains (rollback-to-spillable between attempts)"),
    "task.degrade_after": _Entry(
        "SRJT_TASK_DEGRADE_AFTER", 3, int,
        "consecutive device failures before a task degrades to the "
        "host/CPU compute path (0 disables degradation)"),
    "drain.timeout_s": _Entry(
        "SRJT_DRAIN_TIMEOUT_S", 30.0, float,
        "deadline for TaskExecutor.drain(): stop admission, run in-flight "
        "tasks to completion, flush+fsync the SpillStore, stop sandbox "
        "workers, report a verdict"),
    # ---- spill (memory/transport.py) --------------------------------------
    "spill.disk_dir": _Entry(
        "SRJT_SPILL_DISK_DIR", "", str,
        "disk spill tier directory for SpillStore ('' disables): host "
        "tables past spill.host_limit_bytes demote to checksummed files"),
    "spill.host_limit_bytes": _Entry(
        "SRJT_SPILL_HOST_LIMIT_BYTES", 0, int,
        "host-tier byte budget for spilled tables before demotion to the "
        "disk tier; 0 = unlimited"),
    "spill.verify_fingerprints": _Entry(
        "SRJT_SPILL_VERIFY", True, _parse_bool,
        "crc32-fingerprint spilled tables and verify at promote; a "
        "mismatch quarantines the table and raises CorruptionError"),
    # ---- Parquet (parquet/) -----------------------------------------------
    "parquet.chunk_byte_budget": _Entry(
        "SRJT_PARQUET_CHUNK_BYTES", 128 << 20, int,
        "row-group batching budget for the chunked reader"),
    "parquet.decode_workers": _Entry(
        "SRJT_PARQUET_DECODE_WORKERS", 0, int,
        "column-decode thread count (GIL-free native decode); "
        "0 = min(8, cpu count)"),
    "parquet.verify_crc": _Entry(
        "SRJT_PARQUET_VERIFY_CRC", True, _parse_bool,
        "verify PageHeader.crc on every parquet page when present; a bad "
        "page surfaces as CorruptionError and the reader re-reads it"),
    "parquet.device_decode": _Entry(
        "SRJT_PARQUET_DEVICE_DECODE", "auto", str,
        "Parquet decode tier: auto (the device tier for a CUDA reader, the "
        "host tier for a CPU reader) | device/on (torch ops on the "
        "reader's device) | native/off (native host decode)"),
    # ---- the string device tiers (ops/parse_uri*, get_json*, from_json*) --
    "parse_uri.tier": _Entry(
        "SRJT_PARSE_URI_TIER", "auto", str,
        "parse_url PROTOCOL/HOST/QUERY execution tier: auto (the device "
        "tier for a CUDA column, the native C++ tier for a CPU column) | "
        "device | native"),
    "get_json.tier": _Entry(
        "SRJT_GET_JSON_TIER", "auto", str,
        "get_json_object execution: auto (device scan + navigate for a "
        "CUDA column and a KEY/INDEX path, the host PDA normalizing the "
        "narrowed spans; the host PDA for a CPU column) | device | native"),
    "from_json.tier": _Entry(
        "SRJT_FROM_JSON_TIER", "auto", str,
        "from_json raw-map execution: auto (device pair-span extraction "
        "for a CUDA column, rows with escapes or nested past the device "
        "DFA's depth cap on the native PDA; the native PDA for a CPU "
        "column) | device | native"),
    "parquet.encoded_strings": _Entry(
        "SRJT_PARQUET_ENCODED_STRINGS", False, _parse_bool,
        "surface dictionary-encoded BYTE_ARRAY chunks from the device tier "
        "as DICT32 (int32 codes + shared dictionary) instead of gathering "
        "their bytes into a STRING column"),
    "parquet.encoded_ints": _Entry(
        "SRJT_PARQUET_ENCODED_INTS", False, _parse_bool,
        "surface dictionary-encoded INT32/INT64 chunks from the device tier "
        "encoded: all-RLE index streams as RLE columns, one bit-packed page "
        "over a dense ascending dictionary as FOR32/FOR64"),
    "parquet.predicate_pushdown": _Entry(
        "SRJT_PARQUET_PUSHDOWN", True, _parse_bool,
        "skip row groups a reader predicate cannot match: equality "
        "literals absent from a fully dictionary-encoded chunk's "
        "dictionary page, integer comparisons outside the footer's "
        "min/max statistics"),
    # ---- crash containment (faultinj/sandbox.py, faultinj/breaker.py) -----
    "sandbox.enabled": _Entry(
        "SRJT_SANDBOX_ENABLED", False, _parse_bool,
        "host crash-prone native dispatch surfaces in supervised worker "
        "subprocesses so a SIGSEGV in native code is a recoverable CRASH "
        "fault; off = in-process dispatch (bit-identical, faster)"),
    "sandbox.surfaces": _Entry(
        "SRJT_SANDBOX_SURFACES", "parquet_page_decode,parse_uri", str,
        "csv of guarded api names routed through the sandbox when "
        "sandbox.enabled"),
    "sandbox.bridge_ops": _Entry(
        "SRJT_SANDBOX_BRIDGE_OPS", "", str,
        "csv of bridge op names (e.g. 'hash.murmur3') dispatched in the "
        "package-importing \"bridge\" sandbox worker; '' = no bridge ops "
        "sandboxed"),
    "sandbox.max_replays": _Entry(
        "SRJT_SANDBOX_MAX_REPLAYS", 3, int,
        "crashes one input may cause before it is quarantined "
        "(QuarantinedInputError, handled like CORRUPTION); 0 disables "
        "quarantine"),
    "sandbox.call_timeout_s": _Entry(
        "SRJT_SANDBOX_CALL_TIMEOUT_S", 0.0, float,
        "hard per-call cap on a sandbox worker's response besides the "
        "caller's Deadline; a silent worker is killed and the call "
        "classifies CRASH; 0 = Deadline/watchdog only"),
    "breaker.enabled": _Entry(
        "SRJT_BREAKER_ENABLED", True, _parse_bool,
        "per-surface circuit breakers: a surface failing breaker.threshold "
        "times within breaker.window_s opens and routes to its degraded "
        "path without paying the recovery ladder per call"),
    "breaker.threshold": _Entry(
        "SRJT_BREAKER_THRESHOLD", 5, int,
        "failures within breaker.window_s that open a surface's breaker; "
        "0 disables"),
    "breaker.window_s": _Entry(
        "SRJT_BREAKER_WINDOW_S", 30.0, float,
        "sliding window for breaker failure counting; 0 = failures never "
        "age out"),
    "breaker.cooldown_s": _Entry(
        "SRJT_BREAKER_COOLDOWN_S", 5.0, float,
        "time an open breaker waits before going half-open and admitting "
        "one probe"),
    "breaker.retry_jitter": _Entry(
        "SRJT_BREAKER_RETRY_JITTER", True, _parse_bool,
        "decorrelated jitter on an open breaker's retry_after_s hints; "
        "off = the deterministic cooldown remainder"),
}
_overrides: Dict[str, Any] = {}
_lock = threading.Lock()
# bumped on every mutation: a hot path caches a resolved flag and
# revalidates it with one unlocked integer read (utils/tracing.py)
_epoch = 0


def get(key: str) -> Any:
    """Resolve: programmatic override -> environment -> default."""
    e = _REGISTRY[key]
    with _lock:
        if key in _overrides:
            return _overrides[key]
    raw = os.environ.get(e.env)
    if raw is not None:
        return e.parse(raw)
    return e.default


def set(key: str, value: Any) -> None:  # noqa: A001 - the JAX package's name
    """Process-wide override (until ``unset``)."""
    if key not in _REGISTRY:
        raise KeyError(f"unknown config key {key!r}")
    global _epoch
    with _lock:
        _overrides[key] = value
        _epoch += 1


def unset(key: str) -> None:
    global _epoch
    with _lock:
        _overrides.pop(key, None)
        _epoch += 1


def epoch() -> int:
    """Mutation counter (unlocked read; monotonic under the lock)."""
    return _epoch


@contextlib.contextmanager
def override(key: str, value: Any):
    """Scoped override (tests)."""
    if key not in _REGISTRY:
        raise KeyError(f"unknown config key {key!r}")
    global _epoch
    with _lock:
        had = key in _overrides
        old = _overrides.get(key)
        _overrides[key] = value
        _epoch += 1
    try:
        yield
    finally:
        with _lock:
            if had:
                _overrides[key] = old
            else:
                _overrides.pop(key, None)
            _epoch += 1
