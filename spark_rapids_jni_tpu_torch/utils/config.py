"""The plan engine's knobs: the ``plan.*`` entries of the JAX package's
utils/config.py that this port reads, with the same names, defaults and
environment variables. Each resolves programmatic override ->
environment variable -> default.

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
}
_overrides: Dict[str, Any] = {}
_lock = threading.Lock()


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


@contextlib.contextmanager
def override(key: str, value: Any):
    """Scoped override (tests)."""
    if key not in _REGISTRY:
        raise KeyError(f"unknown config key {key!r}")
    with _lock:
        had = key in _overrides
        old = _overrides.get(key)
        _overrides[key] = value
    try:
        yield
    finally:
        with _lock:
            if had:
                _overrides[key] = old
            else:
                _overrides.pop(key, None)
