"""Trace annotations (the JAX package's utils/tracing.py; reference: NVTX
ranges, SURVEY.md §5.1).

The reference wraps JNI entry points in ``CUDF_FUNC_RANGE()`` NVTX ranges,
toggled by ``ai.rapids.cudf.nvtx.enabled``. Here a range is a
``torch.profiler.record_function`` span, which torch.profiler shows on the
host timeline above the kernels it launched. Off unless the
``trace.enabled`` config key (``SPARK_RAPIDS_TPU_TRACE``) is set, and then
the whole cost is one unlocked integer read per call.

Usage::

    @func_range()               # span named after the function
    def convert_to_rows(...): ...

    with trace_range("shuffle-pack"):
        ...
"""

from __future__ import annotations

import contextlib
import functools

import torch

_cached = (-1, False)  # (config epoch, resolved flag)


def tracing_enabled() -> bool:
    """The ``trace.enabled`` flag, re-resolved only after a config
    mutation (an environment change is seen at the next one — use
    ``config.set("trace.enabled", ...)`` to toggle at run time)."""
    global _cached
    from . import config
    e = config.epoch()
    if _cached[0] != e:
        _cached = (e, bool(config.get("trace.enabled")))
    return _cached[1]


@contextlib.contextmanager
def trace_range(name: str):
    if not tracing_enabled():
        yield
        return
    with torch.profiler.record_function(name):
        yield


def func_range(name: str = None):
    """Decorator: wrap the call in a named profiler range
    (CUDF_FUNC_RANGE)."""
    def deco(fn):
        span = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not tracing_enabled():
                return fn(*a, **kw)
            with torch.profiler.record_function(span):
                return fn(*a, **kw)
        return wrapper
    return deco
