"""Reservation bracketing: estimate -> reserve -> launch -> release (the
JAX package's memory/reservation.py).

Reference contract: every cudf/RMM allocation the reference's kernels make
flows through the SparkResourceAdaptor do_allocate loop
(SparkResourceAdaptorJni.cpp:1731), so the retry/BUFN/split machinery
governs real memory pressure. Here the CUDA caching allocator's mallocs
are not intercepted per buffer, so each device op is bracketed with a
*reservation* for its peak transient working set, as in the JAX package:
the op estimates its footprint, reserves it through RmmSpark (which may
block the thread, throw TpuRetryOOM, or escalate to TpuSplitAndRetryOOM
exactly like the reference's adaptor), launches, and releases on return.

Ops call ``device_reservation(nbytes)``. The bracket is active only when
an RmmSpark event handler is installed AND the calling thread is
associated with a task (reference parity: unregistered threads bypass the
adaptor) — so library users who never touch RmmSpark pay one attribute
read, nothing more, and no host sync.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from ..columnar.column import Column, Table
from . import hbm
from .rmm_spark import RmmSpark, ThreadState

# Per-thread depth: a reservation taken inside another reservation's bracket
# (an op composed of ops) must not double-count its parent's estimate;
# inner brackets are no-ops.
_tls = threading.local()


def reservations_active() -> bool:
    """True when the calling thread's device work is governed by RmmSpark."""
    if not RmmSpark.is_installed():
        return False
    state = RmmSpark.get_state_of(RmmSpark.get_current_thread_id())
    return state != ThreadState.UNKNOWN


@contextmanager
def device_reservation(nbytes: int):
    """Reserve ``nbytes`` of device memory around a device-op launch.

    Yields True when a reservation was actually taken. Raises the OOM
    taxonomy (TpuRetryOOM / TpuSplitAndRetryOOM / TpuOOM) from the reserve
    step when the scheduler demands rollback/split — callers running under
    ``memory.retry.with_retry`` get the full retry protocol.
    """
    depth = getattr(_tls, "depth", 0)
    if nbytes <= 0 or depth > 0 or not reservations_active():
        _tls.depth = depth + 1
        try:
            yield False
        finally:
            _tls.depth = depth
        return
    RmmSpark.alloc(nbytes)
    mark = None
    _tls.depth = depth + 1
    try:
        # optional audit (rmm.validate_hbm): sample the caching
        # allocator's counters around the bracket — see memory/hbm.py
        if hbm.enabled():
            mark = hbm.bracket_begin()
        yield True
    finally:
        _tls.depth = depth
        if mark is not None:
            hbm.bracket_end(mark, nbytes)
        RmmSpark.dealloc(nbytes)


def cuda_tensors(obj):
    """Every CUDA tensor in ``obj``: tensors, Columns, Tables, and lists,
    tuples and dicts of them (a donated Table holds none)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from cuda_tensors(o)
    elif isinstance(obj, dict):
        yield from cuda_tensors(list(obj.values()))
    elif isinstance(obj, Table):
        if not obj.is_donated:
            yield from cuda_tensors(obj.columns)
    elif isinstance(obj, Column):
        yield from cuda_tensors([obj.data, obj.validity, obj.offsets,
                                 obj.children])


def release_barrier(result, took: bool):
    """Synchronize before a reservation release.

    Kernel launches are asynchronous: an op returns while its kernels are
    still queued, so releasing the reservation at Python-return time would
    let the next op launch against memory the previous one still
    occupies. When a reservation was actually taken (``took``), wait for
    the current stream of each device the result lives on, so the release
    reflects real occupancy. Otherwise — and on the CPU — nothing is
    waited on: the ungoverned path stays free of host syncs.
    """
    if took:
        for dev in {t.device for t in cuda_tensors(result)}:
            torch.cuda.current_stream(dev).synchronize()
    return result
