"""OOM exception taxonomy for the retry scheduler (the JAX package's
memory/exceptions.py, names kept so that both packages speak one
protocol).

Mirrors the reference's Java exception classes thrown from native code
(reference: GpuOOM.java, GpuRetryOOM.java, GpuSplitAndRetryOOM.java,
CpuRetryOOM.java, CpuSplitAndRetryOOM.java, OffHeapOOM.java;
SparkResourceAdaptorJni.cpp:36-41 caches the class refs). The semantic
contract is identical:

* ``*RetryOOM``          — roll back to a spillable state and retry the work.
* ``*SplitAndRetryOOM``  — rolling back wasn't enough; split the input
                           (e.g. halve the batch) and retry.
* ``TpuOOM``             — fatal: the framework gave up (retry cap exceeded or
                           the request can never fit the pool).

"Tpu" replaces "Gpu" for the device-memory domain (device reservations)
in both packages; on the H100 it names the card's memory.
"""


class TpuOOM(MemoryError):
    """Fatal device-memory OOM — not retryable."""


class TpuRetryOOM(TpuOOM):
    """Roll back to a spillable state and retry (device domain)."""


class TpuSplitAndRetryOOM(TpuOOM):
    """Split the input and retry (device domain)."""


class OffHeapOOM(MemoryError):
    """Base for host off-heap OOMs."""


class CpuRetryOOM(OffHeapOOM):
    """Roll back to a spillable state and retry (host domain)."""


class CpuSplitAndRetryOOM(OffHeapOOM):
    """Split the input and retry (host domain)."""


class RetryStateException(RuntimeError):
    """Injected framework exception (test fault injection) or invalid use of
    the thread-state machine."""


class TaskRemovedException(RuntimeError):
    """The task was purged while one of its threads was blocked."""


# status codes shared with native/resource_adaptor.cpp (enum rm_status)
RM_OK = 0
RM_RETRY_OOM = 1
RM_SPLIT_AND_RETRY_OOM = 2
RM_CPU_RETRY_OOM = 3
RM_CPU_SPLIT_AND_RETRY_OOM = 4
RM_FATAL_OOM = 5
RM_INJECTED_EXCEPTION = 6
RM_TASK_REMOVED = 7
RM_INVALID = -1

_CODE_TO_EXC = {
    RM_RETRY_OOM: TpuRetryOOM,
    RM_SPLIT_AND_RETRY_OOM: TpuSplitAndRetryOOM,
    RM_CPU_RETRY_OOM: CpuRetryOOM,
    RM_CPU_SPLIT_AND_RETRY_OOM: CpuSplitAndRetryOOM,
    RM_FATAL_OOM: TpuOOM,
    RM_INJECTED_EXCEPTION: RetryStateException,
    RM_TASK_REMOVED: TaskRemovedException,
    RM_INVALID: RetryStateException,
}


def raise_for_status(code: int, context: str = "") -> None:
    """Map a native status code to the exception taxonomy ("throw across the
    C ABI boundary", the ctypes analog of the reference's JNI throw at
    CastStringJni.cpp-style CATCH blocks)."""
    if code == RM_OK:
        return
    exc = _CODE_TO_EXC.get(code, RetryStateException)
    raise exc(context or f"resource adaptor status {code}")
