"""Memory arbitration (the JAX package's memory/): the rebuild of the
reference's SparkResourceAdaptor / RmmSpark retry-OOM scheduler
(SURVEY.md §5.3), with the spill store and the integrity layer.

Public surface:

* :class:`RmmSpark` — static facade (thread/task registration, device
  reservations, CPU alloc hooks, OOM injection, metrics).
* :class:`SparkResourceAdaptor` — handle owner + deadlock watchdog.
* :class:`ThreadState` — thread-state enum mirror.
* the OOM exception taxonomy (``TpuRetryOOM``, ``TpuSplitAndRetryOOM``,
  ``CpuRetryOOM``, ``CpuSplitAndRetryOOM``, ``TpuOOM``, ...).
* :func:`with_retry` — the retry loop implementing the contract the
  exceptions encode (roll back / split).
* :func:`device_reservation` / :func:`release_barrier` — the op brackets.
* :class:`SpillStore` / :class:`SpillableTable` — spill to host tensors
  and a checksummed disk tier (memory/transport.py).
"""

from .exceptions import (
    CpuRetryOOM,
    CpuSplitAndRetryOOM,
    OffHeapOOM,
    RetryStateException,
    TaskRemovedException,
    TpuOOM,
    TpuRetryOOM,
    TpuSplitAndRetryOOM,
)
from .reservation import device_reservation, release_barrier
from .retry import with_retry
from .rmm_spark import OOM_MODE_CPU, OOM_MODE_TPU, RmmSpark, SparkResourceAdaptor, ThreadState
from .transport import SpillableTable, SpillStore, rollback_all_stores

__all__ = [
    "CpuRetryOOM",
    "CpuSplitAndRetryOOM",
    "OffHeapOOM",
    "OOM_MODE_CPU",
    "OOM_MODE_TPU",
    "RetryStateException",
    "RmmSpark",
    "SparkResourceAdaptor",
    "SpillStore",
    "SpillableTable",
    "TaskRemovedException",
    "ThreadState",
    "TpuOOM",
    "TpuRetryOOM",
    "TpuSplitAndRetryOOM",
    "device_reservation",
    "release_barrier",
    "rollback_all_stores",
    "with_retry",
]
