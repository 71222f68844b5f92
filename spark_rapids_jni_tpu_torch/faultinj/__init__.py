"""Fault injection and fault domains (the JAX package's faultinj/;
reference: faultinj/faultinj.cu).

The reference ships ``libcufaultinj.so``: a CUPTI callback that matches CUDA
API calls by name / callback id / ``*`` with probability + count settings
from a JSON config (hot-reloadable), then injects traps, device asserts, or
substituted return codes (faultinj/README.md:61-170).

Here, as in the JAX package, the framework's device-entry points are known
functions: the injector wraps them at install time and consults the same
JSON schema (``FAULT_INJECTOR_CONFIG_PATH``) before each call.
injectionType 0/1 raise device-style errors; type 2 raises
``InjectedApiError(substituteReturnCode)``; type 3 flips one bit of a
transiting payload (the ``memory/integrity.py`` hooks at the
spill/unspill/disk surfaces) so the checksum detectors are provable end to
end; type 4 injects a ``delayMs`` sleep or (``delayMs < 0``) a permanent
hang at the call site so the deadline/watchdog subsystem (``watchdog.py``)
is provable the same way; type 5 kills the sandbox worker that hosts a
native dispatch (``sandbox.py``, behind per-surface circuit breakers in
``breaker.py``); type 6 injects retry/split OOMs or a standing pool cap (``oom_pool_cap``).
"""

from .injector import (
    DeviceAssertError,
    DeviceTrapError,
    FaultInjector,
    InjectedApiError,
    fault_point,
    get_injector,
    install,
    oom_pool_cap,
    uninstall,
)
from .guard import (
    FaultStormError,
    ProgramPoisonedError,
    classify,
    degraded,
    degraded_mode,
    guarded_dispatch,
    metrics,
)
from .watchdog import (
    CancelToken,
    Deadline,
    DeadlineExceededError,
    StallCancelledError,
)
from .sandbox import QuarantinedInputError, WorkerCrashError
from . import breaker, sandbox, watchdog

__all__ = [
    "CancelToken",
    "QuarantinedInputError",
    "WorkerCrashError",
    "Deadline",
    "DeadlineExceededError",
    "DeviceAssertError",
    "DeviceTrapError",
    "FaultInjector",
    "FaultStormError",
    "InjectedApiError",
    "ProgramPoisonedError",
    "StallCancelledError",
    "classify",
    "degraded",
    "degraded_mode",
    "fault_point",
    "get_injector",
    "guarded_dispatch",
    "install",
    "metrics",
    "oom_pool_cap",
    "uninstall",
    "breaker",
    "sandbox",
    "watchdog",
]
