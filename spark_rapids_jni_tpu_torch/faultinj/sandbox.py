"""The crash domain's error types (the JAX package's faultinj/sandbox.py,
where they are defined).

``guard.classify`` needs both: a sandbox worker's death is the CRASH
fault domain, and an input that keeps killing workers is quarantined and
handled like CORRUPTION. The rest of the JAX package's sandbox.py — the
supervised worker subprocesses that host the native parse_uri and Parquet
tiers, with its breaker.py, _sandbox_targets.py and _sandbox_worker.py —
waits for those tiers (ROADMAP A11b, A13/A14); nothing in this package
raises these errors yet.
"""

from __future__ import annotations

from typing import Optional

from ..memory.integrity import CorruptionError


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
