"""Per-surface circuit breakers: cheap routing around a persistently
broken dispatch surface (the JAX package's faultinj/breaker.py).

The fault-domain supervisor (guard.py) pays a retry/backoff/respawn ladder
PER CALL — correct for isolated faults, ruinous when a surface is broken
for minutes (a corrupt library build, a wedged device, a native bug that
crashes every sandbox worker). The breaker is the layer above: after
``breaker.threshold`` failures within ``breaker.window_s`` the surface's
breaker OPENS and callers route straight to their degraded path (host
decode, in-process fallback) at the cost of one state read, no ladder.
After ``breaker.cooldown_s`` the breaker goes HALF-OPEN and admits exactly
one probe: success closes it (device path re-enabled), failure re-opens it
with a fresh cooldown.

State is per-surface (keyed by the guarded api name), never global — a
broken parse_uri must not take parquet decode down with it. Transitions
are observable: ``breaker_opened`` / ``breaker_closed`` count in the
fault-domain metrics, and ``states()`` snapshots every breaker.

Reference analog: the spark-rapids plugin escalates repeated GPU failures
to node-level blacklisting via Spark's scheduler; a per-surface breaker is
that policy at dispatch-surface granularity.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


def _limits():
    from ..utils import config
    return (bool(config.get("breaker.enabled")),
            int(config.get("breaker.threshold")),
            float(config.get("breaker.window_s")),
            float(config.get("breaker.cooldown_s")))


class CircuitBreaker:
    """closed → open → half-open state machine for one dispatch surface.

    Thread-safe; limits are read from config at decision time so test
    overrides apply to live breakers."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures: List[float] = []  # monotonic timestamps
        self._opened_at = 0.0
        self._probing = False
        self._last_hint = 0.0   # previous retry hint (decorrelated jitter)
        self._rng = random.Random(id(self) ^ 0x5273_4A54)
        self.opened_count = 0
        self.closed_count = 0

    def _metrics(self):
        from .guard import metrics
        return metrics

    def allow(self) -> bool:
        """True = dispatch the guarded/sandboxed path; False = take the
        degraded path. A HALF_OPEN breaker admits exactly one in-flight
        probe; its outcome (record_success/record_failure) decides the
        next state."""
        enabled, threshold, _window, cooldown = _limits()
        if not enabled or threshold <= 0:
            return True
        with self._lock:
            if self._state == CLOSED:
                return True
            now = time.monotonic()
            if self._state == OPEN:
                if now - self._opened_at < cooldown:
                    return False
                self._state = HALF_OPEN
                self._probing = True
                return True
            # HALF_OPEN: one probe at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self):
        with self._lock:
            self._probing = False
            if self._state == HALF_OPEN:
                self._state = CLOSED
                self._failures.clear()
                self.closed_count += 1
                bump_closed = True
            else:
                if self._state == CLOSED:
                    self._failures.clear()
                bump_closed = False
        if bump_closed:
            self._metrics().bump("breaker_closed")

    def record_failure(self):
        enabled, threshold, window, _cooldown = _limits()
        now = time.monotonic()
        with self._lock:
            self._probing = False
            if self._state == HALF_OPEN:
                # failed probe: re-open with a FRESH cooldown
                self._state = OPEN
                self._opened_at = now
                self.opened_count += 1
                bump_open = True
            elif self._state == CLOSED and enabled and threshold > 0:
                self._failures.append(now)
                if window > 0:
                    cutoff = now - window
                    self._failures = [t for t in self._failures
                                      if t >= cutoff]
                bump_open = len(self._failures) >= threshold
                if bump_open:
                    self._state = OPEN
                    self._opened_at = now
                    self._failures.clear()
                    self.opened_count += 1
            else:
                bump_open = False  # already OPEN (late failure from an
                # in-flight call) — no transition
        if bump_open:
            self._metrics().bump("breaker_opened")

    def state(self) -> str:
        with self._lock:
            return self._state

    def retry_after_s(self) -> float:
        """Seconds until an OPEN breaker starts admitting probes: the
        retry-after hint a front door attaches to shed load (0.0 when not
        OPEN, so callers can pass it through unguarded).

        With ``breaker.retry_jitter`` on (default), hints carry
        decorrelated jitter: each is drawn uniformly from [remaining
        cooldown, 3x the previous hint], clamped to one extra cooldown.
        Synchronized clients that were all shed at the same instant then
        retry staggered instead of stampeding the single half-open probe
        slot — and every concurrent rejection gets a distinct hint."""
        from ..utils import config
        _enabled, _threshold, _window, cooldown = _limits()
        with self._lock:
            if self._state != OPEN:
                self._last_hint = 0.0
                return 0.0
            base = max(0.0, cooldown
                       - (time.monotonic() - self._opened_at))
            if not bool(config.get("breaker.retry_jitter")):
                return base
            hi = min(base + cooldown, max(base, 3.0 * self._last_hint))
            hint = self._rng.uniform(base, hi) if hi > base else \
                base + self._rng.uniform(0.0, max(cooldown, 1e-3))
            self._last_hint = hint
            return hint


_breakers: Dict[str, CircuitBreaker] = {}
_lock = threading.Lock()


def get_breaker(name: str) -> CircuitBreaker:
    with _lock:
        br = _breakers.get(name)
        if br is None:
            br = CircuitBreaker(name)
            _breakers[name] = br
        return br


def states(non_closed_only: bool = False) -> Dict[str, str]:
    """Snapshot of every breaker's state (diagnostics)."""
    with _lock:
        items = list(_breakers.items())
    out = {name: br.state() for name, br in items}
    if non_closed_only:
        out = {k: v for k, v in out.items() if v != CLOSED}
    return out


def reset_all() -> None:
    """Forget every breaker (test isolation)."""
    with _lock:
        _breakers.clear()


def lookup(name: str) -> Optional[CircuitBreaker]:
    with _lock:
        return _breakers.get(name)
