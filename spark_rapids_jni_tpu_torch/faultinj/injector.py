"""Fault injector core (the JAX package's faultinj/injector.py; its
``_TARGETS`` name this package's op entry points).

JSON config schema mirrors the reference exactly (faultinj/README.md:61-170):

```json
{
  "logLevel": 1,
  "dynamic": true,
  "xlaRuntimeFaults": {
    "murmur_hash3_32": {"percent": 50, "injectionType": 0,
                         "interceptionCount": 10},
    "*": {"percent": 1, "injectionType": 2, "substituteReturnCode": 999,
           "interceptionCount": 1000}
  }
}
```

``cudaRuntimeFaults``/``cudaDriverFaults`` sections are accepted as aliases
so reference configs can be reused verbatim. injectionType: 0 = device trap,
1 = device assert, 2 = substitute return code, 3 = payload bit-flip (XOR a
random bit of a transiting buffer — fired via the payload-aware hooks in
memory/integrity.py at the spill/disk/exchange/parquet surfaces, never via
``check``, since an API-entry checkpoint has no buffer), 4 = delay/hang
(sleep ``delayMs`` milliseconds at the call site, or hang until the watchdog
cancels when ``delayMs`` is negative — executed by
``faultinj.watchdog.injected_delay`` outside the injector lock so a hung
surface never wedges other threads' rule checks), 5 = worker crash (kill
the sandbox worker hosting the call — ``crashMode`` picks "abort"
(SIGABRT), "kill" (SIGKILL) or "exit" (os._exit with
``substituteReturnCode``); sampled parent-side by ``crash_spec`` and
executed inside the worker by faultinj/sandbox.py, so the injected fault
is real process death). An unrecognized ``injectionType`` raises a
ValueError naming the rule at load time. ``interceptionCount``
bounds how many consecutive matched calls are sampled; ``percent`` is the
per-sample probability. ``dynamic: true`` re-reads the config when its
mtime changes (the reference uses an inotify thread; polling on call entry
is equivalent for a shim).
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Dict, Optional

import numpy as np

_SECTION_KEYS = ("xlaRuntimeFaults", "cudaRuntimeFaults", "cudaDriverFaults")


class SeededRng:
    """The injector's single replayable sample stream.

    One ``numpy.random.Generator`` drives EVERY rule draw — percent
    rolls (types 0/1/2/4 via ``maybe_fire``, type 6 via ``sample_oom``
    after its skipCount/numOoms bookkeeping, type 5 via ``crash_spec``)
    and the bit-flip buffer/bit picks consumers make through
    ``bitflip_rng`` — so one integer replays a whole storm. ``.seed``
    is always a concrete logged value: chaos/fuzz verdict artifacts
    record it, and replaying with the same config + seed reproduces the
    exact fault sequence. Exposes only the draw methods rule sampling
    and the integrity hooks actually use."""

    def __init__(self, seed: Optional[int] = None):
        if seed is None:
            # no seed requested: draw fresh entropy, but KEEP it — an
            # unlogged stream would make a storm verdict unreplayable
            seed = int(np.random.SeedSequence().entropy) % (1 << 63)
        self.seed = int(seed)
        self._g = np.random.default_rng(self.seed)

    def uniform(self, lo: float, hi: float) -> float:
        return float(self._g.uniform(lo, hi))

    def randrange(self, n: int) -> int:
        return int(self._g.integers(0, n))


class DeviceTrapError(RuntimeError):
    """injectionType 0 — analog of a PTX trap killing the context."""


class DeviceAssertError(RuntimeError):
    """injectionType 1 — analog of a device-side assert."""


class InjectedApiError(RuntimeError):
    """injectionType 2 — API returned a substituted error code."""

    def __init__(self, code: int, api: str):
        super().__init__(f"injected error code {code} from {api}")
        self.code = code
        self.api = api


_KNOWN_TYPES = (
    "0=device trap, 1=device assert, 2=substituted api error, "
    "3=payload bit-flip, 4=delay/hang, 5=worker crash, 6=oom")


class _Rule:
    def __init__(self, name: str, cfg: dict):
        self.percent = float(cfg.get("percent", 0))
        self.injection_type = int(cfg.get("injectionType", 0))
        if self.injection_type not in (0, 1, 2, 3, 4, 5, 6):
            # an unrecognized type would otherwise be constructed and
            # silently never fire — a chaos config typo must fail loudly
            raise ValueError(
                f"fault config rule {name!r}: unknown injectionType "
                f"{self.injection_type} (known types: {_KNOWN_TYPES})")
        self.count_remaining = int(cfg.get("interceptionCount", 0))
        self.substitute = int(cfg.get("substituteReturnCode", 0))
        # injectionType 4: sleep this long at the call site; < 0 = hang
        # until the watchdog cancels (faultinj/watchdog.py)
        self.delay_ms = float(cfg.get("delayMs", 0))
        # injectionType 5: how the sandbox worker dies — "abort"
        # (SIGABRT, the native-trap analog), "kill" (SIGKILL), or "exit"
        # (os._exit with substituteReturnCode)
        self.crash_mode = str(cfg.get("crashMode", "abort"))
        # injectionType 6: the retry-OOM protocol's injection surface
        # (reference: RmmSpark.forceRetryOOM/forceSplitAndRetryOOM).
        # oomMode "retry" (default) demands rollback+retry, "split"
        # demands split-and-retry, "shrink" stands a poolBytes cap at the
        # matched surface so every oversized envelope must split; numOoms
        # fires that many consecutive OOMs per sampled hit, skipCount
        # skips that many matched calls before the first
        self.oom_mode = str(cfg.get("oomMode", "retry"))
        self.num_ooms = int(cfg.get("numOoms", 1))
        self.skip_remaining = int(cfg.get("skipCount", 0))
        self.pool_bytes = int(cfg.get("poolBytes", 0))
        if self.injection_type == 6 and self.oom_mode not in (
                "retry", "split", "shrink"):
            raise ValueError(
                f"fault config rule {name!r}: unknown oomMode "
                f"{self.oom_mode!r} (known: retry, split, shrink)")

    def maybe_fire(self, api: str, rng: SeededRng) -> Optional[float]:
        """Sample one matched call. Types 0-2 raise; type 4 returns the
        delay in seconds for the caller to execute OUTSIDE the injector
        lock (a hang held under the lock would wedge every other thread's
        rule check); None = nothing fired."""
        if self.injection_type in (3, 5, 6):
            return None  # payload bit-flips fire via bitflip_rng, worker
            # crashes via crash_spec, OOMs via sample_oom / oom_pool_cap —
            # each owns its budget; an exception checkpoint has no buffer
            # and no worker to kill
        if self.count_remaining <= 0:
            return None
        self.count_remaining -= 1
        if rng.uniform(0, 100) >= self.percent:
            return None
        if self.injection_type == 0:
            raise DeviceTrapError(f"injected trap at {api}")
        if self.injection_type == 1:
            raise DeviceAssertError(f"injected device assert at {api}")
        if self.injection_type == 4:
            return -1.0 if self.delay_ms < 0 else self.delay_ms / 1000.0
        raise InjectedApiError(self.substitute, api)

    def sample_oom(self, rng: SeededRng) -> Optional[dict]:
        """injectionType 6 sampling (retry/split modes) for one matched
        call: honor skipCount, then interceptionCount + percent like
        every other type. Returns the OOM directive for ``check`` to
        fire OUTSIDE the lock, or None."""
        if self.oom_mode == "shrink":
            return None  # standing cap; consulted via oom_pool_cap
        if self.skip_remaining > 0:
            self.skip_remaining -= 1
            return None
        if self.count_remaining <= 0:
            return None
        self.count_remaining -= 1
        if rng.uniform(0, 100) >= self.percent:
            return None
        return {"mode": self.oom_mode, "num_ooms": max(1, self.num_ooms)}


class FaultInjector:
    def __init__(self, config_path: Optional[str] = None, seed: int = None):
        from ..utils import config as _config
        self._path = config_path or _config.get("faultinj.config") or None
        self._rng = SeededRng(seed)
        self._lock = threading.Lock()
        self._rules: Dict[str, _Rule] = {}
        self._dynamic = False
        self._mtime = 0.0
        self._last_check = 0.0
        self._patched = []
        self._warned_conflicts = False
        if self._path:
            self._load()

    @property
    def seed(self) -> int:
        """The sample stream's seed — verdict artifacts log this."""
        return self._rng.seed

    # -- config ---------------------------------------------------------

    def _load(self):
        try:
            with open(self._path) as f:
                cfg = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        rules: Dict[str, _Rule] = {}
        conflicts = []
        for section in _SECTION_KEYS:
            for name, rule_cfg in (cfg.get(section) or {}).items():
                if name in rules:
                    # overlapping rules (same surface declared in two
                    # sections): DECLARATION ORDER WINS — the first
                    # section (xlaRuntimeFaults > cudaRuntimeFaults >
                    # cudaDriverFaults) keeps the surface; a silent
                    # last-wins overwrite made storm composition depend
                    # on section spelling
                    conflicts.append(f"{name!r} (kept the "
                                     f"earlier-declared rule)")
                    continue
                rules[name] = _Rule(name, rule_cfg)
        warn = False
        if conflicts:
            with self._lock:
                warn = not self._warned_conflicts
                self._warned_conflicts = True
        if warn:                     # once per injector, outside the lock
            warnings.warn(
                "fault config declares overlapping rules across sections: "
                + ", ".join(conflicts), RuntimeWarning, stacklevel=2)
        with self._lock:
            self._rules = rules
            self._dynamic = bool(cfg.get("dynamic", False))
            try:
                self._mtime = os.path.getmtime(self._path)
            except OSError:
                self._mtime = 0.0

    def _maybe_reload(self):
        if not self._dynamic or not self._path:
            return
        now = time.monotonic()
        if now - self._last_check < 0.05:
            return
        self._last_check = now
        try:
            m = os.path.getmtime(self._path)
        except OSError:
            return
        if m != self._mtime:
            self._load()

    # -- interception ---------------------------------------------------

    def check(self, api: str):
        """Consult the rules for one API call (may raise, may block on an
        injectionType 4 delay/hang — the block happens outside the lock)."""
        self._maybe_reload()
        oom = None
        with self._lock:
            rule = self._rules.get(api) or self._rules.get("*")
            if rule is None:
                return
            if rule.injection_type == 6:
                delay_s = None
                oom = rule.sample_oom(self._rng)
            else:
                delay_s = rule.maybe_fire(api, self._rng)
        if oom is not None:
            _fire_oom(api, oom)
        if delay_s is not None:
            from . import watchdog
            watchdog.injected_delay(api, delay_s)

    def bitflip_rng(self, api: str) -> Optional[SeededRng]:
        """injectionType 3 sampling for one payload-bearing call: when a
        bit-flip rule targets ``api`` (or ``*``) and its budget + percent
        roll fire, return the injector's RNG for the caller to pick the
        buffer/bit (memory/integrity.py hooks). None = no flip."""
        self._maybe_reload()
        with self._lock:
            rule = self._rules.get(api) or self._rules.get("*")
            if rule is None or rule.injection_type != 3:
                return None
            if rule.count_remaining <= 0:
                return None
            rule.count_remaining -= 1
            if self._rng.uniform(0, 100) >= rule.percent:
                return None
            return self._rng

    def crash_spec(self, api: str) -> Optional[dict]:
        """injectionType 5 sampling for one sandboxed call: when a crash
        rule targets ``api`` (or ``*``) and its budget + percent roll
        fire, return the crash directive ({"mode", "code"}) for
        faultinj/sandbox.py to ship to the worker — the directive is
        sampled HERE in the parent but executed INSIDE the worker
        (os.abort/SIGKILL/exit), so the injected fault is real process
        death, not a simulated exception. None = no crash."""
        self._maybe_reload()
        with self._lock:
            rule = self._rules.get(api) or self._rules.get("*")
            if rule is None or rule.injection_type != 5:
                return None
            if rule.count_remaining <= 0:
                return None
            rule.count_remaining -= 1
            if self._rng.uniform(0, 100) >= rule.percent:
                return None
            return {"mode": rule.crash_mode, "code": rule.substitute or 1}

    def oom_pool_cap(self, api: str) -> Optional[int]:
        """injectionType 6 shrinking-pool mode: the standing byte cap a
        matched surface's reservation envelope must fit under, or demand
        a split (consulted by plan/executor.py before dispatch). NOT
        sampled — no budget decrement, no percent roll: the pool IS that
        small for as long as the rule stands, which is what makes splits
        mandatory rather than probabilistic. None = no cap."""
        self._maybe_reload()
        with self._lock:
            rule = self._rules.get(api) or self._rules.get("*")
            if (rule is None or rule.injection_type != 6
                    or rule.oom_mode != "shrink" or rule.pool_bytes <= 0):
                return None
            return rule.pool_bytes

    def wrap(self, fn, api: str):
        def wrapper(*a, **kw):
            self.check(api)
            return fn(*a, **kw)
        wrapper.__name__ = getattr(fn, "__name__", api)
        wrapper.__wrapped_for_faultinj__ = fn
        return wrapper

    # -- framework instrumentation --------------------------------------

    # device-entry points patched at install; name → (module path, attr)
    _TARGETS = [
        ("spark_rapids_jni_tpu_torch.ops.hashing", "murmur_hash3_32"),
        ("spark_rapids_jni_tpu_torch.ops.hashing", "xxhash64"),
        ("spark_rapids_jni_tpu_torch.ops.row_conversion", "convert_to_rows"),
        ("spark_rapids_jni_tpu_torch.ops.row_conversion",
         "convert_from_rows"),
        ("spark_rapids_jni_tpu_torch.ops.cast_float_to_string",
         "float_to_string"),
        ("spark_rapids_jni_tpu_torch.ops.get_json_object",
         "get_json_object"),
        ("spark_rapids_jni_tpu_torch.ops.sort", "sort_order"),
    ]

    def install(self):
        """Wrap the framework's device-entry functions (the CUPTI-subscribe
        analog). Idempotent; ``uninstall`` restores originals."""
        import importlib
        for mod_name, attr in self._TARGETS:
            try:
                mod = importlib.import_module(mod_name)
            except ImportError:
                continue
            fn = getattr(mod, attr, None)
            if fn is None or hasattr(fn, "__wrapped_for_faultinj__"):
                continue
            setattr(mod, attr, self.wrap(fn, attr))
            self._patched.append((mod, attr, fn))

    def uninstall(self):
        for mod, attr, fn in self._patched:
            setattr(mod, attr, fn)
        self._patched.clear()


def _fire_oom(api: str, spec: dict) -> None:
    """Execute one fired injectionType 6 rule (retry/split modes),
    OUTSIDE the injector lock. When the RmmSpark adaptor is installed
    and the calling thread is registered, the injection RIDES THE REAL
    STATE MACHINE (``force_retry_oom``/``force_split_and_retry_oom`` on
    the current thread id — the next reservation alloc raises through
    the native BUFN ladder, exactly the reference path). Otherwise the
    mapped exception is raised synthetically at the checkpoint; both
    routes land in ``memory.retry.with_retry`` via the fault-domain
    supervisor's RESOURCE_EXHAUSTED classification."""
    from ..memory.exceptions import TpuRetryOOM, TpuSplitAndRetryOOM
    from ..memory.rmm_spark import RmmSpark
    from .guard import metrics
    metrics.bump("injected_ooms")
    want_split = spec["mode"] == "split"
    if RmmSpark.is_installed():
        try:
            tid = RmmSpark.get_current_thread_id()
            if want_split:
                RmmSpark.force_split_and_retry_oom(tid, spec["num_ooms"])
            else:
                RmmSpark.force_retry_oom(tid, spec["num_ooms"])
            return  # the next alloc on this thread raises the real OOM
        except RuntimeError:
            pass  # thread not registered with the adaptor: fire synthetic
    if want_split:
        raise TpuSplitAndRetryOOM(f"injected split-and-retry OOM at {api}")
    raise TpuRetryOOM(f"injected retry OOM at {api}")


_global: Optional[FaultInjector] = None


def get_injector() -> Optional[FaultInjector]:
    return _global


def oom_pool_cap(api: str) -> Optional[int]:
    """Module-level convenience for reservation-envelope call sites
    (plan/executor.py): the standing injected pool cap for ``api``, or
    None when no injector/shrink rule stands."""
    return _global.oom_pool_cap(api) if _global is not None else None


def install(config_path: Optional[str] = None, seed: int = None) -> FaultInjector:
    global _global
    if _global is not None:
        _global.uninstall()
    _global = FaultInjector(config_path, seed)
    _global.install()
    return _global


def uninstall():
    global _global
    if _global is not None:
        _global.uninstall()
        _global = None


def fault_point(api: str):
    """Explicit checkpoint for code paths not covered by install()."""
    if _global is not None:
        _global.check(api)
