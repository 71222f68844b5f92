"""The port's fault domains against the JAX package's: ``classify`` over a
table of exceptions (a CUDA out-of-memory error included), the injector's
JSON rules of every type under one seed, ``guarded_dispatch``'s transient
and poison ladders, the watchdog's deadline on an injected hang, the
injector's patched op entry points, and the guard freeing the failed
attempt's tensors before it re-raises a CUDA OOM as ``TpuRetryOOM``.

Each package keeps its own injector, metrics and watchdog; both are reset
around every test.
"""

import gc
import json
import weakref

import pytest
import torch

from spark_rapids_jni_tpu import faultinj as JF
from spark_rapids_jni_tpu.faultinj import guard as JGD
from spark_rapids_jni_tpu.faultinj import injector as JI
from spark_rapids_jni_tpu.faultinj import sandbox as JSB
from spark_rapids_jni_tpu.faultinj import watchdog as JW
from spark_rapids_jni_tpu.memory import exceptions as JE
from spark_rapids_jni_tpu.memory import integrity as JIN
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import faultinj as PF
from spark_rapids_jni_tpu_torch.faultinj import guard as PGD
from spark_rapids_jni_tpu_torch.faultinj import injector as PI
from spark_rapids_jni_tpu_torch.faultinj import sandbox as PSB
from spark_rapids_jni_tpu_torch.faultinj import watchdog as PW
from spark_rapids_jni_tpu_torch.memory import exceptions as PE
from spark_rapids_jni_tpu_torch.memory import integrity as PIN
from spark_rapids_jni_tpu_torch.ops import hashing as PH
from spark_rapids_jni_tpu_torch.utils import config as pconfig

PKGS = {
    "jax": dict(F=JF, G=JGD, I=JI, SB=JSB, W=JW, E=JE, IN=JIN, C=jconfig),
    "port": dict(F=PF, G=PGD, I=PI, SB=PSB, W=PW, E=PE, IN=PIN, C=pconfig),
}
FAST = {"faultinj.backoff_base_s": 0.0002, "faultinj.backoff_max_s": 0.002,
        "watchdog.poll_period_s": 0.02}


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS.values():
        p["G"].metrics.reset()
        p["W"].reset()
    yield
    for p in PKGS.values():
        p["I"].uninstall()
        p["G"].metrics.reset()
        p["W"].reset()


def _fast(C):
    import contextlib
    stack = contextlib.ExitStack()
    for k, v in FAST.items():
        stack.enter_context(C.override(k, v))
    return stack


def _write(tmp_path, name, cfg):
    p = tmp_path / name
    p.write_text(json.dumps(cfg))
    return str(p)


# ---------------------------------------------------------------------------
# classify
# ---------------------------------------------------------------------------

def _exceptions(p):
    E, I, W, SB, IN = p["E"], p["I"], p["W"], p["SB"], p["IN"]
    return [
        E.TpuRetryOOM("x"), E.TpuSplitAndRetryOOM("x"), E.TpuOOM("x"),
        E.CpuRetryOOM("x"), E.OffHeapOOM("x"), MemoryError("host"),
        I.DeviceTrapError("t"), I.DeviceAssertError("a"),
        I.InjectedApiError(7, "api"),
        p["G"].FaultStormError("api", 3, RuntimeError("u")),
        p["G"].ProgramPoisonedError("api", 2, RuntimeError("p")),
        IN.CorruptionError("bad crc"),
        SB.WorkerCrashError("api", "SIGSEGV", signum=11),
        SB.QuarantinedInputError("api", "k", 3),
        W.DeadlineExceededError("task", 1.0), W.StallCancelledError("s"),
        RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),
        RuntimeError("Resource exhausted: x"),
        RuntimeError("UNAVAILABLE: socket closed"),
        RuntimeError("ABORTED: retry"), RuntimeError("ABORTED: timed out"),
        RuntimeError("DEADLINE_EXCEEDED: rpc"), RuntimeError("DATA_LOSS"),
        OSError("page crc mismatch (corruption)"), RuntimeError("boom"),
        ValueError("RESOURCE_EXHAUSTED"), KeyError("k"),
        torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a "
            "total capacity of 79.10 GiB of which 1.20 GiB is free."),
    ]


def test_classify_table_matches():
    j = [JGD.classify(e) for e in _exceptions(PKGS["jax"])]
    p = [PGD.classify(e) for e in _exceptions(PKGS["port"])]
    assert p == j
    assert p[-1] == PGD.RESOURCE_EXHAUSTED
    assert len(set(p)) == 7  # every domain appears


# ---------------------------------------------------------------------------
# the injector: every rule type under one seed
# ---------------------------------------------------------------------------

RULES = {
    "xlaRuntimeFaults": {
        "trap": {"percent": 50, "injectionType": 0,
                 "interceptionCount": 12},
        "assert": {"percent": 40, "injectionType": 1,
                   "interceptionCount": 12},
        "api": {"percent": 60, "injectionType": 2,
                "substituteReturnCode": 77, "interceptionCount": 12},
        "flip": {"percent": 70, "injectionType": 3,
                 "interceptionCount": 12},
        "delay": {"percent": 50, "injectionType": 4, "delayMs": 1,
                  "interceptionCount": 12},
        "crash": {"percent": 50, "injectionType": 5, "crashMode": "kill",
                  "interceptionCount": 12},
        "oom": {"percent": 50, "injectionType": 6, "oomMode": "split",
                "skipCount": 2, "numOoms": 2, "interceptionCount": 8},
        "cap": {"injectionType": 6, "oomMode": "shrink",
                "poolBytes": 4096},
    },
    "cudaRuntimeFaults": {
        "trap": {"percent": 100, "injectionType": 1,
                 "interceptionCount": 99},
        "*": {"percent": 30, "injectionType": 2, "substituteReturnCode": 5,
              "interceptionCount": 6},
    },
}


def _firing_sequence(p, cfg_path):
    out = []
    with pytest.warns(RuntimeWarning, match="overlapping"):
        inj = p["I"].FaultInjector(cfg_path, seed=1234)
    assert inj.seed == 1234
    for i in range(14):
        for api in ("trap", "assert", "api", "delay", "oom", "other"):
            try:
                inj.check(api)
                out.append((i, api, None))
            except Exception as e:  # noqa: BLE001 - the record
                out.append((i, api, type(e).__name__, str(e)))
        rng = inj.bitflip_rng("flip")
        out.append((i, "flip", None if rng is None else rng.randrange(1000)))
        out.append((i, "crash", inj.crash_spec("crash")))
        out.append((i, "cap", inj.oom_pool_cap("cap"),
                    inj.oom_pool_cap("trap")))
    return out, p["G"].metrics.snapshot()


def test_injector_firing_sequence_matches(tmp_path):
    cfg = _write(tmp_path, "rules.json", RULES)
    j, jm = _firing_sequence(PKGS["jax"], cfg)
    p, pm = _firing_sequence(PKGS["port"], cfg)
    assert p == j
    assert pm == jm
    kinds = {r[2] for r in p if len(r) == 4}
    assert {"DeviceTrapError", "DeviceAssertError", "InjectedApiError",
            "TpuSplitAndRetryOOM"} <= kinds
    assert pm["injected_ooms"] > 0 and pm["injected_delays"] > 0


def test_unknown_injection_type_fails_loudly(tmp_path):
    cfg = _write(tmp_path, "bad.json", {"xlaRuntimeFaults": {
        "x": {"percent": 100, "injectionType": 9}}})
    msgs = []
    for p in PKGS.values():
        with pytest.raises(ValueError) as ei:
            p["I"].FaultInjector(cfg, seed=0)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "unknown injectionType 9" in msgs[1]


def test_install_wraps_the_ports_op_entry_points(tmp_path):
    """install() patches the port's targets (the JAX package's, by name:
    every one resolves since get_json_object was ported; a missing one
    would be skipped); uninstall() restores them."""
    orig = PH.murmur_hash3_32
    cfg = _write(tmp_path, "trap.json", {"xlaRuntimeFaults": {
        "murmur_hash3_32": {"percent": 100, "injectionType": 0,
                            "interceptionCount": 1}}})
    inj = PF.install(cfg, seed=0)
    try:
        patched = sorted(f"{m.__name__}.{a}" for m, a, _ in inj._patched)
        assert patched == [
            "spark_rapids_jni_tpu_torch.ops.cast_float_to_string."
            "float_to_string",
            "spark_rapids_jni_tpu_torch.ops.get_json_object."
            "get_json_object",
            "spark_rapids_jni_tpu_torch.ops.hashing.murmur_hash3_32",
            "spark_rapids_jni_tpu_torch.ops.hashing.xxhash64",
            "spark_rapids_jni_tpu_torch.ops.row_conversion.convert_from_rows",
            "spark_rapids_jni_tpu_torch.ops.row_conversion.convert_to_rows",
            "spark_rapids_jni_tpu_torch.ops.sort.sort_order"]
        from spark_rapids_jni_tpu_torch.columnar.column import Column
        col = Column.from_pylist([1, 2, 3], PH.dt.INT32, device="cpu")
        with pytest.raises(PI.DeviceTrapError):
            PH.murmur_hash3_32([col])
        assert PH.murmur_hash3_32([col]).size == 3  # the budget is spent
    finally:
        PF.uninstall()
    assert PH.murmur_hash3_32 is orig


def test_install_wraps_float_to_string_as_the_jax_injector_does(tmp_path):
    """cast_float_to_string.float_to_string is a target of both injectors:
    install() wraps it in each package, a rule naming it fires through
    the bridge's handler (which looks it up at call time), and
    uninstall() restores it."""
    from spark_rapids_jni_tpu.ops import cast_float_to_string as JCF
    from spark_rapids_jni_tpu_torch import bridge as PB
    from spark_rapids_jni_tpu_torch.ops import cast_float_to_string as PCF
    origs = (JCF.float_to_string, PCF.float_to_string)
    cfg = _write(tmp_path, "f2s.json", {"xlaRuntimeFaults": {
        "float_to_string": {"percent": 100, "injectionType": 2,
                            "substituteReturnCode": 5,
                            "interceptionCount": 1}}})
    wire = ("float64", 1, b"\x00" * 7 + b"\x40", None, None)  # 2.0
    for p, mod in ((PKGS["jax"], JCF), (PKGS["port"], PCF)):
        p["I"].install(cfg, seed=0)
        try:
            assert hasattr(mod.float_to_string, "__wrapped_for_faultinj__")
        finally:
            p["I"].uninstall()
    PI.install(cfg, seed=0)
    try:
        with pytest.raises(PI.InjectedApiError):
            PB._f2s({}, [PB.wire_to_col(wire, "cpu")], "cpu")
        out, _ = PB.call("cast.float_to_string", "{}", [wire], device="cpu")
        assert out[0][2] == b"2.0"  # the rule's one interception is spent
    finally:
        PI.uninstall()
    assert (JCF.float_to_string, PCF.float_to_string) == origs


# ---------------------------------------------------------------------------
# guarded_dispatch
# ---------------------------------------------------------------------------

def _ladder(p, kind, fails, **overrides):
    """``fails`` failures of ``kind`` then a value, through the guard;
    returns (outcome, metrics)."""
    G, I = p["G"], p["I"]
    state = {"n": 0}

    def fn(x):
        state["n"] += 1
        if state["n"] <= fails:
            if kind == "transient":
                raise I.InjectedApiError(3, "surface")
            if kind == "poison":
                raise I.DeviceTrapError("trap")
            if kind == "stall":
                raise RuntimeError("DEADLINE_EXCEEDED: rpc")
            raise RuntimeError("CUDA out of memory. Tried to allocate 1 GiB")
        return x * 2

    with _fast(p["C"]):
        try:
            out = ("ok", G.guarded_dispatch("surface", fn, 21), state["n"])
        except Exception as e:  # noqa: BLE001 - the record
            cause = e.__cause__
            out = (type(e).__name__, str(e),
                   None if cause is None else type(cause).__name__,
                   state["n"])
    snap = G.metrics.snapshot()
    snap.pop("backoff_time_ns")  # jittered sleeps
    G.metrics.reset()
    return out, snap


@pytest.mark.parametrize("kind,fails", [
    ("transient", 3), ("transient", 6), ("poison", 2), ("poison", 3),
    ("stall", 1), ("stall", 2), ("oom", 1)])
def test_guarded_dispatch_ladders_match(kind, fails):
    j = _ladder(PKGS["jax"], kind, fails)
    p = _ladder(PKGS["port"], kind, fails)
    assert p == j


def test_guarded_cuda_oom_frees_the_failed_attempt():
    """A CUDA OOM leaves the guard as TpuRetryOOM chained to it, and the
    tensors of the failed attempt's frames are gone: the traceback the
    ladder keeps pins nothing."""
    refs = []

    def attempt():
        scratch = torch.ones(1 << 16)
        refs.append(weakref.ref(scratch))
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 20.00 GiB")

    with pytest.raises(PE.TpuRetryOOM) as ei:
        PGD.guarded_dispatch("plan_execute", attempt)
    held = ei.value
    gc.collect()
    assert refs[0]() is None
    assert isinstance(held.__cause__, torch.cuda.OutOfMemoryError)
    assert "CUDA out of memory" in str(held)
    assert PGD.metrics.snapshot()["resource_exhausted"] == 1


def test_watchdog_cancels_an_injected_hang(tmp_path):
    """A permanent hang (type 4, delayMs -1) at a guarded surface under a
    0.3 s deadline: the watchdog detects it, writes one bundle and
    cancels; the caller gets StallCancelledError."""
    cfg = _write(tmp_path, "hang.json", {"xlaRuntimeFaults": {
        "h2d": {"percent": 100, "injectionType": 4, "delayMs": -1,
                "interceptionCount": 1}}})
    seen = []
    for name, p in PKGS.items():
        p["I"].install(cfg, seed=0)
        with _fast(p["C"]):
            with pytest.raises(p["W"].StallCancelledError):
                with p["W"].Deadline(0.3, "hang-test"):
                    p["G"].guarded_dispatch("h2d", lambda: 1)
        p["I"].uninstall()
        m = p["G"].metrics.snapshot()
        bundles = p["W"].last_bundles()
        seen.append((m["stall_detected"], m["stall_cancelled"],
                     m["diagnostics_bundles"], m["injected_delays"],
                     len(bundles), bundles[-1]["api"]))
        assert "spill_stores" in bundles[-1]
        assert "exchange_programs" in bundles[-1]
    assert seen[0] == seen[1] == (1, 1, 1, 1, 1, "h2d")


def test_oom_wait_keeps_the_watchdog_off_a_blocked_thread():
    with PW.oom_wait():
        assert PW.in_oom_wait()
    assert not PW.in_oom_wait()
