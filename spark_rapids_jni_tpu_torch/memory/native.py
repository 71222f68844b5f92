"""ctypes loader for the native resource adaptor (libsparkrm.so), the
port's own (the JAX package's memory/native.py: the same C ABI and
signatures).

The reference ships its native layer inside the jar and loads it via
NativeDepsLoader (reference: ParquetFooter.java:28-30). Here the shared
library is built from ``native/resource_adaptor.cpp`` (read, never
edited) with g++ at first use into ``build/torch_native/libsparkrm.so`` at
the root of the checkout, apart from the JAX package's build. The C ABI
replaces the JNI shim layer (reference layer L3, SURVEY.md §1).
``native.so_override`` (``SRJT_NATIVE_SO_OVERRIDE``) loads a prebuilt
library instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "resource_adaptor.cpp"
_SO = _REPO_ROOT / "build" / "torch_native" / "libsparkrm.so"

_lock = threading.Lock()
_lib = None

# external blocked-thread query: int cb(long engine_thread_id) -> 0/1
# (ThreadStateRegistry analog; see rmm_spark.py)
EXT_BLOCKED_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_long)


class NativeBuildError(RuntimeError):
    """g++ could not build the resource adaptor; ``brief`` is the first
    error line of its output."""

    def __init__(self, message: str, brief: str):
        super().__init__(message)
        self.brief = brief


def _build() -> None:
    _SO.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename: processes that build at once
    # (test workers) never load a half-written library
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-Wall",
           "-o", str(tmp), str(_SRC), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        brief = next((ln for ln in proc.stderr.splitlines()
                      if "error" in ln.lower()), "g++ failed")
        raise NativeBuildError(
            f"failed to build {_SO} from {_SRC}:\n{proc.stderr}",
            brief.strip())
    os.replace(tmp, _SO)


def _stale() -> bool:
    return (not _SO.exists()
            or _SRC.stat().st_mtime > _SO.stat().st_mtime)


def so_path() -> Path:
    """Where the library is built."""
    return _SO


def load() -> ctypes.CDLL:
    """Load (building if needed) the native library and declare its
    signatures."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from ..utils import config
        override = config.get("native.so_override")
        if override:
            lib = ctypes.CDLL(override)
        else:
            if _stale():
                _build()
            lib = ctypes.CDLL(str(_SO))

        c = ctypes
        lib.rm_create.restype = c.c_void_p
        lib.rm_create.argtypes = [c.c_longlong, c.c_char_p]
        lib.rm_destroy.restype = None
        lib.rm_destroy.argtypes = [c.c_void_p]

        def fn(name, restype, *argtypes):
            f = getattr(lib, name)
            f.restype = restype
            f.argtypes = list(argtypes)

        H, L, LL, I = c.c_void_p, c.c_long, c.c_longlong, c.c_int
        fn("rm_start_dedicated_task_thread", I, H, L, L)
        fn("rm_pool_thread_working_on_task", I, H, L, L)
        fn("rm_pool_thread_finished_for_tasks", I, H, L,
           c.POINTER(c.c_long), I)
        fn("rm_start_shuffle_thread", I, H, L)
        fn("rm_remove_thread_association", I, H, L, L)
        fn("rm_task_done", I, H, L)
        fn("rm_start_retry_block", I, H, L)
        fn("rm_end_retry_block", I, H, L)
        fn("rm_force_oom", I, H, L, I, I, I, I)
        fn("rm_alloc", I, H, L, LL)
        fn("rm_dealloc", I, H, L, LL)
        fn("rm_cpu_prealloc", I, H, L, LL, I)
        fn("rm_cpu_postalloc_success", I, H, L, LL)
        fn("rm_cpu_postalloc_failed", I, H, L, I, I)
        fn("rm_cpu_dealloc", I, H, L, LL)
        fn("rm_block_thread_until_ready", I, H, L)
        fn("rm_submitting_to_pool", I, H, L, I)
        fn("rm_waiting_on_pool", I, H, L, I)
        fn("rm_check_and_break_deadlocks", I, H)
        lib.rm_set_external_blocked_cb.restype = None
        lib.rm_set_external_blocked_cb.argtypes = [H, EXT_BLOCKED_CB]
        fn("rm_get_state_of", I, H, L)
        fn("rm_get_metric", LL, H, L, I, I)
        fn("rm_pool_used", LL, H)
        fn("rm_pool_limit", LL, H)

        _lib = lib
        return _lib
