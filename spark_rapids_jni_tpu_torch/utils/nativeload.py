"""Build-or-load helper for the port's ctypes native libraries (the JAX
package's utils/nativeload.py).

One place owns the compile recipe (g++ flags, staleness check, error
surface) so the per-subsystem loaders (the Parquet footer and decode
libraries) cannot drift apart. Sources are read from ``native/`` at the
root of the checkout and never edited; each library is built with g++ at
first use into ``build/torch_native/`` beside the resource adaptor's
``libsparkrm.so`` (memory/native.py, which keeps its own loader). The JAX
package's prebuilt libraries under ``spark_rapids_jni_tpu/_native/`` are
never loaded.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC_DIR = _REPO_ROOT / "native"
BUILD_DIR = _REPO_ROOT / "build" / "torch_native"

_lock = threading.Lock()
_cache = {}
# so_name -> (dependency mtime signature, NativeBuildError): a failed build
# is deterministic for unchanged sources, so it is re-raised, not re-run
_failed = {}


class NativeBuildError(RuntimeError):
    """g++ could not build a native library (a property of the host's
    toolchain, not of the code). ``so_name`` names the library, ``brief``
    is the first error line of the compiler's output."""

    def __init__(self, message: str, so_name: str, brief: str):
        super().__init__(message)
        self.so_name = so_name
        self.brief = brief


def so_path(so_name: str) -> Path:
    """Where ``so_name`` is built."""
    return BUILD_DIR / so_name


def load_native(src_name: str, so_name: str,
                extra_deps: Sequence[str] = (),
                link: Sequence[str] = ()) -> ctypes.CDLL:
    """Build ``native/<src_name>`` into ``build/torch_native/<so_name>``
    when the library is missing or older than the source or one of
    ``extra_deps`` (names under ``native/``), then load it. Callers
    declare the ctypes signatures; repeated calls return the cached
    handle."""
    with _lock:
        lib = _cache.get(so_name)
        if lib is not None:
            return lib
        src = _SRC_DIR / src_name
        so = so_path(so_name)
        deps = [src] + [_SRC_DIR / d for d in extra_deps]
        stale = (not so.exists() or any(
            d.stat().st_mtime > so.stat().st_mtime for d in deps))
        if stale:
            sig = tuple(d.stat().st_mtime for d in deps)
            prior = _failed.get(so_name)
            if prior is not None and prior[0] == sig:
                raise prior[1]
            so.parent.mkdir(parents=True, exist_ok=True)
            # build beside the target and rename: processes that build at
            # once (test workers) never load a half-written library
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = ["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-Wall",
                   "-o", str(tmp), str(src), *link]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                lines = proc.stderr.splitlines()
                brief = next((ln for ln in lines if "error" in ln.lower()),
                             lines[0] if lines else "g++ failed")
                err = NativeBuildError(
                    f"failed to build {so} from {src}:\n{proc.stderr}",
                    so_name, brief.strip())
                _failed[so_name] = (sig, err)
                raise err
            os.replace(tmp, so)
            _failed.pop(so_name, None)
        lib = ctypes.CDLL(str(so))
        _cache[so_name] = lib
        return lib
