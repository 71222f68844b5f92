"""ctypes loader of the native parse_uri tier (native/parse_uri.cpp; the
JAX package's ops/_parse_uri_native.py): built with g++ at first use into
``build/torch_native/libsparkpuri.so`` (utils/nativeload.py)."""

from __future__ import annotations

import ctypes

from ..faultinj._sandbox_targets import declare_puri
from ..utils.nativeload import load_native

_lib = None


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = load_native("parse_uri.cpp", "libsparkpuri.so", link=["-lpthread"])
    # signatures shared with the sandbox worker's own dlopen of this .so
    _lib = declare_puri(lib)
    return _lib


def so_path() -> str:
    """The built library's path, for the sandbox worker (it dlopens the
    library by path; this process's loader built it)."""
    return load()._name
