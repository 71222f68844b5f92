"""Spark ``get_json_object(col, path)`` (the JAX package's
ops/get_json_object.py): Spark's JsonPathParser and the host PDA.

Reference surface: JSONUtils.getJsonObject with PathInstructionJni streams
of {SUBSCRIPT, WILDCARD, KEY, INDEX, NAMED} (get_json_object.hpp:36). The
host tier is native/get_json_object.cpp's ``gjo_eval``, built with g++ at
first use into ``build/torch_native/libsparkjson.so``
(utils/nativeload.py); it implements Spark's twelve evaluatePath cases
and normalizes its output (numbers re-formatted, escapes decoded,
whitespace dropped).

``get_json.tier`` picks the tier (utils/backend.py): under ``auto`` a CUDA
column takes the device tier (ops/get_json_device.py) for a KEY/INDEX
path, a CPU column the host PDA. Rows are counted in
``backend.string_routes``. Bytes that are not UTF-8 stay bytes end to end.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from enum import IntEnum
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar.column import Column
from ..utils.backend import string_routes, tier_is_device
from ..utils.tracing import func_range

_lock = threading.Lock()
_lib = None


class PathInstructionType(IntEnum):
    """The reference's path_instruction_type (get_json_object.hpp:36)."""
    SUBSCRIPT = 0
    WILDCARD = 1
    KEY = 2
    INDEX = 3
    NAMED = 4


def _load():
    """The host PDA's library (also ``fjm_eval``, ops/map_utils.py)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from ..utils.nativeload import load_native
        lib = load_native("get_json_object.cpp", "libsparkjson.so",
                          link=["-lpthread"])
        c = ctypes
        lib.gjo_eval.restype = c.c_int
        lib.gjo_eval.argtypes = [
            c.POINTER(c.c_uint8), c.POINTER(c.c_int64), c.POINTER(c.c_uint8),
            c.c_long, c.POINTER(c.c_uint8), c.c_long,
            c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.POINTER(c.c_int64)),
            c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_int64),
        ]
        lib.gjo_free.restype = None
        lib.gjo_free.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


def parse_path(path: str) -> Optional[List[Tuple[PathInstructionType, str, int]]]:
    """Spark JsonPathParser: ``$`` then ``.name`` / ``['name']`` / ``[n]`` /
    ``[*]`` / ``.*`` — returns None for invalid paths (whole result null)."""
    if not path or path[0] != "$":
        return None
    out: List[Tuple[PathInstructionType, str, int]] = []
    i = 1
    T = PathInstructionType
    while i < len(path):
        c = path[i]
        if c == ".":
            i += 1
            j = i
            while j < len(path) and path[j] not in ".[":
                j += 1
            name = path[i:j]
            if not name:
                return None
            if name == "*":
                out.append((T.KEY, "", 0))
                out.append((T.WILDCARD, "", 0))
            else:
                out.append((T.KEY, "", 0))
                out.append((T.NAMED, name, 0))
            i = j
        elif c == "[":
            # quoted names may contain ']' — scan to the closing "']"
            if i + 1 < len(path) and path[i + 1] == "'":
                j = path.find("']", i + 1)
                if j < 0:
                    return None
                j += 1  # position of ']'
            else:
                j = path.find("]", i)
                if j < 0:
                    return None
            inner = path[i + 1:j]
            if inner == "*":
                out.append((T.SUBSCRIPT, "", 0))
                out.append((T.WILDCARD, "", 0))
            elif inner.startswith("'") and inner.endswith("'") and len(inner) >= 2:
                out.append((T.KEY, "", 0))
                out.append((T.NAMED, inner[1:-1], 0))
            else:
                try:
                    idx = int(inner)
                except ValueError:
                    return None
                if idx < 0:
                    return None
                out.append((T.SUBSCRIPT, "", 0))
                out.append((T.INDEX, "", idx))
            i = j + 1
        else:
            return None
    return out


def _encode_ops(ops: Sequence[Tuple[PathInstructionType, str, int]]) -> bytes:
    buf = bytearray()
    for t, name, idx in ops:
        nb = name.encode("utf-8")
        buf += struct.pack("<Bqi", int(t), idx, len(nb))
        buf += nb
    return bytes(buf)


def host_buffers(col: Column):
    """(uint8 characters, int64 offsets, uint8 validity or None) of a
    STRING column on the host, contiguous, for a native call."""
    if col.dtype.id is not dt.TypeId.STRING:
        raise TypeError(f"a JSON op of a {col.dtype.id.value} column")
    data = np.ascontiguousarray(col.data.cpu().numpy(), dtype=np.uint8)
    if data.size == 0:
        data = np.zeros(1, dtype=np.uint8)
    offsets = np.ascontiguousarray(col.host_offsets(), dtype=np.int64)
    valid = None if col.validity is None else np.ascontiguousarray(
        col.validity.cpu().numpy().astype(np.uint8))
    return data, offsets, valid


@func_range()
def get_json_object_with_instructions(
        col: Column,
        ops: Sequence[Tuple[PathInstructionType, str, int]]) -> Column:
    """The host PDA over a parsed instruction stream (the JNI entry)."""
    lib = _load()
    c = ctypes
    n = col.size
    data, offsets, valid = host_buffers(col)
    valid_p = None if valid is None else valid.ctypes.data_as(
        c.POINTER(c.c_uint8))
    opsbuf = np.frombuffer(_encode_ops(ops), dtype=np.uint8) \
        if ops else np.zeros(0, dtype=np.uint8)
    opsbuf = np.ascontiguousarray(opsbuf)

    out_data = c.POINTER(c.c_uint8)()
    out_offs = c.POINTER(c.c_int64)()
    out_valid = c.POINTER(c.c_uint8)()
    out_total = c.c_int64()
    rc = lib.gjo_eval(
        data.ctypes.data_as(c.POINTER(c.c_uint8)),
        offsets.ctypes.data_as(c.POINTER(c.c_int64)),
        valid_p, n,
        opsbuf.ctypes.data_as(c.POINTER(c.c_uint8)), len(opsbuf),
        c.byref(out_data), c.byref(out_offs), c.byref(out_valid),
        c.byref(out_total))
    if rc != 0:
        raise RuntimeError(f"get_json_object native error {rc}")
    try:
        total = out_total.value
        blob = np.ctypeslib.as_array(out_data, shape=(max(total, 1),))[
            :total].copy()
        offs = np.ctypeslib.as_array(out_offs, shape=(n + 1,)).copy()
        vmask = np.ctypeslib.as_array(out_valid, shape=(max(n, 1),))[
            :n].astype(bool).copy()
    finally:
        lib.gjo_free(out_data)
        lib.gjo_free(out_offs)
        lib.gjo_free(out_valid)
    dev = col.device
    return Column(dt.STRING, n, data=torch.from_numpy(blob).to(dev),
                  validity=torch.from_numpy(vmask).to(dev) if n else None,
                  offsets=torch.from_numpy(offs.astype(np.int32)).to(dev))


@func_range()
def get_json_object(col: Column, path: str) -> Column:
    """Spark ``get_json_object(col, path)``; an invalid path gives an
    all-null column. Under ``get_json.tier`` the device tier runs a
    KEY/INDEX path (a wildcard takes the host PDA by the contract)."""
    dev = col.device
    ops = parse_path(path)
    if ops is None:
        n = col.size
        return Column(dt.STRING, n,
                      data=torch.zeros(0, dtype=torch.uint8, device=dev),
                      validity=torch.zeros(n, dtype=torch.bool, device=dev),
                      offsets=torch.zeros(n + 1, dtype=torch.int32,
                                          device=dev))
    if tier_is_device("get_json.tier", dev):
        from .get_json_device import get_json_object_device
        return get_json_object_device(col, ops)
    string_routes.inc("get_json_host_by_config", col.size)
    return get_json_object_with_instructions(col, ops)
