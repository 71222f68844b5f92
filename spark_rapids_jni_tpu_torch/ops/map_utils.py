"""Spark ``from_json`` raw-map extraction: JSON object rows ->
LIST<STRUCT<key STRING, value STRING>> (the JAX package's
ops/map_utils.py).

Reference surface: MapUtils.extractRawMapFromJsonString backed by
map_utils.cu's ``from_json``. Keys and string values are unescaped;
nested object/array values keep their raw source span; other scalars keep
their literal text. A null, non-object or invalid row is a null row (the
reference's tokenizer fails the whole batch on invalid JSON; a null row
is the JAX package's contract, Spark's permissive mode).

``from_json.tier`` picks the tier (utils/backend.py): under ``auto`` a
CUDA column takes the device tier (ops/from_json_device.py), a CPU column
the host tier, native get_json_object.cpp's ``fjm_eval`` (the library
ops/get_json_object.py builds). Rows are counted in
``backend.string_routes``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar.column import Column
from ..utils.backend import string_routes, tier_is_device
from ..utils.tracing import func_range
from .get_json_object import _load, host_buffers


def _declare(lib):
    if getattr(lib, "_fjm_declared", False):
        return lib
    c = ctypes
    lib.fjm_eval.restype = c.c_int
    P8, P64 = c.POINTER(c.c_uint8), c.POINTER(c.c_int64)
    lib.fjm_eval.argtypes = [
        P8, P64, P8, c.c_long,
        c.POINTER(P64), c.POINTER(P8),
        c.POINTER(P8), c.POINTER(P64),
        c.POINTER(P8), c.POINTER(P64),
        P64, P64, P64,
    ]
    lib._fjm_declared = True
    return lib


@func_range()
def extract_raw_map_from_json_string(col: Column) -> Column:
    """LIST<STRUCT<key STRING, value STRING>> of each row's top-level
    pairs, on the tier ``from_json.tier`` picks for the column's
    device."""
    if tier_is_device("from_json.tier", col.device):
        from .from_json_device import extract_raw_map_device
        return extract_raw_map_device(col)
    string_routes.inc("from_json_host_by_config", col.size)
    return extract_raw_map_host(col)


# rows of one native call: the PDA keeps every pair of its rows as a string
# until it packs them, so a call over millions of rows holds them all
HOST_CHUNK_ROWS = 1 << 16


def extract_raw_map_host(col: Column) -> Column:
    """The host tier (the native PDA); also the device tier's route for
    rows it does not take. The characters cross to the host once; rows go
    to ``fjm_eval`` ``HOST_CHUNK_ROWS`` at a time (each row's pairs depend
    on its own bytes) and the chunks' buffers join in numpy."""
    lib = _declare(_load())
    n = col.size
    data, offsets, valid = host_buffers(col)
    parts = []
    for r0 in range(0, n, HOST_CHUNK_ROWS):
        r1 = min(n, r0 + HOST_CHUNK_ROWS)
        o = offsets[r0:r1 + 1]
        chunk = data[o[0]:o[-1]] if o[-1] > o[0] else data[:1]
        parts.append(_fjm(lib, np.ascontiguousarray(chunk), o - o[0],
                          None if valid is None else valid[r0:r1], r1 - r0))
    if not parts:
        parts.append(_fjm(lib, data, offsets, valid, 0))

    def joined(i, j):  # offsets i of every part, rebased, and blobs j
        out, base = [np.zeros(1, np.int64)], 0
        for p in parts:
            out.append(p[i][1:] + base)
            base += int(p[i][-1])
        return np.concatenate(out), (None if j is None else np.concatenate(
            [p[j] for p in parts]))

    list_offs, row_valid = joined(0, 1)
    key_offs, key_blob = joined(2, 3)
    val_offs, val_blob = joined(4, 5)
    dev = col.device

    def put(a, dtype=None):
        return torch.from_numpy(a if dtype is None else a.astype(dtype)) \
            .to(dev)

    m = int(key_offs.shape[0]) - 1
    keys = Column(dt.STRING, m, data=put(key_blob),
                  offsets=put(key_offs, np.int32))
    vals = Column(dt.STRING, m, data=put(val_blob),
                  offsets=put(val_offs, np.int32))
    return Column.list_of(Column.struct_of([keys, vals]),
                          put(list_offs, np.int32), validity=put(row_valid))


def _fjm(lib, data, offsets, valid, n):
    """One ``fjm_eval`` call: (list offsets, row validity, key offsets,
    key bytes, value offsets, value bytes) as numpy arrays."""
    c = ctypes
    P8, P64 = c.POINTER(c.c_uint8), c.POINTER(c.c_int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    valid_p = None if valid is None else valid.ctypes.data_as(P8)
    lo, rv = P64(), P8()
    kd, ko, vd, vo = P8(), P64(), P8(), P64()
    npairs, ktot, vtot = c.c_int64(), c.c_int64(), c.c_int64()
    rc = lib.fjm_eval(
        data.ctypes.data_as(P8), offsets.ctypes.data_as(P64), valid_p, n,
        c.byref(lo), c.byref(rv), c.byref(kd), c.byref(ko), c.byref(vd),
        c.byref(vo), c.byref(npairs), c.byref(ktot), c.byref(vtot))
    if rc != 0:
        raise RuntimeError(f"from_json native error {rc}")
    try:
        m = npairs.value
        return (np.ctypeslib.as_array(lo, shape=(n + 1,)).copy(),
                np.ctypeslib.as_array(rv, shape=(max(n, 1),))[:n]
                .astype(bool),
                np.ctypeslib.as_array(ko, shape=(m + 1,)).copy(),
                np.ctypeslib.as_array(kd, shape=(max(ktot.value, 1),))[
                    :ktot.value].copy(),
                np.ctypeslib.as_array(vo, shape=(m + 1,)).copy(),
                np.ctypeslib.as_array(vd, shape=(max(vtot.value, 1),))[
                    :vtot.value].copy())
    finally:
        for p in (lo, rv, kd, ko, vd, vo):
            lib.gjo_free(p)
