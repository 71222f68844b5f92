"""Worker-side native dispatch cores for the crash-containment sandbox
(the JAX package's faultinj/_sandbox_targets.py).

This module is imported TWO ways:

  * by the port's package (``from ._sandbox_targets import ...``): the
    in-process Parquet tier shares the ctypes signature declarations and
    the output unpacking below, so the sandboxed and in-process paths
    cannot drift apart; and
  * by FILE PATH inside a sandbox worker process (faultinj/sandbox.py
    passes ``file_target(...)`` specs, faultinj/_sandbox_worker.py loads
    this file standalone), which is why there are NO package-relative
    imports here: a worker hosting these targets imports only numpy and
    ctypes, never torch, so it holds no CUDA context and respawning one
    after a crash costs a bare python + numpy start.

Native handles are process-local: a worker cannot reuse the parent's
``pqd_open`` handle, so the parquet target re-opens the file from its
footer bytes and caches the handle per footer digest across calls (one
open per file per worker lifetime). Every target takes the built .so
path from the parent (utils/nativeload.py built it; the worker only
dlopens). The parse_uri target serves ops/parse_uri.py's host tier.
"""

from __future__ import annotations

import ctypes
import hashlib
import time
from typing import Optional, Tuple

import numpy as np

# parquet physical types (subset the unpack path branches on)
PT_BYTE_ARRAY = 6


class LeafC(ctypes.Structure):
    _fields_ = [
        ("path", ctypes.c_char_p),
        ("physical", ctypes.c_int),
        ("type_length", ctypes.c_int),
        ("converted", ctypes.c_int),
        ("scale", ctypes.c_int),
        ("precision", ctypes.c_int),
        ("max_def", ctypes.c_int),
        ("max_rep", ctypes.c_int),
        ("rep_def", ctypes.c_int),
        ("path_json", ctypes.c_char_p),
    ]


class OutC(ctypes.Structure):
    _fields_ = [
        ("values", ctypes.POINTER(ctypes.c_uint8)),
        ("values_bytes", ctypes.c_longlong),
        ("offsets", ctypes.POINTER(ctypes.c_int32)),
        ("validity", ctypes.POINTER(ctypes.c_uint8)),
        ("rows", ctypes.c_longlong),
        ("null_count", ctypes.c_longlong),
        ("list_offsets", ctypes.POINTER(ctypes.c_int32)),
        ("list_validity", ctypes.POINTER(ctypes.c_uint8)),
        ("list_rows", ctypes.c_longlong),
        ("list_null_count", ctypes.c_longlong),
        ("defs", ctypes.POINTER(ctypes.c_int32)),
        ("reps", ctypes.POINTER(ctypes.c_int32)),
        ("n_levels", ctypes.c_longlong),
    ]


def declare_pqd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the libsparkpqd signatures shared by the in-process reader
    and the sandbox worker (pqd_extract_pages is declared by the reader
    alone — the device-decode tier is never sandboxed)."""
    c = ctypes
    lib.pqd_open.restype = c.c_void_p
    lib.pqd_open.argtypes = [c.POINTER(c.c_uint8), c.c_longlong,
                             c.POINTER(c.c_char_p)]
    lib.pqd_num_row_groups.restype = c.c_int
    lib.pqd_num_row_groups.argtypes = [c.c_void_p]
    lib.pqd_rg_num_rows.restype = c.c_longlong
    lib.pqd_rg_num_rows.argtypes = [c.c_void_p, c.c_int]
    lib.pqd_num_leaves.restype = c.c_int
    lib.pqd_num_leaves.argtypes = [c.c_void_p]
    lib.pqd_set_verify_crc.restype = None
    lib.pqd_set_verify_crc.argtypes = [c.c_void_p, c.c_int]
    lib.pqd_leaf_info.restype = c.c_int
    lib.pqd_leaf_info.argtypes = [c.c_void_p, c.c_int, c.POINTER(LeafC)]
    lib.pqd_chunk_range.restype = c.c_int
    lib.pqd_chunk_range.argtypes = [
        c.c_void_p, c.c_int, c.c_int, c.POINTER(c.c_longlong),
        c.POINTER(c.c_longlong), c.POINTER(c.c_longlong),
        c.POINTER(c.c_int)]
    lib.pqd_decode_chunk.restype = c.c_int
    lib.pqd_decode_chunk.argtypes = [
        c.c_void_p, c.c_int, c.c_int, c.POINTER(c.c_uint8), c.c_longlong,
        c.POINTER(OutC), c.POINTER(c.c_char_p)]
    lib.pqd_decode_chunk2.restype = c.c_int
    lib.pqd_decode_chunk2.argtypes = [
        c.c_void_p, c.c_int, c.c_int, c.POINTER(c.c_uint8), c.c_longlong,
        c.c_int, c.POINTER(OutC), c.POINTER(c.c_char_p)]
    lib.pqd_free_out.restype = None
    lib.pqd_free_out.argtypes = [c.POINTER(OutC)]
    lib.pqd_free.restype = None
    lib.pqd_free.argtypes = [c.c_void_p]
    lib.pqd_close.restype = None
    lib.pqd_close.argtypes = [c.c_void_p]
    return lib


def unpack_out(lib: ctypes.CDLL, out: OutC, physical: int, max_rep: int,
               want_levels: bool) -> Tuple:
    """OutC → owned numpy buffers (rows, values, offsets, validity, lists);
    frees the native output either way. The tuple is plain numpy + ints, so
    it pickles across the sandbox pipe unchanged."""
    try:
        rows = out.rows
        values = np.ctypeslib.as_array(out.values,
                                       shape=(out.values_bytes,)).copy()
        offsets = None
        if physical == PT_BYTE_ARRAY:
            offsets = np.ctypeslib.as_array(out.offsets,
                                            shape=(rows + 1,)).copy()
        validity = None
        if out.null_count > 0:
            validity = np.ctypeslib.as_array(out.validity,
                                             shape=(rows,)).copy()
        lists = None
        if want_levels:
            nl = out.n_levels
            lists = (np.ctypeslib.as_array(out.defs, shape=(nl,)).copy()
                     if nl else np.zeros(0, np.int32),
                     np.ctypeslib.as_array(out.reps, shape=(nl,)).copy()
                     if nl else np.zeros(0, np.int32))
        elif max_rep == 1:
            lrows = out.list_rows
            loffs = np.ctypeslib.as_array(
                out.list_offsets, shape=(lrows + 1,)).copy()
            lvalid = None
            if out.list_null_count > 0:
                lvalid = np.ctypeslib.as_array(
                    out.list_validity, shape=(lrows,)).copy()
            lists = (lrows, loffs, lvalid)
        return rows, values, offsets, validity, lists
    finally:
        lib.pqd_free_out(ctypes.byref(out))


# worker-local caches: one dlopen per .so, one pqd_open per footer digest
_libs = {}
_pqd_handles = {}


def _lib_for(so_path: str, declare) -> ctypes.CDLL:
    lib = _libs.get(so_path)
    if lib is None:
        lib = declare(ctypes.CDLL(so_path))
        _libs[so_path] = lib
    return lib


def parquet_decode_chunk(so_path: str, footer: bytes, rg: int,
                         leaf_index: int, raw: bytes, physical: int,
                         max_rep: int, want_levels: bool,
                         verify_crc: bool) -> Tuple:
    """Sandbox target for one (row group, leaf) page-stream decode.

    Raises plain RuntimeError (with the decoder's ``(corruption)`` marker
    preserved) — the parent-side reader re-raises CorruptionError, keeping
    the integrity taxonomy out of this standalone module."""
    lib = _lib_for(so_path, declare_pqd)
    digest = hashlib.sha1(footer).hexdigest()
    h = _pqd_handles.get(digest)
    if h is None:
        buf = np.frombuffer(footer, dtype=np.uint8)
        err = ctypes.c_char_p()
        h = lib.pqd_open(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            ctypes.byref(err))
        if not h:
            msg = err.value.decode() if err.value else "unknown error"
            lib.pqd_free(err)
            raise RuntimeError(f"sandbox parquet open failed: {msg}")
        _pqd_handles[digest] = h
    lib.pqd_set_verify_crc(h, 1 if verify_crc else 0)
    chunk = np.frombuffer(raw, dtype=np.uint8)
    out = OutC()
    err = ctypes.c_char_p()
    rc = lib.pqd_decode_chunk2(
        h, rg, leaf_index,
        chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(chunk),
        1 if want_levels else 0, ctypes.byref(out), ctypes.byref(err))
    if rc != 0:
        msg = err.value.decode() if err.value else "unknown error"
        lib.pqd_free(err)
        raise RuntimeError(f"decode leaf {leaf_index} rg={rg} failed: {msg}")
    return unpack_out(lib, out, physical, max_rep, want_levels)


# ---------------------------------------------------------------------------
# parse_uri
# ---------------------------------------------------------------------------

def declare_puri(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    u8p, i64p = c.POINTER(c.c_uint8), c.POINTER(c.c_int64)
    lib.puri_parse.restype = c.c_int
    lib.puri_parse.argtypes = [
        u8p, i64p, u8p, c.c_long, c.c_int,
        u8p, i64p, u8p, c.c_int,
        c.POINTER(u8p), c.POINTER(i64p), c.POINTER(u8p),
        c.POINTER(c.c_int64),
    ]
    lib.puri_free.restype = None
    lib.puri_free.argtypes = [c.c_void_p]
    return lib


def parse_uri_buffers(lib: ctypes.CDLL, data: np.ndarray, offs: np.ndarray,
                      valid: Optional[np.ndarray], n: int, part: int,
                      key_data: Optional[np.ndarray],
                      key_offs: Optional[np.ndarray],
                      key_valid: Optional[np.ndarray],
                      key_broadcast: int) -> Tuple:
    """The ctypes core of the native parse_uri tier, numpy in → numpy out
    ((blob, offsets, validity bool)); shared verbatim by the in-process
    path and ``parse_uri_target`` below."""
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    i64p = c.POINTER(c.c_int64)
    out_data = u8p()
    out_offs = i64p()
    out_valid = u8p()
    total = c.c_int64()
    if data.size == 0:
        data = np.zeros(1, dtype=np.uint8)
    rc = lib.puri_parse(
        data.ctypes.data_as(u8p), offs.ctypes.data_as(i64p),
        valid.ctypes.data_as(u8p) if valid is not None else None,
        n, part,
        key_data.ctypes.data_as(u8p) if key_data is not None else None,
        key_offs.ctypes.data_as(i64p) if key_offs is not None else None,
        key_valid.ctypes.data_as(u8p) if key_valid is not None else None,
        key_broadcast,
        c.byref(out_data), c.byref(out_offs), c.byref(out_valid),
        c.byref(total))
    if rc != 0:
        raise RuntimeError(f"parse_uri native tier failed ({rc})")
    try:
        offsets = np.ctypeslib.as_array(out_offs, shape=(n + 1,)).copy()
        validity = np.ctypeslib.as_array(out_valid, shape=(n,)).copy() \
            .astype(bool) if n else np.zeros(0, dtype=bool)
        blob = (np.ctypeslib.as_array(out_data, shape=(total.value,)).copy()
                if total.value else np.zeros(0, dtype=np.uint8))
    finally:
        lib.puri_free(out_data)
        lib.puri_free(out_offs)
        lib.puri_free(out_valid)
    return blob, offsets, validity


def parse_uri_target(so_path: str, data, offs, valid, n, part, key_data,
                     key_offs, key_valid, key_broadcast) -> Tuple:
    """Sandbox target: dlopen-by-path wrapper around parse_uri_buffers."""
    lib = _lib_for(so_path, declare_puri)
    return parse_uri_buffers(lib, data, offs, valid, n, part, key_data,
                             key_offs, key_valid, key_broadcast)


# ---------------------------------------------------------------------------
# self-test targets
# ---------------------------------------------------------------------------

def probe_target(x):
    """Round-trip probe: the worker is alive and unpickling works."""
    return x


def sleep_target(seconds: float):
    """A wedged native call: the parent's deadline must escalate
    stall → kill → CRASH (the worker never answers)."""
    time.sleep(seconds)
    return "woke"
