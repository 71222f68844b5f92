"""Parquet footer parse/prune: a ctypes facade over
native/parquet_footer.cpp (the JAX package's parquet/footer.py).

Reference surface: ParquetFooter.java — schema DSL builders (:35-93),
depth-first flatten for the native call (:140-189), readAndFilter (:204-221),
getNumRows/getNumColumns, serializeThriftFile (:106-112). The native side
carries the thrift-compact DOM, column pruner, and split-midpoint row-group
filter (see native/parquet_footer.cpp). Host-only: the plugin prunes
footers with it before any page is read. The library is built at first
use into ``build/torch_native/libsparkpq.so`` (utils/nativeload.py).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

_lock = threading.Lock()
_lib = None

# Tag values shared with the native side (reference Tag enum :102)
_TAG_VALUE, _TAG_STRUCT, _TAG_LIST, _TAG_MAP = 0, 1, 2, 3


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from ..utils.nativeload import load_native
        lib = load_native("parquet_footer.cpp", "libsparkpq.so",
                          extra_deps=["thrift_compact.hpp"])
        c = ctypes
        lib.pqf_read_and_filter.restype = c.c_void_p
        lib.pqf_read_and_filter.argtypes = [
            c.POINTER(c.c_uint8), c.c_long, c.c_longlong, c.c_longlong,
            c.POINTER(c.c_char_p), c.POINTER(c.c_int), c.POINTER(c.c_int),
            c.c_int, c.c_int, c.c_int, c.POINTER(c.c_char_p),
        ]
        lib.pqf_num_rows.restype = c.c_longlong
        lib.pqf_num_rows.argtypes = [c.c_void_p]
        lib.pqf_num_columns.restype = c.c_int
        lib.pqf_num_columns.argtypes = [c.c_void_p]
        lib.pqf_serialize.restype = c.c_int
        lib.pqf_serialize.argtypes = [
            c.c_void_p, c.POINTER(c.POINTER(c.c_uint8)),
            c.POINTER(c.c_longlong)]
        lib.pqf_close.restype = None
        lib.pqf_close.argtypes = [c.c_void_p]
        lib.pqf_free.restype = None
        lib.pqf_free.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


class FooterSchema:
    """Flattened depth-first schema (names, num_children, tags)."""

    def __init__(self, names: List[str], num_children: List[int],
                 tags: List[int], root_children: int):
        self.names = names
        self.num_children = num_children
        self.tags = tags
        self.root_children = root_children


class SchemaBuilder:
    """Schema description DSL (reference StructBuilder/ValueBuilder etc.,
    ParquetFooter.java:35-93). Build the Spark read schema, then flatten."""

    def __init__(self):
        self._entries: List[Tuple[str, int, int]] = []  # name, nchildren, tag
        self._stack: List[int] = []
        self._root_children = 0

    def _bump_parent(self):
        if self._stack:
            name, nc, tag = self._entries[self._stack[-1]]
            self._entries[self._stack[-1]] = (name, nc + 1, tag)
        else:
            self._root_children += 1

    def add_value(self, name: str) -> "SchemaBuilder":
        self._bump_parent()
        self._entries.append((name, 0, _TAG_VALUE))
        return self

    def start_struct(self, name: str) -> "SchemaBuilder":
        self._bump_parent()
        self._stack.append(len(self._entries))
        self._entries.append((name, 0, _TAG_STRUCT))
        return self

    def end_struct(self) -> "SchemaBuilder":
        self._stack.pop()
        return self

    def start_list(self, name: str) -> "SchemaBuilder":
        """A list's single child must be named 'element' (java convention)."""
        self._bump_parent()
        self._stack.append(len(self._entries))
        self._entries.append((name, 0, _TAG_LIST))
        return self

    def end_list(self) -> "SchemaBuilder":
        return self.end_struct()

    def start_map(self, name: str) -> "SchemaBuilder":
        """A map's children must be named 'key' and 'value'."""
        self._bump_parent()
        self._stack.append(len(self._entries))
        self._entries.append((name, 0, _TAG_MAP))
        return self

    def end_map(self) -> "SchemaBuilder":
        return self.end_struct()

    def build(self) -> FooterSchema:
        assert not self._stack, "unbalanced start/end"
        return FooterSchema(
            [e[0] for e in self._entries],
            [e[1] for e in self._entries],
            [e[2] for e in self._entries],
            self._root_children)


class ParquetFooter:
    """Owns a native pruned-footer handle."""

    def __init__(self, handle):
        self._h = handle
        self._lib = _load()

    def num_rows(self) -> int:
        return int(self._lib.pqf_num_rows(self._h))

    def num_columns(self) -> int:
        return int(self._lib.pqf_num_columns(self._h))

    def serialize_thrift_file(self) -> bytes:
        c = ctypes
        out = c.POINTER(c.c_uint8)()
        out_len = c.c_longlong()
        rc = self._lib.pqf_serialize(self._h, c.byref(out), c.byref(out_len))
        if rc != 0:
            raise RuntimeError(f"footer serialize failed ({rc})")
        try:
            return bytes(np.ctypeslib.as_array(out, shape=(out_len.value,)))
        finally:
            self._lib.pqf_free(out)

    def close(self):
        if self._h:
            self._lib.pqf_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_and_filter(footer_bytes: bytes, part_offset: int, part_length: int,
                    schema: FooterSchema,
                    ignore_case: bool = False) -> ParquetFooter:
    """Parse a raw thrift footer, prune to ``schema``, keep row groups whose
    midpoint lies in [part_offset, part_offset+part_length)."""
    lib = _load()
    c = ctypes
    buf = np.frombuffer(footer_bytes, dtype=np.uint8)
    n = len(schema.names)
    names_arr = (c.c_char_p * n)(*[s.encode() for s in schema.names])
    nc_arr = (c.c_int * n)(*schema.num_children)
    tag_arr = (c.c_int * n)(*schema.tags)
    err = c.c_char_p()
    h = lib.pqf_read_and_filter(
        buf.ctypes.data_as(c.POINTER(c.c_uint8)), len(buf),
        part_offset, part_length, names_arr, nc_arr, tag_arr, n,
        schema.root_children, int(ignore_case), c.byref(err))
    if not h:
        msg = err.value.decode() if err.value else "unknown error"
        lib.pqf_free(err)
        raise RuntimeError(f"parquet footer parse/filter failed: {msg}")
    return ParquetFooter(h)
