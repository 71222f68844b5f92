"""Chunked Parquet reader: page decode into Column batches on a device (the
JAX package's parquet/reader.py).

Reference capability: the pruned footer (ParquetFooter.java:204-221,
NativeParquetJni.cpp:689) feeds cudf's chunked Parquet reader, which
decodes page data into GPU columns. Here each column chunk takes one of
two tiers:

  * the device tier (parquet/device_decode.py, the default for a CUDA
    reader): the host parses page headers and decompresses, the encoded
    page bytes cross to the card once, and the decode runs there as torch
    ops;
  * the host tier: native/parquet_decode.cpp decodes pages on the host
    into dense buffers, which cross to the device.

A CUDA reader takes the host tier only by the reference's own routes,
each counted in ``route_metrics``: a page inventory the device tier does
not cover (``pages_supported``: dictionary-fallback chunks, PLAIN
BYTE_ARRAY, INT96, FIXED_LEN_BYTE_ARRAY), the re-read of a chunk whose
page checksum failed, and ``parquet.device_decode=native``. Any other
error of the device tier raises.

The reader streams one chunk of row groups at a time under a byte budget
(bounded host memory), prunes row groups a predicate cannot match
(dictionary membership, footer min/max statistics), and decodes columns
on a thread pool (the native calls release the GIL).

A FIXED_LEN_BYTE_ARRAY DECIMAL column is read as DECIMAL128 on the host
tier on every reader, as in the JAX package (the device tier declines
FLBA, ``device_decode.pages_supported``): the native decode turns its
big-endian bytes into 16-byte little-endian limbs, and the route is
counted as ``host_columns_unsupported``.

Nested columns split as in the JAX package. A flat primitive and a
one-level LIST of a primitive (annotated 3-level, legacy 2-level or a bare
repeated primitive) are "simple" plans: one leaf, either tier (the device
tier assembles the LIST from its levels, ``device_decode._finish_list``;
the host tier's native decode folds them). A STRUCT, a MAP and any deeper
tree are "nested" plans: each leaf is decoded on the host with its raw
definition and repetition levels (``want_levels``), and
parquet/nested.py rebuilds the column tree from them, in numpy, before
it crosses to the device (counted as ``host_columns_unsupported``).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table, _host_to_tensor, resolve_device
from ..columnar.dtype import DType, TypeId
from ..faultinj import watchdog
from ..faultinj._sandbox_targets import (
    LeafC as _LeafC,
    OutC as _OutC,
    declare_pqd,
    unpack_out,
)
from ..memory.reservation import device_reservation, release_barrier
from ..memory.transport import to_device
from ..utils import config
from .device_decode import _sync

_lock = threading.Lock()
_lib = None


class ReaderMetrics:
    """Process-wide counters of the reader (thread-safe). ``inc`` (not
    ``bump``), as the JAX package names it."""

    def __init__(self, counters: Sequence[str]):
        self._counters = tuple(counters)
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._c = {k: 0 for k in self._counters}

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._c[name] += by

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)


# predicate pushdown, the JAX package's counters
reader_metrics = ReaderMetrics((
    "pages_skipped", "bytes_skipped", "row_groups_skipped",
    "pushdown_probes", "membership_skips", "stat_skips"))

# which tier decoded each selected column of each read, and why a column
# took the host tier
route_metrics = ReaderMetrics((
    "device_columns", "host_columns_by_config",
    "host_columns_unsupported", "host_columns_corruption"))

# parquet physical types
_PT_BOOLEAN, _PT_INT32, _PT_INT64, _PT_INT96 = 0, 1, 2, 3
_PT_FLOAT, _PT_DOUBLE, _PT_BYTE_ARRAY, _PT_FLBA = 4, 5, 6, 7
# parquet converted types (subset used for mapping)
_CT_UTF8, _CT_DECIMAL, _CT_DATE = 0, 5, 6
_CT_TIMESTAMP_MILLIS, _CT_TIMESTAMP_MICROS = 9, 10
_CT_UINT_8, _CT_UINT_16, _CT_UINT_32, _CT_UINT_64 = 11, 12, 13, 14
_CT_INT_8, _CT_INT_16, _CT_INT_32, _CT_INT_64 = 15, 16, 17, 18
# converted types of a group that make it a LIST (MAP, LIST)
_CT_GROUP_LIST = (1, 3)
_REP_REPEATED = 2


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from ..utils.nativeload import load_native
        lib = load_native("parquet_decode.cpp", "libsparkpqd.so",
                          extra_deps=["thrift_compact.hpp"],
                          link=["-lz", "-ldl"])
        # the signatures the sandbox worker declares against its own
        # dlopen of this .so (faultinj/_sandbox_targets.py)
        declare_pqd(lib)
        c = ctypes
        from .device_decode import _PageMeta
        lib.pqd_extract_pages.restype = c.c_int
        lib.pqd_extract_pages.argtypes = [
            c.c_void_p, c.c_int, c.c_int, c.POINTER(c.c_uint8),
            c.c_longlong, c.POINTER(c.POINTER(c.c_uint8)),
            c.POINTER(c.c_longlong), c.POINTER(c.POINTER(_PageMeta)),
            c.POINTER(c.c_longlong), c.POINTER(c.c_char_p)]
        _lib = lib
        return _lib


@dataclass
class LeafSchema:
    """One leaf column of the file schema (a one-level LIST leaf carries
    its element type in ``elem_dtype``; ``dtype`` is then LIST)."""

    index: int
    name: str          # dotted path; a LIST leaf the outer field's name
    dtype: DType
    physical: int
    type_length: int
    max_def: int
    max_rep: int
    elem_dtype: Optional[DType] = None
    nodes: list = None   # root -> leaf PathNodes (parquet/nested.py)
    rep_def: int = 0     # def level at the repeated ancestor (lists)

    def element(self) -> "LeafSchema":
        """The leaf as a flat column of its element type (itself when it
        is no LIST)."""
        if self.max_rep != 1:
            return self
        return LeafSchema(self.index, self.name, self.elem_dtype,
                          self.physical, self.type_length, self.max_def, 0)


@dataclass
class ColumnPlan:
    """One top-level output column: one leaf, flat or a one-level LIST
    ("simple"), or a STRUCT / deeper tree rebuilt from its leaves' levels
    ("nested", ``tree`` its parquet/nested.py TreeNode)."""

    name: str
    kind: str                    # "simple" | "nested"
    leaves: List[LeafSchema]
    dtype: DType = None          # top-level dtype
    tree: object = None


def _map_dtype(physical: int, converted: int, scale: int,
               precision: int) -> DType:
    """Parquet (physical, converted) -> engine DType (Spark read
    semantics)."""
    if physical == _PT_BOOLEAN:
        return dt.BOOL8
    if physical == _PT_INT32:
        if converted == _CT_DECIMAL:
            return DType(TypeId.DECIMAL32, scale)
        if converted == _CT_DATE:
            return DType(TypeId.TIMESTAMP_DAYS)
        if converted == _CT_INT_8:
            return dt.INT8
        if converted == _CT_INT_16:
            return dt.INT16
        if converted == _CT_UINT_8:
            return dt.UINT8
        if converted == _CT_UINT_16:
            return dt.UINT16
        if converted == _CT_UINT_32:
            return dt.UINT32
        return dt.INT32
    if physical == _PT_INT64:
        if converted == _CT_DECIMAL:
            return DType(TypeId.DECIMAL64, scale)
        if converted == _CT_TIMESTAMP_MICROS:
            return DType(TypeId.TIMESTAMP_MICROSECONDS)
        if converted == _CT_TIMESTAMP_MILLIS:
            return DType(TypeId.TIMESTAMP_MILLISECONDS)
        if converted == _CT_UINT_64:
            return dt.UINT64
        return dt.INT64
    if physical == _PT_FLOAT:
        return dt.FLOAT32
    if physical == _PT_DOUBLE:
        return dt.FLOAT64
    if physical == _PT_BYTE_ARRAY:
        return dt.STRING
    if physical == _PT_FLBA:
        if converted == _CT_DECIMAL:
            return DType(TypeId.DECIMAL128, scale)
        raise ValueError("FIXED_LEN_BYTE_ARRAY without DECIMAL is unsupported")
    if physical == _PT_INT96:
        # legacy Impala timestamps; decoded natively to epoch microseconds
        return DType(TypeId.TIMESTAMP_MICROSECONDS)
    raise ValueError(f"unsupported parquet physical type {physical}")


def _read_footer_bytes(f) -> bytes:
    """Strip PAR1 framing: [data]["PAR1"... footer u32len "PAR1"]."""
    f.seek(0, os.SEEK_END)
    size = f.tell()
    if size < 12:
        raise ValueError("not a parquet file (too small)")
    f.seek(size - 8)
    tail = f.read(8)
    if tail[4:] != b"PAR1":
        raise ValueError("not a parquet file (bad magic)")
    flen = int.from_bytes(tail[:4], "little")
    if flen > size - 12:
        raise ValueError("corrupt parquet footer length")
    f.seek(size - 8 - flen)
    return f.read(flen)


class ParquetReader:
    """Chunked reader over one parquet file, building columns on
    ``device`` (a card unless the caller asks for the CPU).

    Streams row-group batches under a byte budget: per chunk it decodes
    each selected column's chunk (device tier or host tier, see the module
    docstring) and returns a `Table`. Host memory stays bounded by the
    largest chunk. With a ``timings`` dict the reader adds each step's
    milliseconds there (host extract or host decode, run walk, copy,
    device decode, reservation) and each column's tier to ``routes``,
    synchronizing the device between steps so the split is real: a
    measurement mode, off by default."""

    def __init__(self, path: str, columns: Optional[Sequence[str]] = None,
                 predicate=None, device="cuda",
                 timings: Optional[dict] = None):
        self._path = path
        self._device = resolve_device(device)
        # plan expression over the SELECTED columns (plan/expr.py), used
        # only to prune row groups that provably hold no qualifying row:
        # the caller still applies the predicate, so results are
        # bit-identical with pushdown on or off
        self._predicate = predicate
        self._probe_cache = {}
        self._timings = timings
        self._tlock = threading.Lock()
        self.routes = {}
        self._lib = _load()
        with open(path, "rb") as f:
            footer = _read_footer_bytes(f)
        # kept for the crash-containment sandbox: native handles are
        # process-local, so a sandbox worker re-opens from these bytes
        self._footer = footer
        buf = np.frombuffer(footer, dtype=np.uint8)
        err = ctypes.c_char_p()
        h = self._lib.pqd_open(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            ctypes.byref(err))
        if not h:
            msg = err.value.decode() if err.value else "unknown error"
            self._lib.pqd_free(err)
            raise RuntimeError(f"parquet open failed: {msg}")
        self._h = h
        self._lib.pqd_set_verify_crc(
            self._h, 1 if config.get("parquet.verify_crc") else 0)
        self._plans = self._build_plans()
        if columns is not None:
            by_name = {p.name: p for p in self._plans}
            missing = [c for c in columns if c not in by_name]
            if missing:
                self.close()
                raise KeyError(f"columns not in file: {missing}")
            self._selected_plans = [by_name[c] for c in columns]
        else:
            self._selected_plans = list(self._plans)
        self._selected = [l for p in self._selected_plans for l in p.leaves]

    def _read_schema(self) -> List[LeafSchema]:
        from .nested import parse_path
        out = []
        for i in range(self._lib.pqd_num_leaves(self._h)):
            info = _LeafC()
            if self._lib.pqd_leaf_info(self._h, i, ctypes.byref(info)) != 0:
                raise RuntimeError(f"leaf_info({i}) failed")
            name = info.path.decode()
            dtype = _map_dtype(info.physical, info.converted, info.scale,
                               info.precision)
            elem_dtype = None
            if info.max_rep == 1:
                # one-level LIST: strip parquet's wrapper tail (3-level
                # '.list.element', legacy 2-level '.array' / '.item'),
                # keeping any enclosing struct path
                elem_dtype, dtype = dtype, dt.LIST
                parts = name.split(".")
                name = ".".join(parts[:-2] if len(parts) >= 3
                                else parts[:-1] if len(parts) == 2
                                else parts)
            out.append(LeafSchema(i, name, dtype, info.physical,
                                  info.type_length, info.max_def,
                                  info.max_rep, elem_dtype,
                                  parse_path(info.path_json.decode()),
                                  info.rep_def))
        return out

    def _build_plans(self) -> List[ColumnPlan]:
        """Leaves grouped into top-level column plans by their root ->
        leaf paths: "simple" (``_is_simple``) or "nested"."""
        from .nested import REP_REPEATED, build_tree
        leaves = self._read_schema()
        by_id = {l.index: l for l in leaves}
        plans = []
        for tree in build_tree({l.index: l.nodes for l in leaves}):
            mine = [by_id[i] for i in tree.leaf_ids]
            if len(mine) == 1 and self._is_simple(mine[0]):
                plans.append(ColumnPlan(tree.node.name, "simple", mine,
                                        mine[0].dtype))
            else:
                top = (dt.LIST if tree.node.repetition == REP_REPEATED
                       or tree.node.converted in _CT_GROUP_LIST
                       else dt.STRUCT)
                plans.append(ColumnPlan(tree.node.name, "nested", mine, top,
                                        tree))
        return plans

    @staticmethod
    def _is_simple(leaf: LeafSchema) -> bool:
        """The shapes one leaf assembles itself: a flat primitive, and a
        one-level LIST of a primitive (annotated 3-level, legacy 2-level,
        bare repeated primitive)."""
        nodes = leaf.nodes
        if leaf.max_rep == 0:
            return len(nodes) == 1
        if leaf.max_rep != 1:
            return False
        if len(nodes) == 1:  # bare repeated primitive
            return nodes[0].repetition == _REP_REPEATED
        if len(nodes) == 2:  # legacy 2-level: repeated group + leaf
            return nodes[0].repetition == _REP_REPEATED
        if len(nodes) == 3:  # annotated: wrapper group + repeated + leaf
            return (nodes[1].repetition == _REP_REPEATED
                    and (nodes[0].converted in _CT_GROUP_LIST
                         or nodes[1].name in ("list", "array", "bag")))
        return False

    # ---- info -------------------------------------------------------------
    @property
    def schema(self) -> List[Tuple[str, DType]]:
        return [(p.name, p.dtype) for p in self._selected_plans]

    @property
    def num_row_groups(self) -> int:
        return self._lib.pqd_num_row_groups(self._h)

    def num_rows(self) -> int:
        return sum(self._lib.pqd_rg_num_rows(self._h, g)
                   for g in range(self.num_row_groups))

    def _chunk_range(self, rg: int, leaf: int):
        c = ctypes
        off = c.c_longlong()
        ln = c.c_longlong()
        nv = c.c_longlong()
        codec = c.c_int()
        rc = self._lib.pqd_chunk_range(self._h, rg, leaf, c.byref(off),
                                       c.byref(ln), c.byref(nv),
                                       c.byref(codec))
        if rc != 0:
            raise RuntimeError(f"chunk_range({rg},{leaf}) failed ({rc})")
        return off.value, ln.value, nv.value, codec.value

    def _rg_bytes(self, rg: int) -> int:
        return sum(self._chunk_range(rg, l.index)[1] for l in self._selected)

    def _time(self, key: str, ms: float) -> None:
        if self._timings is not None:
            with self._tlock:
                self._timings[key] = self._timings.get(key, 0) + ms

    def _read_chunk(self, f, rg: int, leaf: LeafSchema) -> np.ndarray:
        """One column chunk's bytes from the file, through the
        ``parquet_page`` chaos surface: an ``injectionType 3`` rule flips
        one bit of the bytes in transit, which the page checksums must
        turn into a CorruptionError."""
        from ..faultinj.injector import get_injector
        from ..memory.integrity import maybe_flip_arrays
        off, length, _, _ = self._chunk_range(rg, leaf.index)
        f.seek(off)
        raw = f.read(length)
        if get_injector() is not None:
            wbuf = np.frombuffer(bytearray(raw), dtype=np.uint8)
            if maybe_flip_arrays("parquet_page", [wbuf]):
                return wbuf
        return np.frombuffer(raw, dtype=np.uint8)

    # ---- host tier --------------------------------------------------------

    # re-reads of a chunk whose page crc verification failed: the file may
    # be fine and the copy in hand flipped in transit (page cache, DMA, an
    # injected flip); a fresh read from source is the CORRUPTION domain's
    # recovery. Persistent mismatches mean the file itself is bad and the
    # CorruptionError propagates.
    _CRC_REREADS = 2

    def _decode_leaf(self, f, rg: int, leaf: LeafSchema,
                     want_levels: bool = False):
        """Decode one (row group, leaf) into host numpy buffers: (rows,
        values, offsets, validity, lists). ``lists``: a one-level LIST's
        (list rows, list offsets, list validity); with ``want_levels`` (a
        nested plan) the raw (defs, reps) level streams instead."""
        from ..faultinj import sandbox
        from ..faultinj.guard import guarded_dispatch
        from ..memory.integrity import CorruptionError
        last: Optional[CorruptionError] = None
        for _attempt in range(1 + self._CRC_REREADS):
            watchdog.checkpoint()  # re-read boundary: stop if cancelled
            buf = self._read_chunk(f, rg, leaf)
            if sandbox.active("parquet_page_decode"):
                # crash containment: the decode runs in a sandbox worker
                # that re-opens the file from the footer bytes; a native
                # SIGSEGV there is a recoverable CRASH, not executor death
                verify = bool(config.get("parquet.verify_crc"))

                def _sandbox_decode(buf=buf):
                    try:
                        return sandbox.sandbox_call(
                            "parquet_page_decode",
                            sandbox.file_target("parquet_decode_chunk"),
                            self._lib._name, self._footer, rg, leaf.index,
                            buf.tobytes(), leaf.physical, leaf.max_rep,
                            want_levels, verify,
                            quarantine_key=(
                                f"{self._path}:{rg}:{leaf.index}"))
                    except sandbox.WorkerCrashError:
                        raise
                    except RuntimeError as e:
                        if ("(corruption)" in str(e)
                                and not isinstance(e, CorruptionError)):
                            # the standalone worker module stays free of
                            # the integrity taxonomy; restore it here
                            raise CorruptionError(str(e)) from e
                        raise

                try:
                    return guarded_dispatch("parquet_page_decode",
                                            _sandbox_decode)
                except CorruptionError as e:
                    last = e
                    continue  # discard and re-read from source
            out = _OutC()

            def _native_decode(buf=buf, out=out):
                err = ctypes.c_char_p()
                rc = self._lib.pqd_decode_chunk2(
                    self._h, rg, leaf.index,
                    buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    len(buf), 1 if want_levels else 0, ctypes.byref(out),
                    ctypes.byref(err))
                if rc != 0:
                    msg = err.value.decode() if err.value else "unknown error"
                    self._lib.pqd_free(err)
                    text = f"decode {leaf.name!r} rg={rg} failed: {msg}"
                    if "(corruption)" in msg:
                        raise CorruptionError(text)
                    raise RuntimeError(text)

            # the native decode fills `out` only on rc == 0, so a retried
            # attempt starts clean
            try:
                guarded_dispatch("parquet_page_decode", _native_decode)
            except CorruptionError as e:
                last = e  # detection already counted by the guard
                continue  # recovery: discard and re-read from source
            return unpack_out(self._lib, out, leaf.physical, leaf.max_rep,
                              want_levels)
        raise last

    def _to_column(self, leaf: LeafSchema, rows: int, values: np.ndarray,
                   offsets: Optional[np.ndarray],
                   validity: Optional[np.ndarray], lists=None) -> Column:
        """Host buffers -> a Column on the reader's device (one copy per
        buffer). A one-level LIST leaf's buffers are its elements, and
        ``lists`` = (list rows, list offsets, list validity) wraps them."""
        dev = self._device
        if leaf.max_rep == 1:
            child = self._to_column(leaf.element(), rows, values, offsets,
                                    validity)
            lrows, loffs, lvalid = lists
            return Column(dt.LIST, int(lrows),
                          validity=None if lvalid is None else
                          torch.from_numpy(lvalid.astype(bool)).to(dev),
                          offsets=torch.from_numpy(loffs).to(dev),
                          children=(child,))
        dtype = leaf.dtype
        vmask = None if validity is None else torch.from_numpy(
            validity.astype(bool)).to(dev)
        if dtype.id is TypeId.STRING:
            return Column(dtype, rows, data=torch.from_numpy(values).to(dev),
                          validity=vmask,
                          offsets=torch.from_numpy(offsets).to(dev))
        host = values.view(dtype.np_dtype)
        if dtype.id is TypeId.DECIMAL128:
            host = host.reshape(rows, 4)  # 16-byte little-endian limbs
        data = _host_to_tensor(host, dtype, dev)
        return Column(dtype, rows, data=data, validity=vmask)

    def _concat_parts(self, leaf: LeafSchema, parts) -> Column:
        """Each row group's host buffers cross to the device on their own
        and concatenate there (the JAX package concatenates them on the
        host first: the same column)."""
        from ..columnar.table_ops import concat_columns
        cols = [self._to_column(leaf, *p) for p in parts]
        return cols[0] if len(cols) == 1 else concat_columns(cols)

    @staticmethod
    def _part_nbytes(p) -> int:
        n = sum(x.nbytes for x in p[1:4] if x is not None)
        if p[4] is not None:
            n += sum(x.nbytes for x in p[4] if isinstance(x, np.ndarray))
        return n

    def _assemble_nested(self, plan: ColumnPlan, by_leaf) -> Column:
        """Each leaf's row-group parts (level mode) joined on the host,
        the column tree rebuilt from the levels (parquet/nested.py) in
        numpy, then moved to the device."""
        from .nested import LeafLevels, assemble_column
        levels = {}
        for leaf in plan.leaves:
            parts = by_leaf[leaf.index]
            rows = sum(p[0] for p in parts)
            offsets = None
            if leaf.physical == _PT_BYTE_ARRAY:
                offsets = _rebase_offsets([(p[0], p[2]) for p in parts])
            validity = None
            if any(p[3] is not None for p in parts):
                validity = np.concatenate([
                    p[3] if p[3] is not None
                    else np.ones(p[0], dtype=np.uint8) for p in parts])
            elem = leaf.elem_dtype if leaf.max_rep == 1 else leaf.dtype
            levels[leaf.index] = LeafLevels(
                np.concatenate([p[4][0] for p in parts]),
                np.concatenate([p[4][1] for p in parts]), rows,
                np.concatenate([p[1] for p in parts]), offsets, validity,
                elem, leaf.physical, leaf.max_def)
        return assemble_column(plan.tree, levels, "cpu")

    # ---- predicate pushdown -------------------------------------------------

    @staticmethod
    def _pushdown_conjuncts(predicate):
        """Equality conjuncts usable for row-group pruning: (column
        index, literal byte-set) pairs where the predicate is an AND-tree
        and the pair is ``col(i) == "lit"``, or an OR of such equalities
        on ONE column (the IN shape). A row group whose dictionary lacks
        EVERY literal of any one conjunct can contain no qualifying
        row."""
        from ..plan import expr as ex

        def eq_set(x):
            if isinstance(x, ex.BinOp):
                if x.op == "or":
                    a, b = eq_set(x.left), eq_set(x.right)
                    if a is not None and b is not None and a[0] == b[0]:
                        return (a[0], a[1] | b[1])
                    return None
                if x.op == "eq":
                    l, r = x.left, x.right
                    if isinstance(l, ex.Lit):
                        l, r = r, l
                    if (isinstance(l, ex.Col) and isinstance(r, ex.Lit)
                            and isinstance(r.value, str)):
                        return (l.index, frozenset((r.value.encode(),)))
            return None

        out = []

        def walk(x):
            if isinstance(x, ex.BinOp) and x.op == "and":
                walk(x.left)
                walk(x.right)
                return
            got = eq_set(x)
            if got is not None:
                out.append(got)

        walk(predicate)
        return out

    @staticmethod
    def _range_conjuncts(predicate):
        """Integer-comparison conjuncts usable for min/max pruning:
        (column index, op, literal) triples where the predicate is an
        AND-tree and the triple is ``col(i) <op> lit`` with op one of
        lt/le/gt/ge/eq (literal on either side; flipped to col-first).
        Null rows never satisfy a comparison, so a chunk whose NON-NULL
        value range provably excludes the literal holds no qualifying
        row regardless of its null count."""
        from ..plan import expr as ex
        _FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                 "eq": "eq"}
        out = []

        def leafc(x):
            if not (isinstance(x, ex.BinOp) and x.op in _FLIP):
                return None
            l, r, op = x.left, x.right, x.op
            if isinstance(l, ex.Lit):
                l, r, op = r, l, _FLIP[op]
            if (isinstance(l, ex.Col) and isinstance(r, ex.Lit)
                    and isinstance(r.value, int)
                    and not isinstance(r.value, bool)):
                return (l.index, op, int(r.value))
            return None

        def walk(x):
            if isinstance(x, ex.BinOp) and x.op == "and":
                walk(x.left)
                walk(x.right)
                return
            got = leafc(x)
            if got is not None:
                out.append(got)

        walk(predicate)
        return out

    @staticmethod
    def _range_excludes(lo: int, hi: int, op: str, lit: int) -> bool:
        """True when no value in [lo, hi] can satisfy ``value <op> lit``."""
        if op == "eq":
            return lit < lo or lit > hi
        if op == "lt":
            return lo >= lit
        if op == "le":
            return lo > lit
        if op == "gt":
            return hi <= lit
        if op == "ge":
            return hi < lit
        return False

    def _int_ranges(self):
        """{(row group, leaf index): (min, max)} from the footer's
        column-chunk statistics, parsed once, defensively (corrupt or
        absent stats yield no entry; see parquet/stats.py)."""
        if not hasattr(self, "_int_ranges_cache"):
            from . import stats
            self._int_ranges_cache = stats.chunk_int_ranges(self._footer)
        return self._int_ranges_cache

    def _probe_dictionary(self, f, g: int, leaf: LeafSchema):
        """Pushdown statistic for one (row group, string leaf): the
        dictionary page's entry set, whether every data page is
        dictionary-encoded (a fallback chunk can hold literals outside
        the dictionary), and the data-page count. None when the chunk
        has no parsable dictionary page. Cached per (group, leaf)."""
        key = (g, leaf.index)
        if key in self._probe_cache:
            return self._probe_cache[key]
        from . import device_decode as dd
        off, length, _, _ = self._chunk_range(g, leaf.index)
        f.seek(off)
        buf = np.frombuffer(f.read(length), dtype=np.uint8)
        res = None
        try:
            blob, pages = dd.extract_pages(self._lib, self._h, g,
                                           leaf.index, buf)
        except RuntimeError:
            pages = None  # corrupt/unsupported: never prune on it
        if pages is not None:
            reader_metrics.inc("pushdown_probes")
            entries = None
            all_dict = True
            n_data = 0
            for p in pages:
                if p.ptype == 2:
                    if p.encoding in (dd._ENC_PLAIN, dd._ENC_PLAIN_DICT):
                        entries = dd.dictionary_entry_set(blob, p)
                else:
                    n_data += 1
                    if p.encoding not in (dd._ENC_PLAIN_DICT,
                                          dd._ENC_RLE_DICT):
                        all_dict = False
            if entries is not None:
                res = (entries, all_dict, n_data)
        self._probe_cache[key] = res
        return res

    def _group_prunable(self, f, g: int) -> Optional[Tuple[str, int]]:
        """(skip kind, data-page count of the proving chunk) when row
        group ``g`` provably holds no qualifying row, else None. Kind is
        ``"stat"`` (footer min/max excluded a range conjunct: zero page
        reads) or ``"membership"`` (the dictionary-page probe missed
        every equality literal)."""
        ranges = self._int_ranges() if self._range_conj else {}
        for idx, op, lit in self._range_conj:
            leaf = self._selected_plans[idx].leaves[0]
            if (leaf.physical not in (_PT_INT32, _PT_INT64)
                    or leaf.dtype.is_decimal):
                continue
            rng = ranges.get((g, leaf.index))
            if rng is None:
                continue  # absent/corrupt stats: never prune
            if self._range_excludes(rng[0], rng[1], op, lit):
                return ("stat", 0)
        for idx, lits in self._conjuncts:
            leaf = self._selected_plans[idx].leaves[0]
            if leaf.physical != _PT_BYTE_ARRAY:
                continue
            probe = self._probe_dictionary(f, g, leaf)
            if probe is None:
                continue
            entries, all_dict, n_data = probe
            if not all_dict:
                # dictionary-fallback chunk: PLAIN pages may hold values
                # outside the dictionary, so membership proves nothing
                continue
            if not (lits & entries):
                return ("membership", n_data)
        return None

    def _qualifying_groups(self) -> List[int]:
        """Row groups left after predicate pushdown (all of them when
        there is no predicate or pushdown is off). Skipped groups are
        counted: ``pages_skipped`` = data pages of the chunk that proved
        the skip, ``bytes_skipped`` = summed compressed bytes of every
        selected chunk in the group, none of which is decoded or
        shipped."""
        groups = list(range(self.num_row_groups))
        if self._predicate is None \
                or not config.get("parquet.predicate_pushdown"):
            return groups
        if not hasattr(self, "_conjuncts"):
            self._conjuncts = self._pushdown_conjuncts(self._predicate)
            self._range_conj = self._range_conjuncts(self._predicate)
        if not self._conjuncts and not self._range_conj:
            return groups
        keep, skipped = [], []
        with open(self._path, "rb") as f:
            for g in groups:
                why = self._group_prunable(f, g)
                if why is None:
                    keep.append(g)
                else:
                    skipped.append((g,) + why)
        if not keep and skipped \
                and any(p.kind != "simple" for p in self._selected_plans):
            # a nested column has no 0-row shape to build: keep one group
            # (its rows are filtered downstream anyway), as the JAX
            # package does
            keep.append(skipped.pop()[0])
        for g, kind, n_data in skipped:
            reader_metrics.inc("row_groups_skipped")
            reader_metrics.inc(f"{kind}_skips")
            reader_metrics.inc("pages_skipped", n_data)
            reader_metrics.inc("bytes_skipped", self._rg_bytes(g))
        return keep

    # ---- reading ------------------------------------------------------------

    def iter_chunks(self, byte_budget: Optional[int] = None) -> Iterator[Table]:
        """Yield one Table per chunk of row groups.

        A chunk is the longest run of consecutive row groups whose summed
        compressed column-chunk bytes stay within ``byte_budget`` (default:
        ``parquet.chunk_byte_budget``; always at least one row group, the
        reference chunked reader's guarantee). Row groups pruned by
        predicate pushdown never enter a chunk."""
        if byte_budget is None:
            byte_budget = int(config.get("parquet.chunk_byte_budget"))
        pending = self._qualifying_groups()
        i, n = 0, len(pending)
        while i < n:
            group = [pending[i]]
            used = self._rg_bytes(pending[i])
            i += 1
            while i < n:
                nxt = self._rg_bytes(pending[i])
                if used + nxt > byte_budget:
                    break
                group.append(pending[i])
                used += nxt
                i += 1
            yield self._read_groups(group)

    def _empty_plan_column(self, plan: ColumnPlan) -> Column:
        """0-row Column for a simple plan (every row group was pruned)."""
        leaf = plan.leaves[0]
        offsets = (np.zeros(1, np.int32)
                   if leaf.physical == _PT_BYTE_ARRAY else None)
        lists = ((0, np.zeros(1, np.int32), None)
                 if leaf.max_rep == 1 else None)
        col = self._to_column(leaf, 0, np.zeros(0, np.uint8), offsets, None,
                              lists)
        if (leaf.physical == _PT_BYTE_ARRAY and leaf.max_rep == 0
                and self._device_tier_enabled()
                and bool(config.get("parquet.encoded_strings"))):
            # keep the encoded shape: plans that resolved string literals
            # against DICT32 columns must still see DICT32 (with an empty
            # dictionary) when every group is pruned
            from ..columnar.dictionary import dict_column
            col = dict_column(torch.zeros(0, dtype=torch.int32,
                                          device=self._device), col)
        return col

    def _read_groups(self, groups: Sequence[int]) -> Table:
        if not groups:
            return Table(tuple(self._empty_plan_column(p)
                               for p in self._selected_plans))
        # Decode column plans in parallel: the native calls run outside
        # the GIL (ctypes releases it). A sliding window of at most
        # `workers` in-flight plans bounds host peak to ~workers plans'
        # decoded bytes; each finished plan ships under a device
        # reservation and its host buffers are dropped before the next
        # decode is admitted.
        from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, \
            wait

        device_tier = self._device_tier_enabled()

        # the caller's deadline rides into the pool threads: adopt() shares
        # the absolute expiry and cancel token, so a decode hang inside a
        # worker is registered with (and cancellable by) the watchdog
        _dl = watchdog.current_deadline()
        _snap = _dl.snapshot() if _dl is not None else None

        def decode_plan(plan: ColumnPlan):
            ctx = (watchdog.Deadline.adopt(_snap) if _snap is not None
                   else contextlib.nullcontext())
            leaf = plan.leaves[0]
            with ctx, open(self._path, "rb") as f:
                if plan.kind == "nested":
                    t = time.perf_counter()
                    by_leaf = {}
                    for lf in plan.leaves:
                        self._route(lf, "host", "host_columns_unsupported")
                        by_leaf[lf.index] = [self._decode_leaf(f, g, lf, True)
                                             for g in groups]
                    self._time("host_decode_ms",
                               (time.perf_counter() - t) * 1e3)
                    return {"nested": by_leaf}
                if device_tier:
                    dev = self._extract_leaf_pages(f, groups, leaf)
                    if dev is not None:
                        return {"device": dev}
                else:
                    self._route(leaf, "host", "host_columns_by_config")
                t = time.perf_counter()
                parts = [self._decode_leaf(f, g, leaf) for g in groups]
                self._time("host_decode_ms",
                           (time.perf_counter() - t) * 1e3)
                return {"host": parts}

        def ship(plan: ColumnPlan, by_leaf):
            leaf = plan.leaves[0]
            if "device" in by_leaf:
                return self._ship_device(leaf, by_leaf["device"])
            parts = by_leaf.get("host")
            if parts is None:
                parts = [p for ps in by_leaf["nested"].values() for p in ps]
            est = sum(self._part_nbytes(p) for p in parts)
            t = time.perf_counter()
            with device_reservation(est) as took:
                t_res = time.perf_counter() - t
                t = time.perf_counter()
                if plan.kind == "nested":
                    col = self._assemble_nested(plan, by_leaf["nested"])
                    self._time("assemble_ms",
                               (time.perf_counter() - t) * 1e3)
                    t = time.perf_counter()
                    col = to_device(col, self._device)
                else:
                    col = self._concat_parts(leaf, parts)
                if self._timings is not None:
                    _sync(self._device)
                t_h2d = time.perf_counter() - t
                t = time.perf_counter()
                release_barrier(col, took)
            t_res += time.perf_counter() - t
            self._time("reservation_ms", t_res * 1e3)
            self._time("h2d_ms", t_h2d * 1e3)
            return col

        n = len(self._selected_plans)
        workers = int(config.get("parquet.decode_workers"))
        if workers <= 0:
            workers = min(8, os.cpu_count() or 1)
        workers = min(workers, max(1, n))
        if workers <= 1 or n <= 1:
            return Table(tuple(
                ship(p, decode_plan(p)) for p in self._selected_plans))

        cols: List[Optional[Column]] = [None] * n
        with ThreadPoolExecutor(max_workers=workers) as pool:
            pending = iter(enumerate(self._selected_plans))
            futures = {}

            def admit():
                try:
                    i, plan = next(pending)
                except StopIteration:
                    return
                futures[pool.submit(decode_plan, plan)] = (i, plan)

            for _ in range(workers):
                admit()
            while futures:
                # bounded wait: the timeout derives from the active
                # deadline's remaining budget, and an empty wake runs the
                # cancel/deadline checkpoint, so a wedged decode worker
                # cannot hang the whole read
                done, _ = wait(list(futures),
                               timeout=watchdog.derive_timeout(1.0),
                               return_when=FIRST_COMPLETED)
                if not done:
                    watchdog.checkpoint()
                    continue
                # ship every completed plan (dropping its host buffers)
                # BEFORE admitting replacements, so resident decoded bytes
                # never exceed ~workers plans
                for fut in done:
                    i, plan = futures.pop(fut)
                    cols[i] = ship(plan, fut.result())
                for _ in range(len(done)):
                    admit()
        return Table(tuple(cols))

    # ---- device tier ------------------------------------------------------

    def _device_tier_enabled(self) -> bool:
        """The device tier moves the RLE/dictionary/PLAIN expansion onto
        the reader's device so only encoded page bytes cross (auto: a CUDA
        reader; see utils/backend.py)."""
        from ..utils.backend import tier_is_device
        return tier_is_device("parquet.device_decode", self._device)

    def _route(self, leaf: LeafSchema, tier: str, counter: str,
               encodings=None) -> None:
        route_metrics.inc(counter)
        self.routes[leaf.name] = {"tier": tier, "why": counter,
                                  "encodings": encodings}

    def _extract_leaf_pages(self, f, groups, leaf):
        """Host half of the device tier: page headers + decompression per
        row group. None when a group's page inventory is not the device
        tier's, or a page checksum failed (counted; the host tier then
        re-reads the chunk from source). Any other error raises."""
        from . import device_decode as dd
        out = []
        encodings = set()
        t = time.perf_counter()
        try:
            for g in groups:
                _, _, nv, _ = self._chunk_range(g, leaf.index)
                buf = self._read_chunk(f, g, leaf)
                try:
                    blob, pages = dd.extract_pages(self._lib, self._h, g,
                                                   leaf.index, buf)
                except RuntimeError as e:
                    if "(corruption)" not in str(e):
                        raise
                    # a bad page crc: count the detection here (this call
                    # is not under a guard) and re-read from source on the
                    # host tier, the CORRUPTION domain's recovery
                    from ..faultinj.guard import metrics
                    metrics.bump("corruption_detected")
                    self._route(leaf, "host", "host_columns_corruption")
                    return None
                encodings.update((p.ptype, p.encoding) for p in pages)
                if not dd.pages_supported(leaf, pages):
                    self._route(leaf, "host", "host_columns_unsupported",
                                _encoding_names(encodings))
                    return None
                lrows = (self._lib.pqd_rg_num_rows(self._h, g)
                         if leaf.max_rep == 1 else 0)
                out.append(dd.prepare_chunk(leaf, blob, pages, nv, lrows))
        finally:
            self._time("host_extract_ms", (time.perf_counter() - t) * 1e3)
        self._route(leaf, "device", "device_columns",
                    _encoding_names(encodings))
        return out

    def _ship_device(self, leaf, parts) -> Column:
        from ..columnar.table_ops import concat_columns
        from ..faultinj.guard import guarded_dispatch
        from . import device_decode as dd
        # decoded footprint estimate from metadata, not blob size: a
        # well-compressed dict/RLE column decodes to far more than its
        # encoded bytes (8 B lane + 8 B gather index + validity per row,
        # plus the resident blob); dictionary strings add rows x the mean
        # entry length when they are gathered
        est = 0
        for chunk in parts:
            nv = chunk.rows
            est += int(nv) * 17 + int(chunk.blob.nbytes)
            if leaf.physical == _PT_BYTE_ARRAY \
                    and not config.get("parquet.encoded_strings"):
                for p in chunk.pages:
                    if p.ptype == 2 and p.num_values:
                        avg = max(1, (p.val_len - 4 * p.num_values)
                                  // p.num_values)
                        est += int(nv) * int(avg)
        times = {} if self._timings is not None else None
        t = time.perf_counter()
        with device_reservation(est) as took:
            t_res = time.perf_counter() - t
            cols = [guarded_dispatch("parquet_device_decode",
                                     dd.decode_leaf_device, leaf, chunk,
                                     self._device, times)
                    for chunk in parts]
            t = time.perf_counter()
            col = cols[0] if len(cols) == 1 else concat_columns(cols)
            if times is not None:
                _sync(self._device)
                times["decode_ms"] = times.get("decode_ms", 0.0) + (
                    time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            release_barrier(col, took)
        t_res += time.perf_counter() - t
        self._time("reservation_ms", t_res * 1e3)
        if times is not None:
            walk = sum(chunk.walk_ms for chunk in parts)
            for k in ("h2d_ms", "decode_ms", "h2d_bytes"):
                self._time(k, times.get(k, 0))
            self._time("walk_ms", walk)
            self._time(f"walk_ms:{leaf.name}", walk)
        return col

    def read_all(self) -> Table:
        """Decode the whole file into one Table (host memory scales with
        the file; use iter_chunks for bounded-memory streaming). Row
        groups pruned by predicate pushdown are never decoded."""
        return self._read_groups(self._qualifying_groups())

    def close(self):
        if self._h:
            self._lib.pqd_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _rebase_offsets(parts) -> np.ndarray:
    """int32 offsets of (rows, offsets) parts one after the other, each
    shifted by the ends of those before."""
    total = sum(r for r, _ in parts)
    out = np.zeros(total + 1, dtype=np.int32)
    base = pos = 0
    for r, o in parts:
        out[pos + 1:pos + 1 + r] = o[1:] + base
        base += int(o[-1])
        pos += r
    return out


_ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE",
                   8: "RLE_DICTIONARY"}


def _encoding_names(encodings) -> List[str]:
    """Sorted "DICT_PAGE:<enc>" / "DATA:<enc>" names of a chunk's pages."""
    return sorted(f"{'DICT_PAGE' if t == 2 else 'DATA'}:"
                  f"{_ENCODING_NAMES.get(e, e)}" for t, e in encodings)


def read_parquet(path: str, columns: Optional[Sequence[str]] = None,
                 predicate=None, device="cuda") -> Table:
    """One-shot convenience: decode an entire file to a Table on
    ``device``. ``predicate`` (a plan expression over the selected
    columns) enables row-group pruning; the caller still applies the
    predicate to the returned rows."""
    with ParquetReader(path, columns=columns, predicate=predicate,
                       device=device) as r:
        return r.read_all()
