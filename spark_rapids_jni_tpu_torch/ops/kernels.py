"""The CUDA kernels of this port: wrappers, plain versions, launch counts.

B1-B3 each replace one Pallas kernel of the JAX package's
ops/pallas_kernels.py:

  B1 ``murmur3_fixed_rows``  csrc/row_hash.cu   build_murmur3_fixed_kernel
  B2 ``xxhash64_fixed_rows`` csrc/row_hash.cu   build_xxhash64_fixed_kernel
  B3 ``rowconv_fixed_words`` csrc/rowconv.cu    build_rowconv_fixed_kernel

H1 ``segment_float_agg`` (csrc/segment_agg.cu) stands where the JAX
package leaves float segment sums, minima and maxima to XLA: no torch op on
the card sums a segment in row order with XLA:CPU's flushes. H2
``decimal128_op`` (csrc/decimal128.cu) stands where it computes Spark's
DECIMAL128 arithmetic in 256-bit limb math of XLA ops (its ops/int256.py):
one thread a row holds that math in registers.

A wrapper launches its kernel when its input tensors lie on a CUDA device,
and raises if the kernel cannot be built or launched. It computes the
plain PyTorch version (``*_plain``, beside it) only when its inputs lie on
the CPU. There is no switch and no fallback between the two. Each wrapper
counts its launches in its ``launches`` attribute; ``reset_launches``
sets every count to 0.

The sources are compiled at first use with nvcc for sm_90a into shared
libraries with a plain C interface (``build/torch_kernels/`` at the root
of the checkout), and loaded with ctypes. ``build_all`` compiles every
source at once, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("row_hash", "rowconv", "segment_agg", "decimal128")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_VP = ctypes.c_void_p
_SIGNATURES = {
    # (schema pointers, offsets pointers, kinds, validity pointers, list
    #  row starts, list row ends, element validity pointers, ncols, n,
    #  seed, per-row seeds or null, out, stream)
    "srjt_murmur3_rows": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_uint, _VP, _VP, _VP],
    "srjt_xxhash64_rows": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_ulonglong, _VP, _VP,
                           _VP],
    # (device metadata, nslots, nwin, npairs, npieces, rows per tile,
    #  stage bytes, sub-tile rows, sub-tile bytes, n, out, stream)
    "srjt_rowconv_rows": [_VP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _VP,
                          _VP],
    # (z, valid, starts, G, sum, min, max, flushed-chunk count or null,
    #  stream)
    "srjt_segment_float_agg": [_VP, _VP, _VP, ctypes.c_longlong, _VP, _VP,
                               _VP, _VP, _VP],
    # (x, n, out, stream)
    "srjt_dadd_chain": [_VP, ctypes.c_longlong, _VP, _VP],
    # (op, a, a row stride, b, b row stride, n, a scale, b scale, out
    #  scale, cast interim, out, overflow, error flag, stream)
    "srjt_decimal128_op": [ctypes.c_int, _VP, ctypes.c_longlong, _VP,
                           ctypes.c_longlong, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, _VP, _VP, _VP, _VP],
}


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source not built yet, one nvcc process per source,
    all started together. Returns {name: ptxas report} for the sources
    compiled by this call; raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return reports


def load_library(path) -> ctypes.CDLL:
    """A built kernel library, its C functions typed."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    lib.srjt_error_string.argtypes = [ctypes.c_int]
    lib.srjt_error_string.restype = ctypes.c_char_p
    return lib


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = _libs[name] = load_library(path)
        return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.srjt_error_string(err).decode()}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _where(tensors: Sequence[Optional[torch.Tensor]]) -> torch.device:
    """The one device of the tensors (None entries skipped): the CPU, or
    cuda:0 — the libraries launch on their CUDA runtime's device 0."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu" or (dev.type == "cuda" and dev.index in (None, 0)):
        return dev
    raise ValueError(f"unsupported device {dev}: the kernels run on cuda:0")


def _schema_tensors(schema) -> List[Optional[torch.Tensor]]:
    out: List[Optional[torch.Tensor]] = []
    for kind, words, v in schema:
        if kind == "list":
            starts, ends, lkind, lwords, lvalid = words
            out += [starts, ends, lvalid]
            kind, words = lkind, lwords
        out += list(words) if kind == "str" else [words]
        out.append(v)
    return out


def _schema_device(schema) -> torch.device:
    return _where(_schema_tensors(schema))


# the wrappers' launch counts are bumped from several task threads at
# once (parallel/task_executor.py): each bump and reset under one lock
_launch_lock = threading.Lock()


def _count_launch(fn) -> None:
    with _launch_lock:
        fn.launches += 1


def reset_launches() -> None:
    with _launch_lock:
        for fn in (murmur3_fixed_rows, xxhash64_fixed_rows,
                   rowconv_fixed_words, segment_float_agg, decimal128_op):
            fn.launches = 0


# ---------------------------------------------------------------------------
# B1 / B2: row hashes over fixed-width and STRING columns
# ---------------------------------------------------------------------------
# A hash schema is a list of (kind, words, validity): kind "u32" with int32
# words or "u64" with int64 words (the bits _fixed_element_words made), or
# kind "str" with words = (int32[n+1] offsets, uint8 characters) of a
# STRING column, or (B1 only) kind "list" with words = (int32[n] row
# starts, int32[n] row ends, leaf kind, leaf words, leaf validity): row i
# hashes leaf elements [starts[i], ends[i]) in order, each a "u32", "u64"
# or "str" entry of the leaf, skipping null elements; and a bool[n]
# validity or None (a null row passes the running hash through). The
# wrappers keep the names of the Pallas entries they replace, which hash
# fixed-width columns only; here one launch hashes a whole mixed row, as
# the reference's CUDA does (murmur_hash.cu:187, xxhash64.cu:109-175). A
# schema of more than MAX_HASH_COLUMNS entries takes successive launches,
# each seeded per row by the hashes of the one before (``seeds``).

MAX_HASH_COLUMNS = 64  # csrc/row_hash.cu: the schema rides in the params
_HASH_KINDS = {"u32": 0, "u64": 1, "str": 2}
_LIST_KIND = 3  # csrc kListU32; + the leaf's kind


def _str_words(i: int, words, rows: int):
    offsets, chars = words
    if (offsets.dtype != torch.int32 or offsets.shape != (rows + 1,)
            or chars.dtype != torch.uint8 or chars.dim() != 1):
        raise ValueError(f"hash column {i}: str words must be "
                         f"int32[{rows + 1}] offsets and uint8 characters")
    return offsets.contiguous(), chars.contiguous()


def _fixed_words(i: int, kind: str, words, rows: int) -> torch.Tensor:
    want = torch.int32 if kind == "u32" else torch.int64
    if words.dtype != want or words.shape != (rows,):
        raise ValueError(f"hash column {i}: {kind} words must be "
                         f"{want}[{rows}], got {words.dtype}"
                         f"{list(words.shape)}")
    return words.contiguous()


def _bool_mask(i: int, v: torch.Tensor, rows: int) -> torch.Tensor:
    if v.dtype != torch.bool or v.shape != (rows,):
        raise ValueError(f"hash column {i}: validity must be bool[{rows}]")
    return v.contiguous()


def _hash_args(schema, n: int):
    if len(schema) > MAX_HASH_COLUMNS:
        raise ValueError(f"row hash over {len(schema)} columns; one launch "
                         f"takes at most {MAX_HASH_COLUMNS}")
    k = len(schema)
    keep = []
    ptrs, offs, valid, starts, ends, evalid = (
        (ctypes.c_void_p * k)() for _ in range(6))
    kinds = (ctypes.c_int * k)()
    for i, (kind, words, v) in enumerate(schema):
        rows, base = n, 0
        if kind == "list":
            s, e, kind, words, ev = words
            for t in (s, e):
                if t.dtype != torch.int32 or t.shape != (n,):
                    raise ValueError(f"hash column {i}: list starts and "
                                     f"ends must be int32[{n}]")
            s, e = s.contiguous(), e.contiguous()
            keep += [s, e]
            starts[i], ends[i] = s.data_ptr(), e.data_ptr()
            rows = (int(words[0].shape[0]) - 1 if kind == "str"
                    else int(words.shape[0]))
            if ev is not None:
                ev = _bool_mask(i, ev, rows)
                keep.append(ev)
                evalid[i] = ev.data_ptr()
            base = _LIST_KIND
        if kind == "str":
            o, words = _str_words(i, words, rows)
            keep.append(o)
            offs[i] = o.data_ptr()
        else:
            words = _fixed_words(i, kind, words, rows)
        keep.append(words)
        ptrs[i] = words.data_ptr()
        kinds[i] = base + _HASH_KINDS[kind]
        if v is not None:
            v = _bool_mask(i, v, n)
            keep.append(v)
            valid[i] = v.data_ptr()
    return keep, (ptrs, offs, kinds, valid, starts, ends, evalid)


def _padded(words) -> Tuple[torch.Tensor, torch.Tensor]:
    """(padded bytes, lengths) of a "str" schema entry's words."""
    from ..columnar.strings import densify_offsets, pad_width
    offsets, chars = words
    lengths = offsets[1:] - offsets[:-1]
    max_len = int(lengths.max()) if lengths.numel() else 0
    return densify_offsets(chars, offsets, pad_width(max_len))


def _mm_entry(kind: str, words):
    """murmur3 of one schema entry's element i with per-row seeds h:
    ``fn(h, i)`` (i int64 indices of the entry's elements)."""
    from . import hashing as H
    if kind == "str":
        mat, lengths = _padded(words)
        return lambda h, i: H._mm_bytes(h, mat.index_select(0, i),
                                        lengths.index_select(0, i))
    w = words.to(torch.int64)
    if kind == "u32":
        w = w & 0xFFFFFFFF
        return lambda h, i: H._mm_u32(h, w.index_select(0, i))
    return lambda h, i: H._mm_u64(h, w.index_select(0, i))


def _mm_list_plain(h: torch.Tensor, words, v) -> torch.Tensor:
    """A "list" entry of B1, plain: row i's leaf elements in order, each
    hash the next one's seed, null elements skipped. The rows are visited
    longest first, so step j touches only the rows with more than j
    elements and the steps add up to the elements."""
    starts, ends, lkind, lwords, lvalid = words
    lens = (ends - starts).to(torch.int64)
    if v is not None:
        lens = torch.where(v, lens, 0)
    if lens.numel() == 0 or int(lens.max()) <= 0:
        return h
    width = int(lens.max())
    order = torch.argsort(lens, descending=True, stable=True)
    # longer[j]: rows with more than j elements
    longer = (lens.numel() - torch.cumsum(
        torch.bincount(lens, minlength=width + 1), 0)).tolist()
    hs = h.index_select(0, order)
    first = starts.to(torch.int64).index_select(0, order)
    elem = _mm_entry(lkind, lwords)
    for j in range(width):
        c = longer[j]
        i = first[:c] + j
        cur = hs[:c]
        nh = elem(cur, i)
        if lvalid is not None:
            nh = torch.where(lvalid.index_select(0, i), nh, cur)
        hs[:c] = nh
    out = torch.empty_like(h)
    out[order] = hs
    return out


def _seed_lanes(seed: int, n: int, seeds: Optional[torch.Tensor],
                dev: torch.device, mask: int) -> torch.Tensor:
    """int64 running hashes to start from: ``seeds`` (per row) or
    ``seed``."""
    if seeds is not None:
        return seeds.to(torch.int64) & mask
    from . import hashing as H
    return torch.full((n,), H._s64(seed & mask), dtype=torch.int64,
                      device=dev)


def murmur3_fixed_rows_plain(schema, seed: int, n: int,
                             seeds: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of B1: int32[n] Spark murmur3 row hashes
    (``seeds``: int32[n] per-row seeds in place of ``seed``)."""
    from . import hashing as H
    dev = (_schema_device(schema) if schema
           else seeds.device if seeds is not None else torch.device("cpu"))
    h = _seed_lanes(seed, n, seeds, dev, 0xFFFFFFFF)
    for kind, words, v in schema:
        if kind == "list":
            h = _mm_list_plain(h, words, v)
            continue
        if kind == "str":
            nh = H._mm_bytes(h, *_padded(words))
        else:
            w = words.to(torch.int64)
            nh = H._mm_u32(h, w & 0xFFFFFFFF) if kind == "u32" \
                else H._mm_u64(h, w)
        h = nh if v is None else torch.where(v, nh, h)
    return h.to(torch.int32)


def _launch_hash(fn: str, schema, seed: int, n: int,
                 seeds: Optional[torch.Tensor],
                 out_dtype: torch.dtype) -> torch.Tensor:
    dev = _schema_device(schema)
    lib = _lib("row_hash")
    keep, arrays = _hash_args(schema, n)
    if seeds is not None:
        if seeds.dtype != out_dtype or seeds.shape != (n,):
            raise ValueError(f"per-row seeds must be {out_dtype}[{n}]")
        seeds = seeds.contiguous()
        keep.append(seeds)
    out = torch.empty(n, dtype=out_dtype, device=dev)
    err = getattr(lib, fn)(*(ctypes.addressof(a) for a in arrays),
                           len(schema), n, seed,
                           None if seeds is None else seeds.data_ptr(),
                           out.data_ptr(), _stream(dev))
    _check(lib, err, fn)
    return out


def _launches(fn, schema, seed: int, n: int, seeds, name: str,
              out_dtype: torch.dtype) -> torch.Tensor:
    """One launch per MAX_HASH_COLUMNS entries of the schema, each seeded
    by the hashes of the one before; each adds one to ``fn.launches``."""
    h = seeds
    for at in range(0, len(schema), MAX_HASH_COLUMNS):
        h = _launch_hash(name, schema[at:at + MAX_HASH_COLUMNS], seed, n, h,
                         out_dtype)
        _count_launch(fn)
    return h


def murmur3_fixed_rows(schema, seed: int, n: int,
                       seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B1: int32[n] Spark murmur3_32 row hashes of a schema of
    fixed-width, STRING and LIST entries (seed chained across the
    entries, null rows pass the running hash; ``seeds``: int32[n]
    per-row seeds in place of ``seed``)."""
    schema = list(schema)
    if n == 0 or not schema or _schema_device(schema).type == "cpu":
        return murmur3_fixed_rows_plain(schema, seed, n, seeds)
    return _launches(murmur3_fixed_rows, schema, seed & 0xFFFFFFFF, n, seeds,
                     "srjt_murmur3_rows", torch.int32)


def _no_lists(schema) -> None:
    if any(kind == "list" for kind, _, _ in schema):
        raise ValueError("B2 (xxhash64) takes no LIST schema entry")


def xxhash64_fixed_rows_plain(schema, seed: int, n: int,
                              seeds: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of B2: int64[n] (u64 bits) Spark xxhash64
    row hashes (``seeds``: int64[n] per-row seeds in place of ``seed``)."""
    from . import hashing as H
    _no_lists(schema)
    dev = (_schema_device(schema) if schema
           else seeds.device if seeds is not None else torch.device("cpu"))
    h = _seed_lanes(seed, n, seeds, dev, (1 << 64) - 1)
    for kind, words, v in schema:
        if kind == "str":
            nh = H._xx_bytes(h, *_padded(words))
        else:
            w = words.to(torch.int64)
            nh = H._xx_u32(h, w & 0xFFFFFFFF) if kind == "u32" \
                else H._xx_u64(h, w)
        h = nh if v is None else torch.where(v, nh, h)
    return h


# B2 over a schema with a STRING column (csrc/row_hash.cu
# xxhash64_staged_rows_kernel) works on tiles of XX_TILE_ROWS consecutive
# rows, one warp each. For each STRING column the warp copies the
# 16-byte-aligned cover of the tile's characters into shared memory when it
# fits XX_STAGE_BYTES and hashes every row from there; otherwise each 32
# rows of the tile take windows: runs of rows whose cover fits the stage,
# and a row whose own cover exceeds it is hashed from device memory. A
# row's bytes are read as aligned 32-bit words joined by funnel shifts. The
# tile plan and the emulation below mirror the kernel in plain Python for
# the CPU tests; nothing on the path calls them.

XX_TILE_ROWS = 128     # csrc/row_hash.cu kXxTile (32 * kXxRowsPerLane)
XX_STAGE_BYTES = 4096  # csrc kXxStage: characters one warp stages
_XX_PAD = 16           # csrc kXxPad: the stage's tail
_M64 = (1 << 64) - 1
_XP1, _XP2, _XP3, _XP4, _XP5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                                0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                                0x27D4EB2F165667C5)  # xxhash64's primes


@dataclass(frozen=True)
class XxTile:
    """One tile of a STRING column: ``windows`` (j0, j1, w0, w1) stage the
    tile's rows [j0, j1) from bytes [w0, w1) counted from the characters'
    16-byte-aligned base; ``device_rows`` are hashed from device memory."""

    windows: Tuple[Tuple[int, int, int, int], ...]
    device_rows: Tuple[int, ...]


def xxhash64_tile_plan(offsets, residue: int, budget: int = XX_STAGE_BYTES,
                       tile_rows: int = XX_TILE_ROWS) -> List[XxTile]:
    """B2's plan for a STRING column: its ``int32[n + 1]`` offsets, the
    address of its characters % 16 (``residue``), one XxTile per
    ``tile_rows`` rows.

    Row j's cover is [lo_j, hi_j), its bytes' 16-byte-aligned span. A tile
    whose rows' cover fits ``budget`` bytes is one window. Otherwise, in
    each 32 rows from row j0 on, a window takes the rows whose covers end
    within ``budget`` bytes of lo_j0; when row j0's own cover is longer,
    row j0 goes to the device path and the next window starts at row
    j0 + 1."""
    offs = np.asarray(offsets, dtype=np.int64)
    n = len(offs) - 1
    lo = (offs[:-1] + residue) & ~15
    hi = (offs[1:] + residue + 15) & ~15
    tiles = []
    for r0 in range(0, n, tile_rows):
        rows = min(tile_rows, n - r0)
        # the kernel's cover: from the first row's start to the tile's end
        w0 = (int(offs[r0]) + residue) & ~15
        w1 = (int(offs[r0 + rows]) + residue + 15) & ~15
        if w1 - w0 <= budget:
            tiles.append(XxTile(((0, rows, w0, w1),), ()))
            continue
        windows, device = [], []
        for s0 in range(0, rows, 32):
            sub = min(32, rows - s0)
            slo, shi = lo[r0 + s0:r0 + s0 + sub], hi[r0 + s0:r0 + s0 + sub]
            j0 = 0
            while j0 < sub:
                fit = shi[j0:] - slo[j0] <= budget
                if not fit[0]:
                    device.append(s0 + j0)
                    j0 += 1
                    continue
                j1 = j0 + int(fit.sum())
                windows.append((s0 + j0, s0 + j1, int(slo[j0]),
                                int(shi[j1 - 1])))
                j0 = j1
        tiles.append(XxTile(tuple(windows), tuple(device)))
    return tiles


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _xx_mix(h: int, k: int, width: int) -> int:
    """One 8-byte (``width`` 8) or 4-byte round of xxhash64 on ints."""
    if width == 8:
        h ^= _rotl64(k * _XP2 & _M64, 31) * _XP1 & _M64
        return (_rotl64(h, 27) * _XP1 + _XP4) & _M64
    h ^= k * _XP1 & _M64
    return (_rotl64(h, 23) * _XP2 + _XP3) & _M64


def _xx_final_int(h: int) -> int:
    h = (h ^ (h >> 33)) * _XP2 & _M64
    h = (h ^ (h >> 29)) * _XP3 & _M64
    return h ^ (h >> 32)


class _RowWords:
    """csrc RowWords: a row's bytes as aligned 32-bit words of ``mem``
    (bytes from an aligned base) from byte ``q`` on, joined by funnel
    shifts. The device path reads only words that hold a byte of the row
    (it checks); the stage's reads stay within ``limit``."""

    def __init__(self, mem: bytes, q: int, length: int, device: bool,
                 limit: int):
        self.mem, self.k0, self.s = mem, q >> 2, 8 * (q & 3)
        self.q, self.end, self.device, self.limit = (q, q + length, device,
                                                     limit)

    def word(self, k: int, need: bool) -> int:
        if self.device and not need:
            return 0
        a = 4 * (self.k0 + k)
        if self.device and not self.q - 4 < a < self.end:
            raise AssertionError(f"device word at byte {a} holds no byte of "
                                 f"the row [{self.q}, {self.end})")
        if a + 4 > self.limit:
            raise AssertionError(f"stage read at byte {a} past {self.limit}")
        return int.from_bytes(self.mem[a:a + 4], "little")

    def _funnel(self, lo: int, hi: int) -> int:
        return ((hi << 32 | lo) >> self.s) & 0xFFFFFFFF

    def u32(self, pos: int, nbytes: int) -> int:
        """Bytes [pos, pos + 4) of the row; the first ``nbytes`` its own."""
        k = pos >> 2
        return self._funnel(self.word(k, True),
                            self.word(k + 1, self.s + 8 * nbytes > 32))

    def u64(self, pos: int) -> int:
        """Bytes [pos, pos + 8) of the row, all its own."""
        k = pos >> 2
        a, b = self.word(k, True), self.word(k + 1, True)
        c = self.word(k + 2, self.s != 0)
        return self._funnel(a, b) | self._funnel(b, c) << 32


def _xx_row(seed: int, r: _RowWords, length: int) -> int:
    """csrc xx_row: Spark's xxhash64 of a row's bytes, on ints."""
    def stripe(v, k):
        return _rotl64((v + k * _XP2) & _M64, 31) * _XP1 & _M64

    off = 0
    if length >= 32:
        v = [(seed + _XP1 + _XP2) & _M64, (seed + _XP2) & _M64, seed,
             (seed - _XP1) & _M64]
        for off in range(0, length - 31, 32):
            v = [stripe(acc, r.u64(off + 8 * j)) for j, acc in enumerate(v)]
        off = length // 32 * 32
        h = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12)
             + _rotl64(v[3], 18)) & _M64
        for acc in v:
            h = ((h ^ stripe(0, acc)) * _XP1 + _XP4) & _M64
    else:
        h = (seed + _XP5) & _M64
    h = (h + length) & _M64
    while off + 8 <= length:
        h = _xx_mix(h, r.u64(off), 8)
        off += 8
    if off + 4 <= length:
        h = _xx_mix(h, r.u32(off, 4), 4)
        off += 4
    if off < length:
        t = r.u32(off, length - off)
        for _ in range(off, length):
            h = _rotl64(h ^ ((t & 0xFF) * _XP5 & _M64), 11) * _XP1 & _M64
            t >>= 8
    return _xx_final_int(h)


def xxhash64_staged_emulation(schema, seed: int, n: int,
                              residues: Optional[Sequence[int]] = None,
                              budget: int = XX_STAGE_BYTES,
                              tile_rows: int = XX_TILE_ROWS,
                              garbage: int = 0xA5) -> torch.Tensor:
    """B2's staged kernel in plain Python on CPU tensors: int64[n] (u64
    bits), as xxhash64_fixed_rows. STRING column c's characters lie at
    address % 16 ``residues[c]`` (default: their own); the bytes around
    them, which the kernel's aligned copies also read, are ``garbage``.
    Each tile of ``tile_rows`` follows xxhash64_tile_plan: a window is
    copied into a stage of ``budget`` + 16 bytes and its rows hashed from
    there, the rest from "device memory"."""
    h = [seed & _M64] * n
    for c, (kind, words, v) in enumerate(schema):
        valid = [True] * n if v is None else v.tolist()
        if kind != "str":
            width = 4 if kind == "u32" else 8
            mask = 0xFFFFFFFF if width == 4 else _M64
            for i, (k, ok) in enumerate(zip(words.tolist(), valid)):
                if ok:
                    h[i] = _xx_final_int(_xx_mix(
                        (h[i] + _XP5 + width) & _M64, k & mask, width))
            continue
        offsets, chars = words
        offs = offsets.tolist()
        res = chars.data_ptr() % 16 if residues is None else residues[c]
        mem = (bytes([garbage]) * res + chars.numpy().tobytes()
               + bytes([garbage]) * 32)
        for t, tile in enumerate(xxhash64_tile_plan(offs, res, budget,
                                                    tile_rows)):
            r0 = tile_rows * t
            for j0, j1, w0, w1 in tile.windows:
                if w1 - w0 > budget or w0 % 16 or w1 % 16:
                    raise AssertionError(f"tile {t}: window [{w0}, {w1})")
                stage = mem[w0:w1] + bytes([garbage]) * (budget + _XX_PAD
                                                         - (w1 - w0))
                for i in range(r0 + j0, r0 + j1):
                    if valid[i]:
                        q = offs[i] + res - w0
                        h[i] = _xx_row(h[i], _RowWords(
                            stage, q, offs[i + 1] - offs[i], False,
                            budget + _XX_PAD), offs[i + 1] - offs[i])
            for j in tile.device_rows:
                i = r0 + j
                if valid[i]:
                    length = offs[i + 1] - offs[i]
                    h[i] = _xx_row(h[i], _RowWords(mem, offs[i] + res,
                                                    length, True, len(mem)),
                                   length)
    return torch.tensor([x - (1 << 64) if x >> 63 else x for x in h],
                        dtype=torch.int64)


def xxhash64_fixed_rows(schema, seed: int, n: int,
                        seeds: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """B2: int64[n] (u64 bits) Spark xxhash64 row hashes of a schema of
    fixed-width and STRING columns, chained like B1."""
    schema = list(schema)
    _no_lists(schema)
    if n == 0 or not schema or _schema_device(schema).type == "cpu":
        return xxhash64_fixed_rows_plain(schema, seed, n, seeds)
    return _launches(xxhash64_fixed_rows, schema, seed & 0xFFFFFFFFFFFFFFFF,
                     n, seeds, "srjt_xxhash64_rows", torch.int64)


# ---------------------------------------------------------------------------
# B3: JCUDF fixed-width + validity words
# ---------------------------------------------------------------------------
# A row plan, made by ops/row_conversion._word_plan from the schema, lists
# per output word the pieces ORed into it. A piece is (column, part, shift):
# part 0/1/2 reads a 1/2/4-byte element, 3/4 the low/high 32 bits of an
# 8-byte one, 5 the column's validity bit; the value is shifted left by
# `shift` bits. Pieces are ordered by word.

PART_U8, PART_U16, PART_U32, PART_LO, PART_HI, PART_VALID = range(6)
_PART_BYTES = {PART_U8: 1, PART_U16: 2, PART_U32: 4, PART_LO: 8, PART_HI: 8}


def _piece_value(col: torch.Tensor, valid: Optional[torch.Tensor],
                 part: int, n: int, dev) -> torch.Tensor:
    """int64 value of one piece for every row (plain version)."""
    if part == PART_VALID:
        if valid is None:
            return torch.ones(n, dtype=torch.int64, device=dev)
        return valid.to(torch.int64)
    if part in (PART_LO, PART_HI):
        w = col.view(torch.int64)
        return w & 0xFFFFFFFF if part == PART_LO else (w >> 32) & 0xFFFFFFFF
    if part == PART_U8:
        return col.view(torch.uint8).to(torch.int64)
    if part == PART_U16:
        return col.view(torch.int16).to(torch.int64) & 0xFFFF
    return col.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def rowconv_fixed_words_plain(cols: Sequence[torch.Tensor],
                              valids: Sequence[Optional[torch.Tensor]],
                              plan: Sequence[Tuple[int, int, int, int]],
                              nwords: int, n: int) -> torch.Tensor:
    """Plain PyTorch version of B3: int32[n, nwords] JCUDF words.

    ``plan``: (word, column, part, shift) pieces (see above)."""
    dev = cols[0].device if cols else torch.device("cpu")
    acc: Dict[int, torch.Tensor] = {}
    for word, c, part, shift in plan:
        v = _piece_value(cols[c], valids[c], part, n, dev) << shift
        acc[word] = v if word not in acc else acc[word] | v
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    words = torch.stack([acc.get(w, zero) for w in range(nwords)], dim=1)
    return (words & 0xFFFFFFFF).to(torch.int32)


# The kernel (csrc/rowconv.cu) works on tiles of R rows. For each tile it
# stages, in shared memory, the R-element slice of every column that has a
# piece in the current window of words (and of every validity array with a
# piece there), then assembles the window's 8-byte word pairs from shared
# memory into an output sub-tile of ``out_rows`` rows, which it stores. The
# tile plan below chooses R, the windows and the sub-tile; it is plain
# Python so the CPU tests reach it. Its sizes mirror the source's.

SMEM_PER_BLOCK = 232_448     # shared memory one H100 block may use (227 KB)
STAGES = 2                   # staged tiles a block holds (csrc kStages)
# the budgets were chosen with chip_rowconv_sweep.py on an H100 (PERF.md)
STAGE_BUDGET = 32 * 1024     # staged bytes of one tile
OUT_BUDGET = 32 * 1024       # the output sub-tile of a block
TILE_ROWS_MAX = 1024
TILE_ROWS_WIDE = 256         # R once the row is split into windows
SLOT_PAD = 16                # a staged slice starts at its source's % 16
PART_U64 = 6                 # kernel-only part: an 8-byte element whole


@dataclass(frozen=True)
class RowWindow:
    """Words [word0, word1) of every row (both even), and the slices staged
    for them: (column, True for its validity) in stage order."""

    word0: int
    word1: int
    slots: Tuple[Tuple[int, bool], ...]
    stage_bytes: int


@dataclass(frozen=True)
class TilePlan:
    rows: int                        # R, a multiple of 32
    windows: Tuple[RowWindow, ...]   # cover [0, nwords) in order
    stage_budget: int                # each window's stage_bytes fits it
    out_rows: int                    # sub-tile rows, a multiple of 32

    @property
    def out_bytes(self) -> int:
        """The sub-tile's shared memory: out_rows rows of the widest
        window's pairs, padded to an odd count."""
        return self.out_rows * 8 * max(((w.word1 - w.word0) // 2) | 1
                                       for w in self.windows)


def _table_bytes(npairs: int, nwin: int, npieces: int) -> int:
    """Shared memory of the kernel's tables (csrc/rowconv.cu table_bytes):
    windows int4, pair constants u64, pair starts and pieces u32."""
    return _round16(16 * nwin + 8 * npairs + 4 * (npairs + 1) + 4 * npieces)


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def _stage_bytes(rows: int, slots, elem_sizes: Sequence[int]) -> int:
    return sum(rows * (1 if v else elem_sizes[c]) + SLOT_PAD
               for c, v in slots)


def rowconv_tile_plan(plan: Sequence[Tuple[int, int, int, int]],
                      elem_sizes: Sequence[int], has_valid: Sequence[bool],
                      nwords: int,
                      stage_budget: Optional[int] = None) -> TilePlan:
    """R and the word windows of B3 for a plan of (word, column, part,
    shift) pieces over columns of ``elem_sizes`` bytes, ``has_valid[c]``
    saying whether column c has a validity array (a piece of a column
    without one is a constant bit, and stages nothing). The stage budget is
    STAGE_BUDGET unless given.

    R is the largest multiple of 32 up to TILE_ROWS_MAX at which the whole
    row's slices fit the stage budget; a row that does not fit at
    TILE_ROWS_WIDE rows is split into windows of even words, greedily, each
    within the budget and narrow enough that 32 rows of it fit OUT_BUDGET.
    The output sub-tiles split R into equal parts (multiples of 32) that
    fit OUT_BUDGET; a sub-tile row holds its window's pairs padded to an
    odd count."""
    if nwords <= 0 or nwords % 2:
        raise ValueError("JCUDF rows are 8-byte aligned: nwords must be even")
    npairs = nwords // 2
    need: List[Dict[Tuple[int, bool], None]] = [{} for _ in range(npairs)]
    for word, c, part, _ in plan:
        valid = part == PART_VALID
        if not valid or has_valid[c]:
            need[word // 2][(c, valid)] = None
    tables = _table_bytes(npairs, npairs, len(plan))
    budget = min(STAGE_BUDGET if stage_budget is None else stage_budget,
                 (SMEM_PER_BLOCK - tables - OUT_BUDGET) // STAGES // 16 * 16)
    whole = dict.fromkeys(s for pair in need for s in pair)
    rows = next((r for r in range(TILE_ROWS_MAX, TILE_ROWS_WIDE - 1, -32)
                 if _stage_bytes(r, whole, elem_sizes) <= budget),
                TILE_ROWS_WIDE)
    while rows > 32 and any(_stage_bytes(rows, pair, elem_sizes) > budget
                            for pair in need):
        rows -= 32
    if rows * npairs >= 1 << 31:
        raise ValueError(f"rows of {nwords} words are too wide for B3")
    max_pairs = OUT_BUDGET // (32 * 8) - 1
    windows: List[RowWindow] = []
    p0, cur = 0, {}
    for p, pair in enumerate(need):
        grown = {**cur, **pair}
        if p > p0 and (p - p0 == max_pairs or _stage_bytes(
                rows, grown, elem_sizes) > budget):
            windows.append(RowWindow(2 * p0, 2 * p, tuple(cur),
                                     _stage_bytes(rows, cur, elem_sizes)))
            p0, grown = p, dict(pair)
        cur = grown
    windows.append(RowWindow(2 * p0, nwords, tuple(cur),
                             _stage_bytes(rows, cur, elem_sizes)))
    for w in windows:
        if w.stage_bytes > budget:
            raise ValueError(f"B3: words [{w.word0}, {w.word1}) stage "
                             f"{w.stage_bytes} bytes, over the "
                             f"{budget}-byte budget")
    widest = max(((w.word1 - w.word0) // 2) | 1 for w in windows)
    most = min(rows, OUT_BUDGET // (8 * widest) // 32 * 32)
    subtiles = -(-rows // most)  # equal sub-tiles, not a short last one
    out_rows = -(-rows // subtiles // 32) * 32
    return TilePlan(rows, tuple(windows), budget, out_rows)


def _u64_as_i64(x: int) -> int:
    return x - (1 << 64) if x >> 63 else x


@dataclass(frozen=True)
class RowconvLayout:
    """The kernel's metadata but for the slot pointers, for one schema."""

    tiles: TilePlan
    slots: Tuple[Tuple[int, bool], ...]  # (column, validity?) per slot
    tail: Tuple[int, ...]                # the sections after the pointers
    nwin: int
    npairs: int
    npieces: int
    stage_bytes: int


@functools.lru_cache(maxsize=64)
def rowconv_layout(plan: Tuple[Tuple[int, int, int, int], ...],
                   elem_sizes: Tuple[int, ...], has_valid: Tuple[bool, ...],
                   residues: Tuple[Tuple[int, int], ...], nwords: int,
                   stage_budget: Optional[int] = None) -> RowconvLayout:
    """B3's metadata for a plan over columns of ``elem_sizes`` bytes whose
    data and validity pointers are ``residues`` (each % 16), but for the
    pointers themselves. The whole metadata, one int64 list, is

      slot pointers (nslots) | slot info: stage offset | bytes << 32 |
      windows: pair0 | pair1 << 32, slot0 | slot1 << 32 (2 each) |
      pair constants, u64 bits (npairs) | pair starts (npairs + 1) |
      pieces: offset | part << 18 | shift << 21 (npieces)

    Pieces work on 8-byte word pairs: a piece is the element (or validity
    byte) at stage offset + row * bytes, shifted left 0-63 bits. The low and
    high words of one 8-byte element make one U64 piece; a validity bit of a
    column without validity is a constant bit of its pair. Raises
    ValueError for a piece that does not fit the columns."""
    for word, c, part, shift in plan:  # the kernel reads what the plan says
        if not (0 <= word < nwords and 0 <= c < len(elem_sizes)
                and 0 <= shift < 32
                and (part == PART_VALID
                     or elem_sizes[c] == _PART_BYTES.get(part))):
            raise ValueError(f"rowconv piece {(word, c, part, shift)} does "
                             f"not fit the columns")
    tiles = rowconv_tile_plan(plan, elem_sizes, has_valid, nwords,
                              stage_budget)
    npairs = nwords // 2
    by_pair: List[List[Tuple[int, int, int]]] = [[] for _ in range(npairs)]
    for word, c, part, shift in plan:
        by_pair[word // 2].append((c, part, shift + 32 * (word & 1)))
    slots: List[Tuple[int, bool]] = []
    info: List[int] = []
    win: List[int] = []
    consts = [0] * npairs
    first = [0] * (npairs + 1)
    pieces: List[int] = []
    for w in tiles.windows:
        s0, off, where = len(slots), 0, {}
        for c, valid in w.slots:
            nbytes = 1 if valid else elem_sizes[c]
            slots.append((c, valid))
            info.append(off | nbytes << 32)
            where[(c, valid)] = off + residues[c][valid]
            off += tiles.rows * nbytes + SLOT_PAD
        win += [w.word0 // 2 | (w.word1 // 2) << 32, s0 | len(slots) << 32]
        for p in range(w.word0 // 2, w.word1 // 2):
            whole = ({c for c, part, sh in by_pair[p]
                      if part == PART_LO and sh == 0}
                     & {c for c, part, sh in by_pair[p]
                        if part == PART_HI and sh == 32})
            for c, part, sh in by_pair[p]:
                valid = part == PART_VALID
                if valid and not has_valid[c]:
                    consts[p] |= 1 << sh
                    continue
                if c in whole and part in (PART_LO, PART_HI):
                    if part == PART_HI:
                        continue
                    part = PART_U64
                pieces.append(where[(c, valid)] | part << 18 | sh << 21)
            first[p + 1] = len(pieces)
    tail = (info + win + [_u64_as_i64(x) for x in consts] + first + pieces)
    return RowconvLayout(tiles, tuple(slots), tuple(tail), len(tiles.windows),
                         npairs, len(pieces),
                         max(w.stage_bytes for w in tiles.windows))


def rowconv_meta(cols, valids, plan, nwords: int,
                 stage_budget: Optional[int] = None):
    """(metadata as one int64 list, its layout) for these columns."""
    lay = rowconv_layout(
        tuple(map(tuple, plan)), tuple(t.element_size() for t in cols),
        tuple(v is not None for v in valids),
        tuple((t.data_ptr() % 16, 0 if v is None else v.data_ptr() % 16)
              for t, v in zip(cols, valids)), nwords, stage_budget)
    ptrs = [(valids[c] if valid else cols[c]).data_ptr()
            for c, valid in lay.slots]
    return ptrs + list(lay.tail), lay


def rowconv_fixed_words(cols: Sequence[torch.Tensor],
                        valids: Sequence[Optional[torch.Tensor]],
                        plan: Sequence[Tuple[int, int, int, int]],
                        nwords: int, n: int) -> torch.Tensor:
    """B3: int32[n, nwords] JCUDF fixed-width + validity words of n rows.

    ``cols``: each column's values (1-D, n rows), read in place;
    ``valids``: each column's bool[n] validity or None; ``plan``: the
    (word, column, part, shift) pieces, ordered by word."""
    if n == 0 or nwords == 0:
        return rowconv_fixed_words_plain(cols, valids, plan, nwords, n)
    dev = _where(list(cols) + list(valids))
    if dev.type == "cpu":
        return rowconv_fixed_words_plain(cols, valids, plan, nwords, n)
    if nwords % 2:
        raise ValueError("JCUDF rows are 8-byte aligned: nwords must be even")
    cols = [c.contiguous() for c in cols]
    valids = [None if v is None else v.contiguous() for v in valids]
    for c, (t, v) in enumerate(zip(cols, valids)):
        if t.shape != (n,) or (v is not None and (v.dtype != torch.bool
                                                  or v.shape != (n,))):
            raise ValueError(f"rowconv column {c}: expected {n} rows and a "
                             f"bool validity")
        if t.data_ptr() % t.element_size():
            raise ValueError(f"rowconv column {c}: data not aligned to its "
                             f"element size")
    lib = _lib("rowconv")
    meta, lay = rowconv_meta(cols, valids, plan, nwords)
    # pinned host buffer, copied in stream order: the host does not wait
    host = torch.tensor(meta, dtype=torch.int64).pin_memory()
    dmeta = host.to(dev, non_blocking=True)
    out = torch.empty((n, nwords), dtype=torch.int32, device=dev)
    err = lib.srjt_rowconv_rows(dmeta.data_ptr(), len(lay.slots), lay.nwin,
                                lay.npairs, lay.npieces, lay.tiles.rows,
                                lay.stage_bytes, lay.tiles.out_rows,
                                lay.tiles.out_bytes, n, out.data_ptr(),
                                _stream(dev))
    _check(lib, err, "rowconv")
    _count_launch(rowconv_fixed_words)
    return out


# ---------------------------------------------------------------------------
# H1: ordered segment float aggregate
# ---------------------------------------------------------------------------
# Float64 values are handled as their int64 bits wherever a flush, a NaN
# test or a NaN payload is involved: the tests are on the exponent field,
# as the kernel's are, whatever the backend's own denormal mode.

_SIGN = -(1 << 63)
_ABS = (1 << 63) - 1
_EXP = 0x7FF0000000000000
_QUIET = 0x0008000000000000
_DEFAULT_NAN = -0x0008000000000000       # 0xFFF8000000000000, x86's
_POS_INF = 0x7FF0000000000000
_NEG_INF = -0x0010000000000000           # 0xFFF0000000000000
_MIN_NORMAL = 2.0 ** -1022
_PLAIN_BLOCK = 1 << 22   # values one gather of the plain ordered sum holds


def _flush_bits(b: torch.Tensor) -> torch.Tensor:
    """DAZ/FTZ on f64 bits: a zero exponent field leaves the sign only."""
    return torch.where((b & _EXP) == 0, b & _SIGN, b)


def _nan_bits(b: torch.Tensor) -> torch.Tensor:
    return (b & _ABS) > _EXP


def _order_key(b: torch.Tensor) -> torch.Tensor:
    """Total-order int64 image of non-NaN f64 bits (-0.0 < +0.0); its own
    inverse."""
    return b ^ ((b >> 63) & _ABS)


def _ordered_sums(xb: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """int64 bits of each segment's sequential sum of the flushed bits
    ``xb``: positions are stepped one at a time, every segment still inside
    its rows doing one IEEE add and one flush of the result. A NaN sum
    takes x86's bits at the end: the last NaN input of the segment,
    quieted, or the default NaN where inf + -inf made it."""
    dev = xb.device
    G = starts.shape[0] - 1
    if xb.shape[0] == 0:
        return torch.zeros(G, dtype=torch.int64, device=dev)
    lo = starts[:-1]
    lens = starts[1:] - lo
    lens_h = lens.cpu()
    by_len = torch.argsort(lens_h, descending=True, stable=True)
    lens_desc = lens_h.index_select(0, by_len).tolist()
    by_len = by_len.to(dev)
    lo_s = lo.index_select(0, by_len)
    x = xb.view(torch.float64)
    acc = torch.zeros(G, dtype=torch.float64, device=dev)
    steps = lens_desc[0] if lens_desc else 0
    active, j0 = G, 0
    while j0 < steps:
        while active and lens_desc[active - 1] <= j0:
            active -= 1
        # the next positions of every active segment in one gather of at
        # most _PLAIN_BLOCK values (positions past a segment's end are
        # never read below)
        block = max(1, min(256, _PLAIN_BLOCK // active))
        cols = torch.arange(j0, j0 + block, device=dev)
        m = x[(lo_s[:active, None] + cols).clamp(max=x.shape[0] - 1)]
        a_j = active
        for j in range(j0, min(j0 + block, steps)):
            while a_j and lens_desc[a_j - 1] <= j:
                a_j -= 1
            s = acc[:a_j] + m[:a_j, j - j0]
            acc[:a_j] = torch.where(s.abs() < _MIN_NORMAL, s * 0.0, s)
        j0 += block
    bits = torch.empty(G, dtype=torch.int64, device=dev)
    bits[by_len] = acc.view(torch.int64)
    seg = torch.repeat_interleave(torch.arange(G, device=dev), lens,
                                  output_size=xb.shape[0])
    has_nan, _, last_nan = _first_last(seg, _nan_bits(xb), G)
    return torch.where(has_nan, xb[last_nan] | _QUIET,
                       torch.where(_nan_bits(bits), _DEFAULT_NAN, bits))


def _first_last(seg: torch.Tensor, hit: torch.Tensor, G: int):
    """(has bool[G], first int64[G], last int64[G]): the first and last row
    of each segment where ``hit``."""
    n = seg.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=seg.device)
    first = torch.full((G,), n, dtype=torch.int64, device=seg.device)
    first.scatter_reduce_(0, seg, torch.where(hit, rows, n), "amin")
    last = torch.full((G,), -1, dtype=torch.int64, device=seg.device)
    last.scatter_reduce_(0, seg, torch.where(hit, rows, -1), "amax")
    return last >= 0, first.clamp(max=max(n - 1, 0)), last.clamp(min=0)


def float_minmax_scatter(xb: torch.Tensor, valid: torch.Tensor,
                         seg: torch.Tensor, G: int):
    """(min, max) float64[G] of H1's contract for flushed f64 bits ``xb``
    whose segment ids ``seg`` may come in any order, rows in table order:
    scatter reductions of a total-order image over the valid non-NaN rows,
    and the NaN rule (min: the first positive NaN, else the last negative
    one; max: the first negative NaN, else the last positive one)."""
    dev = xb.device
    if xb.shape[0] == 0:
        return (torch.full((G,), _POS_INF, dtype=torch.int64,
                           device=dev).view(torch.float64),
                torch.full((G,), _NEG_INF, dtype=torch.int64,
                           device=dev).view(torch.float64))
    nan = valid & _nan_bits(xb)
    num = valid & ~nan
    key = _order_key(xb)
    kmin = torch.full((G,), _ABS, dtype=torch.int64, device=dev)
    kmin.scatter_reduce_(0, seg, torch.where(num, key, _ABS), "amin")
    kmax = torch.full((G,), _SIGN, dtype=torch.int64, device=dev)
    kmax.scatter_reduce_(0, seg, torch.where(num, key, _SIGN), "amax")
    anyv = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(
        0, seg, num.to(torch.int64)) > 0
    has_p, first_p, last_p = _first_last(seg, nan & (xb >= 0), G)
    has_n, first_n, last_n = _first_last(seg, nan & (xb < 0), G)

    def pick(has_a, a, has_b, b, k, empty):
        base = torch.where(anyv, _order_key(k), empty)
        return torch.where(has_a, xb.index_select(0, a), torch.where(
            has_b, xb.index_select(0, b), base)).view(torch.float64)

    return (pick(has_p, first_p, has_n, last_n, kmin, _POS_INF),
            pick(has_n, first_n, has_p, last_p, kmax, _NEG_INF))


def segment_float_agg_plain(z: torch.Tensor, valid: torch.Tensor,
                            starts: torch.Tensor):
    """Plain PyTorch version of H1: (sum, min, max) float64[G] of the
    segments [starts[g], starts[g+1]) of the sorted values ``z`` (float64)
    where ``valid``. The sum steps over positions (``_ordered_sums``); min
    and max are ``float_minmax_scatter``."""
    G = starts.shape[0] - 1
    xb = torch.where(valid, _flush_bits(z.view(torch.int64)), 0)
    seg = torch.repeat_interleave(
        torch.arange(G, device=z.device), starts[1:] - starts[:-1],
        output_size=z.shape[0])
    mins, maxs = float_minmax_scatter(xb, valid, seg, G)
    return _ordered_sums(xb, starts).view(torch.float64), mins, maxs


H1_CHUNK_ROWS = 256      # csrc kChunk: rows of one ring slot
H1_TINY = 2.0 ** -969    # csrc kTinyHi: below it a nonzero input is tiny
_TINY_BITS = (1023 - 969) << 52


def flushed_chunks_plain(z: torch.Tensor, valid: torch.Tensor,
                         starts: torch.Tensor) -> int:
    """How many chunks H1 folds with the flush after every add: the chunks
    of H1_CHUNK_ROWS rows from each segment's start that hold a valid
    input whose flushed value is nonzero and below H1_TINY in magnitude.
    Every other chunk folds with plain adds (csrc/segment_agg.cu says why
    both give the same bits)."""
    n = z.shape[0]
    xb = torch.where(valid, _flush_bits(z.view(torch.int64)), 0) & _ABS
    tiny = (xb != 0) & (xb < _TINY_BITS)
    seg = torch.repeat_interleave(
        torch.arange(starts.shape[0] - 1, device=z.device),
        starts[1:] - starts[:-1], output_size=n)
    lo = starts[:-1].index_select(0, seg)
    rows = torch.arange(n, device=z.device)
    first = lo + (rows - lo) // H1_CHUNK_ROWS * H1_CHUNK_ROWS
    return int(torch.unique(first[tiny]).numel())


def segment_float_agg(z: torch.Tensor, valid: torch.Tensor,
                      starts: torch.Tensor,
                      flushed: Optional[torch.Tensor] = None):
    """H1: (sum, min, max) float64[G] of the sorted segments
    [starts[g], starts[g+1]) of ``z`` (float64[n]) over the rows where
    ``valid`` (bool[n]); ``starts`` int64[G+1] from 0 to n. The sum is the
    sequential, flushed sum of XLA:CPU's segment_sum (masked rows add
    +0.0); min and max give XLA:CPU's bits, NaN payloads included.
    ``flushed``, an int64[1] tensor beside the inputs or None (the main
    path), gains the count of chunks folded on the flushed path (on the
    CPU: ``flushed_chunks_plain``'s)."""
    G = starts.shape[0] - 1
    if (z.dtype != torch.float64 or valid.dtype != torch.bool
            or starts.dtype != torch.int64 or z.dim() != 1
            or valid.shape != z.shape or starts.dim() != 1 or G < 0):
        raise ValueError("segment_float_agg takes float64[n] values, "
                         "bool[n] valid and int64[G+1] starts")
    if flushed is not None and (flushed.dtype != torch.int64
                                or flushed.shape != (1,)):
        raise ValueError("segment_float_agg counts into an int64[1] tensor")
    dev = _where([z, valid, starts, flushed])
    if dev.type == "cpu" or G == 0 or z.shape[0] == 0:
        if flushed is not None:
            flushed += flushed_chunks_plain(z, valid, starts)
        return segment_float_agg_plain(z, valid, starts)
    z, valid, starts = z.contiguous(), valid.contiguous(), \
        starts.contiguous()
    lib = _lib("segment_agg")
    out = torch.empty((3, G), dtype=torch.float64, device=dev)
    err = lib.srjt_segment_float_agg(
        z.data_ptr(), valid.data_ptr(), starts.data_ptr(), G,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        None if flushed is None else flushed.data_ptr(), _stream(dev))
    _check(lib, err, "segment_float_agg")
    _count_launch(segment_float_agg)
    return out[0], out[1], out[2]


def dadd_chain_ms(n: int, device: torch.device) -> float:
    """Device milliseconds of one thread's chain of ``n`` dependent f64
    adds (the latency that bounds H1's longest segment), by CUDA events."""
    lib = _lib("segment_agg")
    x = torch.tensor([1.0, 1e-3], dtype=torch.float64, device=device)
    out = torch.empty(1, dtype=torch.float64, device=device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _check(lib, lib.srjt_dadd_chain(x.data_ptr(), 1000, out.data_ptr(),
                                    _stream(device)), "dadd_chain")
    start.record()
    _check(lib, lib.srjt_dadd_chain(x.data_ptr(), n, out.data_ptr(),
                                    _stream(device)), "dadd_chain")
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


# ---------------------------------------------------------------------------
# H2: DECIMAL128 arithmetic
# ---------------------------------------------------------------------------

def _dec_rows(t: torch.Tensor, n: int, which: str) -> int:
    """Row stride (in rows) of an int32[n, 4] limb operand: 1, or 0 for
    one row expanded to n (a literal)."""
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape != (n, 4) \
            or t.stride(1) != 1 or t.stride(0) not in (0, 4) \
            or t.data_ptr() % 16:
        raise ValueError(f"decimal128 operand {which}: expected int32[{n}, "
                         f"4] limbs on 16 bytes, rows contiguous or a "
                         f"stride-0 row")
    return t.stride(0) // 4


def decimal128_op(op: str, a: torch.Tensor, b: torch.Tensor, a_c: int,
                  b_c: int, out_c: int, cast_interim_result: bool = True):
    """H2: Spark's DECIMAL128 ``op`` (ops/decimal128.OPS) over int32[n, 4]
    limbs ``a`` and ``b`` (either may be one row expanded to n) at cudf
    scales ``a_c``, ``b_c`` -> ``out_c``: (overflow bool[n], result
    int32[n, 4], or int64[n] for integer_divide). The plain version is
    ``ops/decimal128.op_plain``; it raises ValueError where a power of
    ten passes 10^76, and so does this wrapper (before the launch where
    the scales decide it; after it, from the kernel's flag, where only a
    row's value can)."""
    from . import decimal128 as D
    if op not in D.OPS:
        raise ValueError(f"unknown decimal op {op!r}")
    n = a.shape[0]
    if b.shape[0] != n:
        raise ValueError("decimal128 operands differ in rows")
    dev = _where([a, b])
    if dev.type == "cpu":
        return D.op_plain(op, a, b, a_c, b_c, out_c, cast_interim_result)
    sa, sb = _dec_rows(a, n, "a"), _dec_rows(b, n, "b")
    may_flag = D.host_checks(op, a_c, b_c, out_c, n, cast_interim_result)
    int_div = op == "integer_divide"
    out = torch.empty((n,) if int_div else (n, 4),
                      dtype=torch.int64 if int_div else torch.int32,
                      device=dev)
    over = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return over, out
    err = torch.zeros(1, dtype=torch.int32, device=dev) if may_flag \
        else None
    lib = _lib("decimal128")
    _check(lib, lib.srjt_decimal128_op(
        D.OPS[op], a.data_ptr(), sa, b.data_ptr(), sb, n, a_c, b_c, out_c,
        int(cast_interim_result), out.data_ptr(), over.data_ptr(),
        None if err is None else err.data_ptr(), _stream(dev)),
        "decimal128")
    _count_launch(decimal128_op)
    if err is not None and int(err.item()):  # a host read only here
        raise ValueError("pow10 exponent out of supported range [0, 76]")
    return over, out


murmur3_fixed_rows.launches = 0
xxhash64_fixed_rows.launches = 0
rowconv_fixed_words.launches = 0
segment_float_agg.launches = 0
decimal128_op.launches = 0


KERNELS: List[Tuple[str, str, str, str]] = [
    # (name, wrapper, source, TPU kernel it replaces)
    ("B1 murmur3_fixed_rows", "murmur3_fixed_rows",
     "spark_rapids_jni_tpu_torch/csrc/row_hash.cu",
     "spark_rapids_jni_tpu/ops/pallas_kernels.py:37"),
    ("B2 xxhash64_fixed_rows", "xxhash64_fixed_rows",
     "spark_rapids_jni_tpu_torch/csrc/row_hash.cu",
     "spark_rapids_jni_tpu/ops/pallas_kernels.py:210"),
    ("B3 rowconv_fixed_words", "rowconv_fixed_words",
     "spark_rapids_jni_tpu_torch/csrc/rowconv.cu",
     "spark_rapids_jni_tpu/ops/pallas_kernels.py:414"),
    # no Pallas kernel: XLA's segment_sum/min/max in _segment_agg_fixed
    ("H1 segment_float_agg", "segment_float_agg",
     "spark_rapids_jni_tpu_torch/csrc/segment_agg.cu",
     "spark_rapids_jni_tpu/ops/groupby.py:201"),
    # no Pallas kernel: XLA's 256-bit limb math (ops/int256.py, its
    # bit-serial divmod_unsigned) under ops/decimal128.py
    ("H2 decimal128_op", "decimal128_op",
     "spark_rapids_jni_tpu_torch/csrc/decimal128.cu",
     "spark_rapids_jni_tpu/ops/decimal128.py:90"),
]
