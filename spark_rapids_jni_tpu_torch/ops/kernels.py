"""The CUDA kernels of this port: wrappers, plain versions, launch counts.

Each kernel replaces one Pallas kernel of the JAX package's
ops/pallas_kernels.py:

  B1 ``murmur3_fixed_rows``  csrc/row_hash.cu   build_murmur3_fixed_kernel
  B2 ``xxhash64_fixed_rows`` csrc/row_hash.cu   build_xxhash64_fixed_kernel
  B3 ``rowconv_fixed_words`` csrc/rowconv.cu    build_rowconv_fixed_kernel

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

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("row_hash", "rowconv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_VP = ctypes.c_void_p
_SIGNATURES = {
    # (schema pointers, kinds, validity pointers, ncols, n, seed, out, stream)
    "srjt_murmur3_rows": [_VP, _VP, _VP, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_uint, _VP, _VP],
    "srjt_xxhash64_rows": [_VP, _VP, _VP, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_ulonglong, _VP, _VP],
    # (device metadata, nslots, nwin, npairs, npieces, rows per tile,
    #  stage bytes, sub-tile rows, sub-tile bytes, n, out, stream)
    "srjt_rowconv_rows": [_VP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _VP,
                          _VP],
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


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            lib.srjt_error_string.argtypes = [ctypes.c_int]
            lib.srjt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
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


def _schema_device(schema) -> torch.device:
    return _where([t for _, w, v in schema for t in (w, v)])


def reset_launches() -> None:
    for fn in (murmur3_fixed_rows, xxhash64_fixed_rows, rowconv_fixed_words):
        fn.launches = 0


# ---------------------------------------------------------------------------
# B1 / B2: fixed-width row hashes
# ---------------------------------------------------------------------------
# A hash schema is a list of (kind, words, validity): kind "u32" with int32
# words or "u64" with int64 words (the bits _fixed_element_words made), and
# a bool[n] validity or None.

MAX_HASH_COLUMNS = 64  # csrc/row_hash.cu: the schema rides in the params


def _hash_args(schema, n: int):
    if len(schema) > MAX_HASH_COLUMNS:
        raise ValueError(f"row hash over {len(schema)} columns; the kernel "
                         f"takes at most {MAX_HASH_COLUMNS}")
    keep = []
    ptrs = (ctypes.c_void_p * len(schema))()
    kinds = (ctypes.c_int * len(schema))()
    valid = (ctypes.c_void_p * len(schema))()
    for i, (kind, words, v) in enumerate(schema):
        want = torch.int32 if kind == "u32" else torch.int64
        if words.dtype != want or words.shape != (n,):
            raise ValueError(f"hash column {i}: {kind} words must be "
                             f"{want}[{n}], got {words.dtype}"
                             f"{list(words.shape)}")
        words = words.contiguous()
        keep.append(words)
        ptrs[i] = words.data_ptr()
        kinds[i] = 0 if kind == "u32" else 1
        if v is not None:
            if v.dtype != torch.bool or v.shape != (n,):
                raise ValueError(f"hash column {i}: validity must be "
                                 f"bool[{n}]")
            v = v.contiguous()
            keep.append(v)
            valid[i] = v.data_ptr()
    return keep, ptrs, kinds, valid


def murmur3_fixed_rows_plain(schema, seed: int, n: int) -> torch.Tensor:
    """Plain PyTorch version of B1: int32[n] Spark murmur3 row hashes."""
    from . import hashing as H
    dev = _schema_device(schema) if schema else torch.device("cpu")
    h = torch.full((n,), seed & 0xFFFFFFFF, dtype=torch.int64, device=dev)
    for kind, words, v in schema:
        w = words.to(torch.int64)
        nh = H._mm_u32(h, w & 0xFFFFFFFF) if kind == "u32" \
            else H._mm_u64(h, w)
        h = nh if v is None else torch.where(v, nh, h)
    return h.to(torch.int32)


def murmur3_fixed_rows(schema, seed: int, n: int) -> torch.Tensor:
    """B1: int32[n] Spark murmur3_32 row hashes of a fixed-width schema
    (seed chained across columns, null rows pass the running hash)."""
    if n == 0 or not schema:
        return murmur3_fixed_rows_plain(schema, seed, n)
    dev = _schema_device(schema)
    if dev.type == "cpu":
        return murmur3_fixed_rows_plain(schema, seed, n)
    lib = _lib("row_hash")
    keep, ptrs, kinds, valid = _hash_args(schema, n)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    err = lib.srjt_murmur3_rows(ctypes.addressof(ptrs), ctypes.addressof(kinds),
                                ctypes.addressof(valid), len(schema), n,
                                seed & 0xFFFFFFFF, out.data_ptr(),
                                _stream(dev))
    _check(lib, err, "murmur3")
    murmur3_fixed_rows.launches += 1
    return out


def xxhash64_fixed_rows_plain(schema, seed: int, n: int) -> torch.Tensor:
    """Plain PyTorch version of B2: int64[n] (u64 bits) Spark xxhash64
    row hashes."""
    from . import hashing as H
    dev = _schema_device(schema) if schema else torch.device("cpu")
    h = torch.full((n,), H._s64(seed), dtype=torch.int64, device=dev)
    for kind, words, v in schema:
        w = words.to(torch.int64)
        nh = H._xx_u32(h, w & 0xFFFFFFFF) if kind == "u32" \
            else H._xx_u64(h, w)
        h = nh if v is None else torch.where(v, nh, h)
    return h


def xxhash64_fixed_rows(schema, seed: int, n: int) -> torch.Tensor:
    """B2: int64[n] (u64 bits) Spark xxhash64 row hashes of a fixed-width
    schema, chained like B1."""
    if n == 0 or not schema:
        return xxhash64_fixed_rows_plain(schema, seed, n)
    dev = _schema_device(schema)
    if dev.type == "cpu":
        return xxhash64_fixed_rows_plain(schema, seed, n)
    lib = _lib("row_hash")
    keep, ptrs, kinds, valid = _hash_args(schema, n)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    err = lib.srjt_xxhash64_rows(ctypes.addressof(ptrs),
                                 ctypes.addressof(kinds),
                                 ctypes.addressof(valid), len(schema), n,
                                 seed & 0xFFFFFFFFFFFFFFFF, out.data_ptr(),
                                 _stream(dev))
    _check(lib, err, "xxhash64")
    xxhash64_fixed_rows.launches += 1
    return out


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
    rowconv_fixed_words.launches += 1
    return out


murmur3_fixed_rows.launches = 0
xxhash64_fixed_rows.launches = 0
rowconv_fixed_words.launches = 0


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
]
