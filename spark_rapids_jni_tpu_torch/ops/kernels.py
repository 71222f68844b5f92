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
import hashlib
import os
import shutil
import subprocess
import threading
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
    # (device metadata, ncols, nwords, n, out, stream)
    "srjt_rowconv_rows": [_VP, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          _VP, _VP],
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


def _rowconv_meta(cols, valids, plan, nwords: int, dev):
    """Kernel metadata in one int64 device tensor:
    [data pointers (ncols) | validity pointers (ncols) |
     word_first (nwords + 1) | pieces (column | part << 16 | shift << 20)]."""
    ncols = len(cols)
    first = [0] * (nwords + 1)
    for word, _, _, _ in plan:
        first[word + 1] += 1
    for w in range(nwords):
        first[w + 1] += first[w]
    pieces = [c | (part << 16) | (shift << 20) for _, c, part, shift in plan]
    meta = ([t.data_ptr() for t in cols]
            + [0 if v is None else v.data_ptr() for v in valids]
            + first + pieces)
    return torch.tensor(meta, dtype=torch.int64).to(dev)


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
    for word, c, part, shift in plan:  # the kernel reads what the plan says
        if not (0 <= word < nwords and 0 <= c < len(cols) and 0 <= shift < 32
                and (part == PART_VALID
                     or cols[c].element_size() == _PART_BYTES[part])):
            raise ValueError(f"rowconv piece {(word, c, part, shift)} does "
                             f"not fit the columns")
    lib = _lib("rowconv")
    meta = _rowconv_meta(cols, valids, plan, nwords, dev)
    out = torch.empty((n, nwords), dtype=torch.int32, device=dev)
    err = lib.srjt_rowconv_rows(meta.data_ptr(), len(cols), nwords, n,
                                out.data_ptr(), _stream(dev))
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
