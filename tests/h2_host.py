"""Kernel H2's source (csrc/decimal128.cu) built for the host with g++: the
same per-row arithmetic as the card's kernel, callable from the CPU tests.

The source compiles without ``__CUDACC__`` to a plain C++ library with
host entry points: the six ops row by row (``op``), the unsigned division
(``divmod``), the reciprocals (``reciprocals``) and the counts of the
division's branches (``take_counts``, names in ``COUNTS``). It is built at
first use into ``build/h2_host/`` at the root of the checkout, under a
name that holds a hash of the source.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "spark_rapids_jni_tpu_torch" / "csrc" / "decimal128.cu"
# enum Count of the source, in order (kPairs + 4 * words(n) + words(d) - 1
# follow)
COUNTS = ("zero_divisor", "bit_serial", "short_hw", "fewer_words",
          "fix_2by1_over", "fix_2by1_under", "fix_3by2_over",
          "fix_3by2_under", "top_equal", "add_back", "recip_3by2_a",
          "recip_3by2_b", "recip_3by2_c", "pow10_division")
_lib = {}


def library():
    """The host build of H2's source."""
    if _lib:
        return _lib["lib"]
    flags = ["-x", "c++", "-std=c++17", "-O1", "-fPIC", "-shared"]
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    out = ROOT / "build" / "h2_host" / f"libh2host-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *flags, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.srjt_decimal128_op_host.argtypes = [i, vp, ll, vp, ll, ll, i, i, i,
                                            i, vp, vp, vp]
    lib.srjt_decimal128_op_host.restype = i
    lib.srjt_h2_divmod_host.argtypes = [vp, vp, ll, vp, vp]
    lib.srjt_h2_reciprocals_host.argtypes = [vp, ll, vp, vp]
    lib.srjt_h2_take_counts.argtypes = [vp]
    lib.srjt_h2_take_counts.restype = i
    _lib["lib"] = lib
    return lib


def op(name, a, b, a_c, b_c, out_c, cast=True):
    """H2's ``name`` (ops/decimal128.OPS) on int32[n, 4] CPU limbs at cudf
    scales, row by row on the host: (overflow bool[n], result int32[n, 4]
    or int64[n], whether a power of ten past 10^76 was asked for)."""
    from spark_rapids_jni_tpu_torch.ops.decimal128 import OPS
    n = a.shape[0]
    sa, sb = a.stride(0) // 4, b.stride(0) // 4
    a, b = a.as_strided((max(n, 1), 4), (4 * sa, 1)), b.as_strided(
        (max(n, 1), 4), (4 * sb, 1))
    int_div = name == "integer_divide"
    out = torch.empty((n,) if int_div else (n, 4),
                      dtype=torch.int64 if int_div else torch.int32)
    over = torch.empty(n, dtype=torch.bool)
    err = torch.zeros(1, dtype=torch.int32)
    rc = library().srjt_decimal128_op_host(
        OPS[name], a.data_ptr(), sa, b.data_ptr(), sb, n, a_c, b_c, out_c,
        int(cast), out.data_ptr(), over.data_ptr(), err.data_ptr())
    assert rc == 0
    return over, out, bool(err.item())


def _words(values):
    return np.array([[(v >> (64 * k)) & (2**64 - 1) for k in range(4)]
                     for v in values], dtype=np.uint64).reshape(-1, 4)


def _ints(words):
    return [sum(int(w) << (64 * k) for k, w in enumerate(row))
            for row in words]


def divmod(n, d):
    """divmod_u of unsigned 256-bit n by d over lists of Python ints:
    (quotients, remainders)."""
    nw, dw = _words(n), _words(d)
    q, r = np.zeros_like(nw), np.zeros_like(nw)
    library().srjt_h2_divmod_host(nw.ctypes.data, dw.ctypes.data, len(n),
                                  q.ctypes.data, r.ctypes.data)
    return _ints(q), _ints(r)


def reciprocals(pairs):
    """(2-by-1 reciprocal of d1, 3-by-2 reciprocal of (d1, d0)) for each
    normalised pair (d1, d0) of a list."""
    d = np.array(pairs, dtype=np.uint64).reshape(-1, 2)
    v2, v3 = np.zeros(len(pairs), np.uint64), np.zeros(len(pairs),
                                                       np.uint64)
    library().srjt_h2_reciprocals_host(d.ctypes.data, len(pairs),
                                       v2.ctypes.data, v3.ctypes.data)
    return [int(v) for v in v2], [int(v) for v in v3]


def take_counts():
    """{branch: count} since the last call, and {(words of n, words of
    d): count} of the divisions by Algorithm D; both then start from 0."""
    out = np.zeros(64, dtype=np.int64)
    k = library().srjt_h2_take_counts(out.ctypes.data)
    branches = dict(zip(COUNTS, out[:len(COUNTS)].tolist()))
    pairs = {(i // 4, i % 4 + 1): int(c)
             for i, c in enumerate(out[len(COUNTS):k]) if c}
    return branches, pairs
