"""Port parity: Spark murmur3_32 and xxhash64 of STRING and mixed tables
(spark_rapids_jni_tpu_torch.ops.hashing, kernels B1/B2's plain versions)
against the JAX package on the CPU, bit for bit, and against Spark's
golden vectors. A mixed table takes the JAX package's XLA path there (its
Pallas kernels take fixed-width rows only); its byte hashes run under
``jax.jit`` here, so each padded shape compiles once for the module
instead of once per call."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.columnar.strings import padded_bytes as jpadded
from spark_rapids_jni_tpu.ops import hashing as JH
from spark_rapids_jni_tpu_torch.columnar import dtype as dt
from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
from spark_rapids_jni_tpu_torch.columnar.strings import padded_bytes
from spark_rapids_jni_tpu_torch.ops import hashing as H
from spark_rapids_jni_tpu_torch.ops import kernels as K

from test_hashing import STRINGS5
from test_hashing_java_vectors import (MIXED_BOOLS, MIXED_DOUBLES,
                                       MIXED_FLOATS, MIXED_INTS,
                                       MIXED_STRINGS, STRINGS_V0)
from torch_parity import quick_jax_reference, to_port  # noqa: F401
from test_torch_strings import random_strings

N = 400
pytestmark = pytest.mark.usefixtures("quick_jax_reference")


@pytest.fixture(scope="module")
def tables():
    """(JAX table, port table) of four columns: STRING with lengths 0-100
    (0, 1-3 and 31-33 among them), random bytes 0-255, nulls; INT64 with
    nulls; FLOAT64 with NaN and -0.0; a second STRING column of the same
    padded width (one compile of each JAX byte hash)."""
    rng = np.random.default_rng(11)
    s1 = random_strings(N, 12, max_len=100)
    s1[:10] = [b"", b"a", b"ab", b"abc", b"x" * 31, b"y" * 32, b"z" * 33,
               b"\x80\xff\x7f", None, b"\x00\x00"]
    s2 = random_strings(N, 13, max_len=100, p_null=0.3)
    f = rng.standard_normal(N)
    f[:3] = [np.nan, -0.0, 0.0]
    jt = JTable((JColumn.from_pylist(s1, jdt.STRING),
                 JColumn.from_numpy(rng.integers(-2**62, 2**62, N), jdt.INT64,
                                    validity=rng.random(N) > 0.1),
                 JColumn.from_numpy(f, jdt.FLOAT64),
                 JColumn.from_pylist(s2, jdt.STRING)))
    return jt, Table(tuple(to_port(c) for c in jt.columns))


LAYOUTS = {"string_only": [0], "string_first": [0, 1, 2],
           "string_middle": [1, 0, 2], "string_last": [1, 2, 0],
           "two_strings": [3, 1, 0]}


@pytest.mark.parametrize("algo", ["murmur3", "xxhash64"])
@pytest.mark.parametrize("seed", [42, 0, 314])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_row_hash_matches_jax(tables, layout, seed, algo):
    jt, pt = tables
    cols = LAYOUTS[layout]
    jfn, pfn = ((JH.murmur_hash3_32, H.murmur_hash3_32) if algo == "murmur3"
                else (JH.xxhash64, H.xxhash64))
    want = jfn(JTable(tuple(jt[i] for i in cols)), seed)
    got = pfn(Table(tuple(pt[i] for i in cols)), seed)
    assert got.dtype.id.value == want.dtype.id.value
    np.testing.assert_array_equal(np.asarray(want.data), got.data.numpy())


def test_byte_hashes_match_jax_directly(tables):
    """_mm_bytes and _xx_bytes over one padded matrix with per-row seeds."""
    jt, pt = tables
    import jax.numpy as jnp
    jm, jl = jpadded(jt[0])
    pm, pl = padded_bytes(pt[0])
    seeds = np.random.default_rng(14).integers(0, 2**32, N, dtype=np.uint64)
    want = JH._mm_bytes(jnp.asarray(seeds.astype(np.uint32)), jm, jl)
    got = H._mm_bytes(torch.from_numpy(seeds.astype(np.int64)), pm, pl)
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy())
    seeds64 = seeds * np.uint64(0x9E3779B97F4A7C15)
    want = JH._xx_bytes(jnp.asarray(seeds64), jm, jl)
    got = H._xx_bytes(torch.from_numpy(seeds64.view(np.int64)), pm, pl)
    np.testing.assert_array_equal(np.asarray(want).view(np.int64),
                                  got.numpy())


def _pcol(vals, d):
    return Column.from_pylist(vals, d, device="cpu")


NULLS8 = [1, 1, 1, 1, 1, 0, 1, 1]

# Spark's golden values, as the JAX package's tests hold them
GOLDEN = {
    # tests/test_hashing.py test_strings, test_strings_seed_314
    "strings5_murmur3_42": (lambda: [_pcol(STRINGS5, dt.STRING)], 42, "mm",
                            [142593372, 1217302703, -715697185,
                             -2061143941, -111635966]),
    "strings5_murmur3_314": (lambda: [_pcol(STRINGS5, dt.STRING)], 314,
                             "mm", [1467149710, 723257560, -1620282500,
                                    -2001858707, 1588473657]),
    # tests/test_hashing.py TestSparkXXHash64.test_strings
    "strings8_xxhash64": (
        lambda: [_pcol([v if NULLS8[i] else None for i, v in enumerate(
            STRINGS5 + ["", "abcdefgh", "abcdefghi"])], dt.STRING)], 42,
        "xx", [-7444071767201028348, -3617261401988713833,
               8198945020833482635, -5346617152005100141,
               6614298085531227868, 42, 2470326616177429180,
               -7093207067522615973]),
    # tests/test_hashing.py test_strings_with_null
    "strings_null_xxhash64": (
        lambda: [_pcol([STRINGS5[0], None] + STRINGS5[1:], dt.STRING)], 42,
        "xx", [-7444071767201028348, 42, -3617261401988713833,
               8198945020833482635, -5346617152005100141,
               6614298085531227868]),
    # tests/test_hashing_java_vectors.py (HashTest.java:46-58, 265-277)
    "java_strings_murmur3": (lambda: [_pcol(STRINGS_V0, dt.STRING)], 42,
                             "mm", [1485273170, 1709559900, 1423943036,
                                    176121990, 1199621434, 42]),
    "java_strings_xxhash64": (lambda: [_pcol(STRINGS_V0, dt.STRING)], 42,
                              "xx", [-8582455328737087284,
                                     2221214721321197934,
                                     5798966295358745941,
                                     -4834097201550955483,
                                     -3782648123388245694, 42]),
    # HashTest.java:154-171 and :373-390, mixed rows
    "java_mixed_murmur3": (lambda: _mixed(), 1868, "mm",
                           [1936985022, 720652989, 339312041, 1400354989,
                            769988643, 1868]),
    "java_mixed_xxhash64": (lambda: _mixed(), 42, "xx",
                            [7451748878409563026, 6024043102550151964,
                             3380664624738534402, 8444697026100086329,
                             -5888679192448042852, 42]),
}


def _mixed():
    return [_pcol(MIXED_STRINGS, dt.STRING), _pcol(MIXED_INTS, dt.INT32),
            _pcol(MIXED_DOUBLES, dt.FLOAT64), _pcol(MIXED_FLOATS, dt.FLOAT32),
            _pcol(MIXED_BOOLS, dt.BOOL8)]


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_string_vectors(case):
    make, seed, algo, want = GOLDEN[case]
    fn = H.murmur_hash3_32 if algo == "mm" else H.xxhash64
    assert fn(make(), seed).to_pylist() == want


def test_kernel_schema_entry_for_strings():
    """The "str" schema entry takes int32[n+1] offsets and uint8
    characters; a STRING column is not a fixed-width word column."""
    c = _pcol(["ab", None, "cde"], dt.STRING)
    sch = [("str", (c.offsets, c.data), c.validity)]
    assert torch.equal(K.murmur3_fixed_rows(sch, 42, 3),
                       H.murmur_hash3_32([c]).data)
    with pytest.raises(TypeError, match="hashes its bytes"):
        H._fixed_element_words(c.dtype, c.data, False)
