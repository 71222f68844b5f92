"""Port parity: ``hilbert_index`` (spark_rapids_jni_tpu_torch.ops.zorder)
against the JAX package's ops/zorder.py, bit-exact, on the inputs of
tests/test_zorder.py (grids, nulls, the argument checks) and seeded INT32
columns; ``interleave_bits`` (a LIST<UINT8> column) on the inputs of
tests/test_zorder.py:41-125 and seeded columns of every width."""

import numpy as np
import pytest

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import zorder as JZ
from spark_rapids_jni_tpu_torch.ops import zorder as Z

from torch_parity import assert_col_equal, to_port

N = 512  # one row count for the seeded draws


def _ints(seed, lo=-(2**31), hi=2**31 - 1, null_frac=0.1):
    r = np.random.default_rng(seed)
    return JColumn.from_numpy(r.integers(lo, hi, N).astype(np.int32),
                              jdt.INT32, validity=r.random(N) >= null_frac)


def _hold(num_bits, jcols):
    want = JZ.hilbert_index(num_bits, jcols)
    got = Z.hilbert_index(num_bits, [to_port(c) for c in jcols])
    assert_col_equal(want, got)
    return got


@pytest.mark.parametrize("num_bits,ncols", [(32, 2), (21, 3), (16, 4),
                                            (1, 1), (32, 1), (5, 12)])
def test_hilbert_index_matches(num_bits, ncols):
    """Seeded INT32 columns with nulls: values past ``num_bits`` are
    masked, 2 x 32 bits sets the index's sign bit."""
    got = _hold(num_bits, [_ints(10 * num_bits + i) for i in range(ncols)])
    if num_bits * ncols == 64:
        assert bool((got.data < 0).any())


def test_hilbert_grid_is_the_jax_curve():
    """Every point of the 2-bit 3-D grid (test_zorder.py's curve check)."""
    side = 4
    grids = np.meshgrid(*[np.arange(side)] * 3, indexing="ij")
    jcols = [JColumn.from_numpy(g.reshape(-1).astype(np.int32), jdt.INT32)
             for g in grids]
    got = _hold(2, jcols)
    assert sorted(got.data.tolist()) == list(range(side ** 3))


def test_hilbert_argument_checks_match():
    c32 = JColumn.from_pylist([1], jdt.INT32)
    c64 = JColumn.from_pylist([1], jdt.INT64)
    for num_bits, cols in ((0, [c32]), (33, [c32]), (32, [c32] * 3),
                           (4, []), (4, [c64])):
        with pytest.raises((ValueError, TypeError)) as want:
            JZ.hilbert_index(num_bits, cols)
        with pytest.raises(type(want.value)) as got:
            Z.hilbert_index(num_bits, [to_port(c) for c in cols])
        assert str(got.value) == str(want.value)


def test_interleave_bits_names_its_queue_item():
    """Ported: a one-column interleave is the value's big-endian bytes,
    as in the JAX package."""
    jc = JColumn.from_pylist([1, None, -2], jdt.INT32)
    want = JZ.interleave_bits([jc])
    got = Z.interleave_bits([to_port(jc)])
    assert_col_equal(want, got)
    assert got.to_pylist() == [[0, 0, 0, 1], [0, 0, 0, 0],
                               [255, 255, 255, 254]]


# tests/test_zorder.py:41-125's inputs: the reference's matrices
# (InterleaveBitsTest.java), with nulls, and seeded columns of each width
REFERENCE_MATRICES = [
    (jdt.INT32, [[0x00000000, None, -1, -0x00FF0100],
                 [-1, 0x00000000, 0x00FF00FF, None]]),
    (jdt.INT16, [[0x0000, 0x4444, 0x1111], [0x1111, -0x7778, 0x2222],
                 [0x2222, 0x0000, 0x4444]]),
]


@pytest.mark.parametrize("dtype,columns", REFERENCE_MATRICES)
def test_interleave_reference_matrices_match(dtype, columns):
    jcols = [JColumn.from_pylist(c, dtype) for c in columns]
    assert_col_equal(JZ.interleave_bits(jcols),
                     Z.interleave_bits([to_port(c) for c in jcols]))


@pytest.mark.parametrize("name,npt,ncols", [
    ("int8", np.int8, 5), ("float32", np.float32, 3),
    ("float64", np.float64, 2)])
def test_interleave_seeded_columns_match(name, npt, ncols):
    """Element widths of 1, 4 and 8 bytes and the float bit patterns
    (random bytes: NaNs among them), nulls as zeros: column 0 is the most
    significant."""
    rng = np.random.default_rng(sum(map(ord, name)))
    jcols = []
    for _ in range(ncols):
        raw = rng.integers(0, 256, 37 * np.dtype(npt).itemsize,
                           dtype=np.uint8).view(npt)
        jcols.append(JColumn.from_numpy(raw, jdt.DType(jdt.TypeId(name)),
                                        validity=rng.random(37) > 0.2))
    assert_col_equal(JZ.interleave_bits(jcols),
                     Z.interleave_bits([to_port(c) for c in jcols]))


def test_interleave_zero_columns_and_checks_match():
    want = JZ.interleave_bits([], num_rows=10)
    got = Z.interleave_bits([], num_rows=10, device="cpu")
    assert_col_equal(want, got)
    assert got.to_pylist() == [[]] * 10
    a = JColumn.from_pylist([1], jdt.INT32)
    for cols in ([], [a, JColumn.from_pylist([1], jdt.INT64)],
                 [JColumn.from_pylist(["x"], jdt.STRING)],
                 [JColumn.from_pylist([1], jdt.decimal128(2))]):
        with pytest.raises((TypeError, ValueError)) as want:
            JZ.interleave_bits(cols)
        with pytest.raises(type(want.value)) as got:
            Z.interleave_bits([to_port(c) for c in cols])
        assert str(got.value) == str(want.value)
