"""Port parity: ``hilbert_index`` (spark_rapids_jni_tpu_torch.ops.zorder)
against the JAX package's ops/zorder.py, bit-exact, on the inputs of
tests/test_zorder.py (grids, nulls, the argument checks) and seeded INT32
columns; ``interleave_bits`` returns LIST<UINT8> and is queued with nested
columns (ROADMAP A1)."""

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
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        Z.interleave_bits([to_port(JColumn.from_pylist([1], jdt.INT32))])
