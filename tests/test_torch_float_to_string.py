"""The port's float -> string casts (``ops/cast_float_to_string.py``)
against the JAX package's, byte for byte: ``float_to_string`` of FLOAT64
and FLOAT32 columns and ``format_number`` at several digit counts, over
the edge values and seeded sweeps of ``tests/test_float_to_string.py``
(random bit patterns included), with nulls. Also the Ryu cores' outputs
(digits, exponent, flags) themselves, and Java's layout against
``tests/test_float_to_string.py``'s oracle."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import cast_float_to_string as JF
from spark_rapids_jni_tpu_torch.ops import cast_float_to_string as PF
from test_float_to_string import (DOUBLE_EDGE, FLOAT_EDGE, java_double_str,
                                  java_float_str)
from torch_parity import assert_col_equal, to_port


def _doubles():
    rng = np.random.default_rng(7)
    vals = np.concatenate([
        np.array(DOUBLE_EDGE),
        rng.standard_normal(300), rng.standard_normal(200) * 1e300,
        rng.standard_normal(200) * 1e-300, rng.uniform(-1e7, 1e7, 200),
        rng.integers(-10**15, 10**15, 100).astype(np.float64),
        rng.integers(0, 1 << 63, 400, dtype=np.int64).view(np.float64),
        -rng.integers(0, 1 << 63, 200, dtype=np.int64).view(np.float64),
        [1e-3, 9.999999e6, 1e7 - 0.5, 123456789.0, 0.1, 0.2, 0.3, 1 / 3]])
    valid = rng.random(len(vals)) > 0.05
    return vals, valid


def _floats():
    rng = np.random.default_rng(11)
    with np.errstate(over="ignore"):  # x 1e38 overflows to inf: kept
        big = (rng.standard_normal(200) * 1e38).astype(np.float32)
    vals = np.concatenate([
        np.array(FLOAT_EDGE, np.float32),
        rng.standard_normal(300).astype(np.float32),
        big, (rng.standard_normal(200) * 1e-38).astype(np.float32),
        rng.uniform(-1e7, 1e7, 200).astype(np.float32),
        rng.integers(0, 1 << 31, 400, dtype=np.int32).view(np.float32),
        (-rng.integers(0, 1 << 31, 200, dtype=np.int32)).view(np.float32)])
    return vals, rng.random(len(vals)) > 0.05


def _pair(vals, valid, t):
    j = JColumn.from_numpy(vals, t, validity=valid)
    return j, to_port(j)


D = _pair(*_doubles(), jdt.FLOAT64)
F = _pair(*_floats(), jdt.FLOAT32)


@pytest.mark.parametrize("which", ["float64", "float32"])
def test_float_to_string_matches(which):
    j, p = D if which == "float64" else F
    assert_col_equal(JF.float_to_string(j), PF.float_to_string(p))


@pytest.mark.parametrize("which", ["float64", "float32"])
def test_ryu_cores_match(which):
    j, p = D if which == "float64" else F
    want = [np.asarray(x) for x in JF._ryu_core_for(j)]
    got = [t.numpy() for t in PF._ryu_core_for(p)]
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=str(k))


def test_java_layout():
    """The strings against test_float_to_string.py's Java oracle."""
    (_, p), (_, pf) = D, F
    vals = p.data.numpy()
    got = [s for s, ok in zip(PF.float_to_string(p).to_pylist(),
                              p.validity.tolist()) if ok]
    want = [java_double_str(v) for v, ok in zip(vals, p.validity.tolist())
            if ok]
    assert got == want
    fvals = pf.data.numpy()
    got = PF.float_to_string(pf).to_pylist()
    assert [g for g, ok in zip(got, pf.validity.tolist()) if ok] == [
        java_float_str(v) for v, ok in zip(fvals, pf.validity.tolist()) if ok]


@pytest.mark.parametrize("d", [0, 2, 4])
def test_format_number_matches(d):
    j, p = D
    assert_col_equal(JF.format_number(j, d), PF.format_number(p, d))


def test_format_number_float32_and_nulls():
    j, p = F
    assert_col_equal(JF.format_number(j, 3), PF.format_number(p, 3))
    col = to_port(JColumn.from_pylist([1.5, None, -0.0, 2.5], jdt.FLOAT64))
    assert PF.format_number(col, 0).to_pylist() == ["2", None, "-0", "2"]
    assert PF.float_to_string(col).to_pylist() == ["1.5", None, "-0.0",
                                                   "2.5"]


def test_layout_chunks_join():
    """Rows laid out in several chunks give the bytes of one chunk."""
    _, p = D
    whole = PF.float_to_string(p)
    old = PF._CHUNK
    PF._CHUNK = 97
    try:
        chunked = PF.float_to_string(p)
    finally:
        PF._CHUNK = old
    assert torch.equal(whole.data, chunked.data)
    assert torch.equal(whole.offsets, chunked.offsets)
