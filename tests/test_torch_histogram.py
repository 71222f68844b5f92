"""Port parity: ``create_histogram_if_valid`` and
``percentile_from_histogram`` (``spark_rapids_jni_tpu_torch/ops/histogram.py``)
against the JAX package's ops/histogram.py, bit for bit, validity included.

Inputs are tests/test_histogram.py's (invalid rows dropped, a flat
histogram, a negative frequency, Spark's interpolation over mixed
histograms) and seeded draws. The seeded values include NaN, +-inf and
-0.0, which must sort as ``jnp.argsort`` sorts them, and values chosen so
that the interpolation ``v_lo + (v_hi - v_lo) x (pos - lo)`` rounds
differently fused (XLA:CPU contracts it into a multiply-add) and unfused:
the port's ``addcmul`` must give the fused bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import histogram as JHi
from spark_rapids_jni_tpu_torch.ops import histogram as Hi

from torch_parity import assert_col_equal, to_port


def _hist(rows, vtype=jdt.FLOAT64):
    """JAX LIST<STRUCT<value, freq>> of [(value, freq), ...] rows."""
    offsets = np.zeros(len(rows) + 1, dtype=np.int32)
    np.cumsum([len(r) for r in rows], out=offsets[1:])
    vals = [v for r in rows for v, _ in r]
    freqs = [f for r in rows for _, f in r]
    return JColumn.list_of(JColumn.struct_of([
        JColumn.from_pylist(vals, vtype),
        JColumn.from_pylist(freqs, jdt.INT64)]), jnp.asarray(offsets))


def _create_both(values, freqs, as_lists):
    jv, jf = (JColumn.from_pylist(values, jdt.FLOAT64),
              JColumn.from_pylist(freqs, jdt.INT64))
    want = JHi.create_histogram_if_valid(jv, jf, as_lists)
    got = Hi.create_histogram_if_valid(to_port(jv), to_port(jf), as_lists)
    assert_col_equal(want, got)
    return got


def test_create_drops_invalid_rows():
    got = _create_both([1.0, None, 3.0, 4.0, 5.0], [2, 3, 0, None, 7], True)
    assert got.to_pylist() == [[(1.0, 2)], [], [], [], [(5.0, 7)]]


def test_create_flat_histogram():
    got = _create_both([1.0, 2.0, 3.0], [1, 0, 2], False)
    assert got.to_pylist() == [[(1.0, 1), (3.0, 2)]]


def test_create_negative_frequency_raises():
    jv, jf = (JColumn.from_pylist([1.0, 2.0], jdt.FLOAT64),
              JColumn.from_pylist([-2, None], jdt.INT64))
    with pytest.raises(ValueError) as want:
        JHi.create_histogram_if_valid(jv, jf, True)
    with pytest.raises(ValueError) as got:
        Hi.create_histogram_if_valid(to_port(jv), to_port(jf), True)
    assert str(got.value) == str(want.value)
    # a null frequency's value is not looked at
    jf = JColumn.from_pylist([1, None], jdt.INT64)
    jf.data = jnp.asarray([1, -5], jnp.int64)
    _ = JHi.create_histogram_if_valid(jv, jf, True)
    Hi.create_histogram_if_valid(to_port(jv), to_port(jf), True)


def _pct_both(hist, pcts):
    for as_list in (True, False):
        want = JHi.percentile_from_histogram(hist, pcts, as_list)
        got = Hi.percentile_from_histogram(to_port(hist), pcts, as_list)
        assert_col_equal(want, got)
    return got


def test_percentile_mixed_histograms_match():
    rows = [[(1.0, 5)], [(3.0, 1), (1.0, 1), (2.0, 1)], [],
            [(-7.5, 2), (0.0, 1), (12.25, 4), (3.5, 3)],
            [(10.0, 1), (20.0, 3), (5.0, 2), (40.0, 1)]]
    got = _pct_both(_hist(rows), [0.0, 0.1, 0.25, 0.5, 0.9, 0.99, 1.0])
    assert got.to_pylist()[2] is None


@pytest.mark.parametrize("vtype", ["int32", "uint64"])
def test_percentile_integer_values_and_null_rows_match(vtype):
    """Integer values (unsigned ones from their unsigned bits, past 2^63
    too) and a null histogram row."""
    big = (1 << 64) - 1025 if vtype == "uint64" else -4
    rows = [[(7, 2), (3, 1)], [(1, 1)], [(5, 0)], [(big, 3), (9, 9)]]
    hist = _hist(rows, jdt.DType(jdt.TypeId(vtype)))
    hist.validity = jnp.asarray([True, False, True, True])
    _pct_both(hist, [0.3, 0.5])


FRACS = [j / 8 for j in range(1, 8)]


def _fma_sensitive(rng, k):
    """k pairs a < b where a + (b - a) * f, for some f in FRACS, rounds
    differently with and without a fused multiply-add (long double holds
    the exact product and sum of these)."""
    out = []
    while len(out) < k:
        a, b = sorted(rng.standard_normal(2) * 10.0 ** rng.integers(-3, 4))
        if any(float(np.longdouble(a) + np.longdouble(b - a)
                     * np.longdouble(f)) != a + (b - a) * f for f in FRACS):
            out.append((a, b))
    return out


def test_percentile_rounds_as_a_fused_multiply_add():
    """Two-value histograms (a x 512, b x 513) at p = (511 + f) / 1024:
    the position p x 1024 falls f past the 512th item, exactly, so the
    interpolation is a + (b - a) x f. The pairs are picked where fused and
    unfused rounding differ; the port must give the JAX package's (fused)
    bits."""
    rng = np.random.default_rng(8)
    rows = [[(a, 512), (b, 513)] for a, b in _fma_sensitive(rng, 40)]
    pcts = [(511 + f) / 1024 for f in FRACS]
    got = _pct_both(_hist(rows), pcts)
    fused = np.array([[float(np.longdouble(a) + np.longdouble(b - a)
                             * np.longdouble(f)) for f in FRACS]
                      for (a, _), (b, _) in rows])
    plain = np.array([[a + (b - a) * f for f in FRACS]
                      for (a, _), (b, _) in rows])
    assert (fused != plain).any()
    assert np.array_equal(got.data.numpy(), fused[:, 0])


def test_percentile_seeded_special_values_match():
    """NaN, +-inf and -0.0 among the values, zero frequencies, empty and
    one-entry rows, rows longer than one bucket of lanes."""
    rng = np.random.default_rng(11)
    rows = []
    specials = [np.nan, np.inf, -np.inf, -0.0, 0.0]
    for i in range(120):
        k = int(rng.integers(0, 40 if i % 17 == 0 else 9))
        rows.append([(float(specials[int(rng.integers(0, 5))])
                      if rng.random() < 0.2 else float(rng.standard_normal()),
                      int(rng.integers(0, 4))) for _ in range(k)])
    _pct_both(_hist(rows), [0.0, 0.123, 0.5, 0.875, 1.0])


def test_percentile_of_an_empty_value_child():
    hist = JColumn.list_of(JColumn.struct_of([
        JColumn.from_numpy(np.zeros(0), jdt.FLOAT64),
        JColumn.from_numpy(np.zeros(0, np.int64), jdt.INT64)]),
        jnp.zeros(4, jnp.int32))
    got = _pct_both(hist, [0.5])
    assert got.to_pylist() == [None] * 3
    assert torch.equal(got.validity, torch.zeros(3, dtype=torch.bool))
