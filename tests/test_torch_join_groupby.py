"""Port parity: sort, the sort-probe inner join and sorted groupby
(spark_rapids_jni_tpu_torch.ops.sort, ops.join, ops.groupby) against the
JAX package, bit-exact: gather maps in the same order, same group order,
same values and validity."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.ops import groupby as JG
from spark_rapids_jni_tpu.ops import join as JJ
from spark_rapids_jni_tpu.ops import sort as JS
from spark_rapids_jni_tpu_torch.ops import groupby as G
from spark_rapids_jni_tpu_torch.ops import join as J
from spark_rapids_jni_tpu_torch.ops import sort as S

from torch_parity import assert_table_equal, to_port
from torch_parity import table_to_port


NL, NR = 700, 300  # one shape for every join: the JAX package compiles once


def _ints(r, n, lo, hi, dtype=np.int64, null_frac=0.0):
    v = r.random(n) >= null_frac if null_frac else None
    return JColumn.from_numpy(r.integers(lo, hi, n).astype(dtype),
                              validity=v)


def _floats(r, n, null_frac=0.0):
    vals = r.integers(-3, 4, n).astype(np.float64)
    vals[r.random(n) < 0.1] = -0.0
    vals[r.random(n) < 0.1] = np.nan
    nan2 = np.frombuffer(np.uint64(0x7FF8000000000042).tobytes(),
                         np.float64)[0]
    vals[r.random(n) < 0.05] = nan2
    v = r.random(n) >= null_frac if null_frac else None
    return JColumn.from_numpy(vals, jdt.FLOAT64, validity=v)


def _join_both(lkeys, rkeys, **kw):
    want = JJ.inner_join(lkeys, rkeys, **kw)
    pkw = {k: (None if v is None else torch.from_numpy(np.asarray(v)))
           if k.endswith("mask") else v for k, v in kw.items()}
    got = J.inner_join([to_port(c) for c in lkeys],
                       [to_port(c) for c in rkeys], **pkw)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("nulls_equal", [False, True])
def test_inner_join_dups_nulls_and_masks(nulls_equal):
    r = np.random.default_rng(0)
    lk = _ints(r, NL, 0, 60, null_frac=0.1)
    rk = _ints(r, NR, 0, 80, null_frac=0.1)
    lmask = r.random(NL) > 0.3
    rmask = r.random(NR) > 0.4
    got = _join_both([lk], [rk], nulls_equal=nulls_equal,
                     left_mask=lmask, right_mask=rmask)
    assert got[0].numel() > 500  # duplicates on both sides
    _join_both([lk], [rk], nulls_equal=nulls_equal)


def test_inner_join_multi_key_floats():
    """Two-column keys with an INT32 and a FLOAT64 column: NaNs (any
    payload) join, -0.0 joins 0.0."""
    r = np.random.default_rng(1)
    lkeys = [_ints(r, NL, 0, 4, np.int32), _floats(r, NL, 0.05)]
    rkeys = [_ints(r, NR, 0, 4, np.int32), _floats(r, NR, 0.05)]
    _join_both(lkeys, rkeys, left_mask=r.random(NL) > 0.5)


def test_inner_join_widens_int32_to_int64():
    """An INT32 key meets the INT64 key that holds the same value (the JAX
    package widens at its eager join boundary, plan/interpreter.py)."""
    r = np.random.default_rng(2)
    l32 = _ints(r, NL, 0, 60, np.int32, null_frac=0.1)
    r64 = _ints(r, NR, 0, 80)
    wide = JColumn(jdt.INT64, l32.size, data=l32.data.astype(np.int64),
                   validity=l32.validity)
    want = JJ.inner_join([wide], [r64])
    got = J.inner_join([to_port(l32)], [to_port(r64)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].numel() > 100


def test_inner_join_empty_side():
    r = np.random.default_rng(3)
    lk = _ints(r, NL, 0, 10)
    rk = _ints(r, NR, 100, 110)
    got = _join_both([lk], [rk])
    assert got[0].numel() == 0


def _gb_table(seed, n=600):
    r = np.random.default_rng(seed)
    return JTable((
        _ints(r, n, 0, 7, np.int32, null_frac=0.1),
        _floats(r, n, 0.05),
        _ints(r, n, -10**12, 10**12, null_frac=0.2),
        _ints(r, n, -100, 100, np.int16),
        JColumn.from_numpy(r.integers(0, 2**32, n).astype(np.uint32),
                           validity=r.random(n) > 0.1),
    ))


AGGS = [(2, "sum"), (2, "count"), (2, "min"), (2, "max"), (3, "sum"),
        (3, "min"), (3, "max"), (4, "sum"), (4, "max"), (0, "count")]


@pytest.mark.parametrize("keys", [[0], [1], [0, 1]], ids=["int", "float",
                                                          "int_float"])
@pytest.mark.parametrize("masked", [False, True])
def test_groupby_aggregate_matches(keys, masked):
    jt = _gb_table(4)
    mask = np.random.default_rng(5).random(jt.num_rows) > 0.35 \
        if masked else None
    want = JG.groupby_aggregate(jt, keys, AGGS, row_mask=mask)
    got = G.groupby_aggregate(
        table_to_port(jt), keys, AGGS,
        row_mask=None if mask is None else torch.from_numpy(mask))
    assert got.num_rows == want.num_rows > 3
    assert_table_equal(want, got)


def test_groupby_all_masked_and_unported_aggs():
    jt = _gb_table(6)
    pt = table_to_port(jt)
    none = np.zeros(jt.num_rows, dtype=bool)
    assert_table_equal(
        JG.groupby_aggregate(jt, [0], [(2, "sum")], row_mask=none),
        G.groupby_aggregate(pt, [0], [(2, "sum")],
                            row_mask=torch.from_numpy(none)))
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        G.groupby_aggregate(pt, [0], [(1, "sum")])
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        G.groupby_aggregate(pt, [0], [(1, "mean")])
    # an integer mean is the exact int64 sum over the count, in float64
    assert_table_equal(
        JG.groupby_aggregate(jt, [0], [(2, "mean"), (3, "mean")]),
        G.groupby_aggregate(pt, [0], [(2, "mean"), (3, "mean")]))


@pytest.mark.parametrize("ascending", [[True, True], [False, True],
                                       [False, False]])
def test_sort_table_matches(ascending):
    jt = _gb_table(7)
    for nf in (None, [False, True]):
        want = JS.sort_table(jt, [1, 0], ascending, nf)
        got = S.sort_table(table_to_port(jt), [1, 0], ascending, nf)
        assert_table_equal(want, got)
    want = JS.sort_table(jt, [4, 3], ascending)
    assert_table_equal(want, S.sort_table(table_to_port(jt), [4, 3],
                                          ascending))
