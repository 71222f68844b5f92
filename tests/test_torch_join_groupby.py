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


def _floats(r, n, null_frac=0.0, dtype=np.float64):
    """Small integers, -0.0, NaNs of two payloads and subnormals of both
    signs (FLOAT32 subnormal keys equal 0.0 in the JAX package, FLOAT64
    ones are keys of their own)."""
    vals = r.integers(-3, 4, n).astype(dtype)
    vals[r.random(n) < 0.1] = -0.0
    vals[r.random(n) < 0.1] = np.nan
    sub = [1e-45, -1e-40] if dtype == np.float32 else [5e-324, -1e-310]
    vals[r.random(n) < 0.05] = sub[0]
    vals[r.random(n) < 0.05] = sub[1]
    if dtype == np.float64:
        nan2 = np.frombuffer(np.uint64(0x7FF8000000000042).tobytes(),
                             np.float64)[0]
        vals[r.random(n) < 0.05] = nan2
    v = r.random(n) >= null_frac if null_frac else None
    d = jdt.FLOAT64 if dtype == np.float64 else jdt.FLOAT32
    return JColumn.from_numpy(vals, d, validity=v)


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
    lkeys = [_ints(r, NL, 0, 4, np.int32), _floats(r, NL, 0.05),
             _floats(r, NL, 0.05, np.float32)]
    rkeys = [_ints(r, NR, 0, 4, np.int32), _floats(r, NR, 0.05),
             _floats(r, NR, 0.05, np.float32)]
    _join_both(lkeys, rkeys, left_mask=r.random(NL) > 0.5)


def test_inner_join_widens_int32_to_int64():
    """The op hashes raw widths, as the JAX package's op does: an INT32
    key meets no INT64 key, and with ``nulls_equal`` only the null rows
    meet. The plan engine's eager join boundary widens the pair to INT64
    (both packages' plan/interpreter.py), so a Join of mixed widths meets
    equal values."""
    from spark_rapids_jni_tpu import plan as JP
    from spark_rapids_jni_tpu_torch import plan as PP
    from torch_parity import plan_to_port, tables_to_port
    l32 = JColumn.from_pylist([1, 2, None, 3], jdt.INT32)
    r64 = JColumn.from_pylist([3, 1, 1, None], jdt.INT64)
    for nulls_equal, pairs in ((False, []), (True, [(2, 3)])):
        want = JJ.inner_join([l32], [r64], nulls_equal=nulls_equal)
        got = J.inner_join([to_port(l32)], [to_port(r64)],
                           nulls_equal=nulls_equal)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert list(zip(got[0].tolist(), got[1].tolist())) == pairs
    r = np.random.default_rng(2)
    tables = [JTable((_ints(r, NL, 0, 60, np.int32, null_frac=0.1),)),
              JTable((_ints(r, NR, 0, 80),))]
    plan = JP.Join(JP.Scan(1, input_index=0), JP.Scan(1, input_index=1),
                   (0,), (0,), "inner")
    want = JP.run_eager(plan, tables)
    got = PP.run_eager(plan_to_port(plan), tables_to_port(tables))
    assert_table_equal(want, got)
    assert got.num_rows > 100


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
        _floats(r, n, 0.05, np.float32),
    ))


AGGS = [(2, "sum"), (2, "count"), (2, "min"), (2, "max"), (3, "sum"),
        (3, "min"), (3, "max"), (4, "sum"), (4, "max"), (0, "count"),
        (1, "sum"), (1, "mean"), (1, "max"), (5, "sum"), (5, "min")]


@pytest.mark.parametrize("keys", [[0], [1], [0, 1], [5]],
                         ids=["int", "float", "int_float", "float32"])
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
    from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
    jt = _gb_table(6)
    pt = table_to_port(jt)
    none = np.zeros(jt.num_rows, dtype=bool)
    assert_table_equal(
        JG.groupby_aggregate(jt, [0], [(2, "sum")], row_mask=none),
        G.groupby_aggregate(pt, [0], [(2, "sum")],
                            row_mask=torch.from_numpy(none)))
    # float sum and mean: the JAX package's summation order and flushes
    assert_table_equal(
        JG.groupby_aggregate(jt, [0], [(1, "sum"), (1, "mean")]),
        G.groupby_aggregate(pt, [0], [(1, "sum"), (1, "mean")]))
    # unsigned 64-bit aggregates (ported with decimals, A12): int64 sums
    # and int64-order min/max, as the JAX package
    u = np.arange(jt.num_rows, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    ju = JTable((jt.columns[0], JColumn.from_numpy(u)))
    assert_table_equal(
        JG.groupby_aggregate(ju, [0], [(1, "sum"), (1, "min"), (1, "max"),
                                       (1, "mean")]),
        G.groupby_aggregate(table_to_port(ju), [0], [
            (1, "sum"), (1, "min"), (1, "max"), (1, "mean")]))
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
    want = JS.sort_table(jt, [5, 0], ascending)
    assert_table_equal(want, S.sort_table(table_to_port(jt), [5, 0],
                                          ascending))


@pytest.mark.parametrize("nulls_equal", [False, True])
def test_full_join_matches(nulls_equal):
    """The reference's case (test_exec_ops.py::test_full_join), then keys
    with duplicates and nulls on both sides: the inner pairs, the
    unmatched left rows ascending, the unmatched right rows ascending."""
    lk = [JColumn.from_pylist([1, 5], jdt.INT64)]
    rk = [JColumn.from_pylist([1, 7], jdt.INT64)]
    got = J.full_join([to_port(c) for c in lk], [to_port(c) for c in rk])
    assert sorted(zip(got[0].tolist(), got[1].tolist())) == [
        (-1, 1), (0, 0), (1, -1)]
    r = np.random.default_rng(8)
    lk = [_ints(r, NL, 0, 90, null_frac=0.1)]
    rk = [_ints(r, NR, 40, 130, null_frac=0.1)]
    want = JJ.full_join(lk, rk, nulls_equal=nulls_equal)
    got = J.full_join([to_port(c) for c in lk], [to_port(c) for c in rk],
                      nulls_equal=nulls_equal)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] == -1).any() and (got[1] == -1).any()


def _c3_tables():
    from decimal import Decimal
    keys = JColumn.from_pylist([0, 0, 1, 1], jdt.INT32)
    return {
        "string": JTable((keys, JColumn.from_pylist(["a", "b", None, "c"],
                                                    jdt.STRING))),
        "decimal128": JTable((keys, JColumn.from_pylist(
            [Decimal("1.25"), None, Decimal("-3.50"), Decimal("0.01")],
            jdt.decimal128(2)))),
        "int64": JTable((keys, JColumn.from_pylist([1, 2, None, 4],
                                                   jdt.INT64))),
    }


@pytest.mark.parametrize("values,op", [
    ("string", "sum"), ("string", "min"), ("string", "max"),
    ("string", "mean"), ("string", "count"), ("decimal128", "median"),
    ("int64", "median")])
def test_groupby_error_contract_matches(values, op):
    """Both packages raise the same exception type, with the reference's
    message, for an aggregation their contract refuses (or both run it:
    a count over strings)."""
    jt = _c3_tables()[values]
    pt = table_to_port(jt)
    try:
        want = JG.groupby_aggregate(jt, [0], [(1, op)])
    except (TypeError, ValueError) as e:
        with pytest.raises(type(e)) as got:
            G.groupby_aggregate(pt, [0], [(1, op)])
        assert str(got.value) == str(e)
        return
    assert_table_equal(want, G.groupby_aggregate(pt, [0], [(1, op)]))
