"""DECIMAL columns through the port's layers against the JAX package's,
bit for bit: construction and readback, both row hashes (with Spark's
golden values), sort orders, groupby aggregates and keys (DECIMAL128 sum,
min, max, mean with its wrap flag; DECIMAL32/64 and UINT64), the four
eager joins on a DECIMAL128 key, JCUDF rows, the shuffle's partition route
and concat, FLBA decimal Parquet files through both readers, and a small
TPC-H q1 in Spark's decimal types through both packages' ops.
"""

import decimal
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.columnar import table_ops as JT
from spark_rapids_jni_tpu.ops import decimal128 as JD
from spark_rapids_jni_tpu.ops import groupby as JG
from spark_rapids_jni_tpu.ops import hashing as JH
from spark_rapids_jni_tpu.ops import join as JJ
from spark_rapids_jni_tpu.ops import row_conversion as JR
from spark_rapids_jni_tpu.ops import sort as JS
from spark_rapids_jni_tpu.parallel import exchange as JX
from spark_rapids_jni_tpu.parquet import reader as jreader
from spark_rapids_jni_tpu_torch.columnar import dtype as dt
from spark_rapids_jni_tpu_torch.columnar import table_ops as T
from spark_rapids_jni_tpu_torch.columnar.column import (Column, Table,
                                                        decimal128_literal)
from spark_rapids_jni_tpu_torch.ops import decimal128 as D
from spark_rapids_jni_tpu_torch.ops import groupby as G
from spark_rapids_jni_tpu_torch.ops import hashing as H
from spark_rapids_jni_tpu_torch.ops import join as J
from spark_rapids_jni_tpu_torch.ops import row_conversion as R
from spark_rapids_jni_tpu_torch.ops import sort as S
from spark_rapids_jni_tpu_torch.parallel.exchange import partition_ids
from spark_rapids_jni_tpu_torch.parquet import reader as preader
from spark_rapids_jni_tpu_torch.utils import config
from spark_rapids_jni_tpu_torch.utils import datagen
from spark_rapids_jni_tpu_torch.utils import datagen_parquet as W
from torch_parity import (assert_col_equal, assert_table_equal,  # noqa: F401
                          jitted_jax_decimal, quick_jax_reference,
                          table_to_port, to_port)

pytestmark = pytest.mark.usefixtures("quick_jax_reference",
                                     "jitted_jax_decimal")
decimal.getcontext().prec = 80

N = 600
# tests/test_hashing.py's DECIMAL128 values (unscaled, scale 11)
DEC128_UNSCALED5 = [0, 100, -1, -999999999999999999999999999,
                    9999999999999999999999999999999999999]
NULLS8 = [1, 1, 1, 1, 1, 0, 1, 1]


def _jdec(values, scale, valid=None):
    """JAX DECIMAL128 column of unscaled ints."""
    import jax.numpy as jnp
    from spark_rapids_jni_tpu.columnar.column import int128_to_limbs
    limbs = np.stack([int128_to_limbs(int(v)) for v in values])
    return JColumn(jdt.decimal128(scale), len(values),
                   data=jnp.asarray(limbs),
                   validity=None if valid is None else jnp.asarray(valid))


def _table(seed=0, n=N):
    """(JAX table, port table): INT32 key of 5 values (one all-null
    group's worth of decimal nulls), DECIMAL128 values of every digit
    count with nulls, a DECIMAL128 key of 40 values, INT64, STRING."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 5, n).astype(np.int32)
    vals = datagen.decimal128_draws(n, rng, 36)
    valid = rng.random(n) > 0.1
    valid[key == 4] = False  # group 4: no valid value
    pool = datagen.decimal128_draws(40, rng)
    dkey = [pool[i] for i in rng.integers(0, 40, n)]
    dvalid = rng.random(n) > 0.05
    strs = [f"s{v % 97}" for v in rng.integers(0, 10**6, n)]
    jt = JTable((JColumn.from_numpy(key), _jdec(vals, 4, valid),
                 _jdec(dkey, 2, dvalid),
                 JColumn.from_numpy(rng.integers(-2**40, 2**40, n)),
                 JColumn.from_pylist(strs, jdt.STRING)))
    return jt, table_to_port(jt)


@pytest.mark.parametrize("kind", ["decimal32", "decimal64", "decimal128"])
def test_pylist_round_trip_matches_jax(kind):
    vals = [Decimal("1.25"), None, Decimal("-3.5"), 7, "0.015",
            Decimal("-99999.99")]
    if kind == "decimal128":
        vals += [Decimal("-99999999999999999999999999999999999.99"),
                 Decimal("12345678901234567890123456789.01")]
    jd = getattr(jdt, kind)(2)
    pd = getattr(dt, kind)(2)
    jc = JColumn.from_pylist(vals, jd)
    pc = Column.from_pylist(vals, pd, device="cpu")
    assert_col_equal(jc, pc, kind)
    assert pc.to_pylist() == jc.to_pylist()
    assert to_port(jc).to_pylist() == jc.to_pylist()


def test_golden_spark_hashes():
    """Spark's values (tests/test_hashing.py: hash.cpp's constants)."""
    c = Column.from_pylist(DEC128_UNSCALED5, dt.decimal128(11),
                           device="cpu")
    assert H.murmur_hash3_32([c], 42).to_pylist() == [
        -783713497, -295670906, 1398487324, -52622807, -1359749815]
    vals = DEC128_UNSCALED5 + [0, DEC128_UNSCALED5[3], DEC128_UNSCALED5[4]]
    c = Column.from_pylist([v if NULLS8[i] else None
                            for i, v in enumerate(vals)], dt.decimal128(11),
                           device="cpu")
    assert H.xxhash64([c], 42).to_pylist() == [
        -8959994473701255385, 4409375254388155230, -4006032525457443936,
        -5423362182451591024, 7041733194569950081, 42,
        -5423362182451591024, 7041733194569950081]


def test_golden_xxhash64_combined():
    """tests/test_hashing.py's combined xxhash64 row, every type of it:
    STRING, FLOAT64, timestamps, DECIMAL64/32, the integers, BOOL8 and
    DECIMAL128, seed-chained."""
    from test_hashing import (F32_LOWEST, F32_MAX, F64_LOWEST, F64_MAX,
                              I32_MAX, I32_MIN, I64_MAX, I64_MIN, STRINGS5,
                              neg_nan)

    def col(vals, d):
        return Column.from_pylist([v if NULLS8[i] else None
                                   for i, v in enumerate(vals)], d,
                                  device="cpu")
    cols = [
        col(STRINGS5 + ["", "abcdefgh", "abcdefghi"], dt.STRING),
        col([0.0, -0.0, neg_nan(64), F64_LOWEST, F64_MAX, 0.0, 100.0,
             200.0], dt.FLOAT64),
        col([0, 100, -100, -9223372036854, 9223372036854, 0, 200, 300],
            dt.DType(dt.TypeId.TIMESTAMP_MILLISECONDS)),
        col([0, 100, -100, -999999999999999999, 999999999999999999, 0, 123,
             432], dt.decimal64(7)),
        col([0, 100, -100, I64_MIN, I64_MAX, 0, 0x123456789ABCDEF,
             -0x123456789ABCDEF], dt.INT64),
        col([0.0, -0.0, neg_nan(32), F32_LOWEST, F32_MAX, 0.0, float("inf"),
             float("-inf")], dt.FLOAT32),
        col([0, 100, -100, -21474836, 21474836, 0, -200, -300],
            dt.DType(dt.TypeId.TIMESTAMP_DAYS)),
        col([0, 100, -100, -999999999, 999999999, 0, -200, -300],
            dt.decimal32(3)),
        col([0, 100, -100, I32_MIN, I32_MAX, 0, -200, -300], dt.INT32),
        col([0, 100, -100, -32768, 32767, 0, -200, -300], dt.INT16),
        col([0, 100, -100, -128, 127, 0, -90, -80], dt.INT8),
        Column.from_numpy(np.array([0, 1, 2, 255, 0, 0, 0, 0], np.uint8),
                          dt.BOOL8, validity=np.array(NULLS8, bool),
                          device="cpu"),
        col(DEC128_UNSCALED5 + [0, DEC128_UNSCALED5[3],
                                DEC128_UNSCALED5[4]], dt.decimal128(11)),
    ]
    assert H.xxhash64(cols, 42).to_pylist() == [
        541735645035655239, 9011982951766246298, 3834379147931449211,
        -5406325166887725795, 7797509897614041972, 42,
        -9032872913521304524, -604070008711895908]


@pytest.mark.parametrize("algo", ["murmur3", "xxhash64"])
def test_hashes_match_jax(algo):
    jt, pt = _table(1)
    jfn = JH.xxhash64 if algo == "xxhash64" else JH.murmur_hash3_32
    pfn = H.xxhash64 if algo == "xxhash64" else H.murmur_hash3_32
    for idx in ([1], [2], [0, 1, 3], [4, 2, 1]):
        for seed in (42, 0):
            want = jfn([jt.columns[i] for i in idx], seed)
            got = pfn([pt.columns[i] for i in idx], seed)
            assert_col_equal(want, got, f"{algo} {idx} {seed}")


@pytest.mark.parametrize("ascending", [True, False])
def test_sort_matches_jax(ascending):
    jt, pt = _table(2)
    for nf in (None, [False, True]):
        want = JS.sort_table(jt, [1, 0], [ascending, True], nf)
        got = S.sort_table(pt, [1, 0], [ascending, True], nf)
        assert_table_equal(want, got)
    assert_table_equal(JS.sort_table(jt, [2], [ascending]),
                       S.sort_table(pt, [2], [ascending]))


AGGS = [(1, "sum"), (1, "min"), (1, "max"), (1, "mean"), (1, "count")]


@pytest.mark.parametrize("masked", [False, True])
def test_groupby_decimal128_matches_jax(masked):
    """DECIMAL128 sum/min/max/mean/count by an INT32 key (one group with
    no valid value) and by the DECIMAL128 key itself, with and without a
    pushed-down row mask."""
    jt, pt = _table(3)
    mask = np.random.default_rng(4).random(N) > 0.3 if masked else None
    pmask = None if mask is None else torch.from_numpy(mask)
    for keys, aggs in (([0], AGGS), ([2], AGGS + [(3, "sum")]),
                       ([0, 2], [(1, "sum"), (3, "max")])):
        want = JG.groupby_aggregate(jt, keys, aggs, row_mask=mask)
        got = G.groupby_aggregate(pt, keys, aggs, row_mask=pmask)
        assert_table_equal(want, got)


def test_groupby_decimal128_wrap_flag_matches_jax():
    """Group sums past int128: the sum wraps (mod 2^128, as the JAX
    package's) and the mean is null (the fifth-limb flag); a group that
    only passes 10^38 on the way back is exact."""
    big = (1 << 126) + 12345
    vals = [big, big, 1, -big, -big, -5, 10 ** 37, 10 ** 37, -(10 ** 37),
            7, 7, 7, -3, 2]
    key = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4]
    # N rows in 5 groups, as _table's: the JAX package's ops are compiled
    # at these shapes already
    vals += [0] * (N - len(vals))
    key += [4] * (N - len(key))
    jt = JTable((JColumn.from_numpy(np.array(key, np.int32)),
                 _jdec(vals, 0)))
    aggs = [(1, "sum"), (1, "mean"), (1, "min"), (1, "max")]
    want = JG.groupby_aggregate(jt, [0], aggs)
    got = G.groupby_aggregate(table_to_port(jt), [0], aggs)
    assert_table_equal(want, got)
    assert got.columns[2].to_pylist()[:2] == [None, None]


def test_groupby_decimal32_64_uint64_match_jax():
    rng = np.random.default_rng(5)
    n = N
    key = rng.integers(0, 5, n).astype(np.int32)
    cols = [JColumn.from_numpy(key),
            JColumn.from_numpy(rng.integers(-10**8, 10**8, n).astype(
                np.int32), jdt.decimal32(3),
                validity=rng.random(n) > 0.1),
            JColumn.from_numpy(rng.integers(-10**17, 10**17, n),
                               jdt.decimal64(7)),
            JColumn.from_numpy(rng.integers(0, 2**63, n).astype(np.uint64)
                               * np.uint64(3))]
    jt = JTable(tuple(cols))
    aggs = [(c, op) for c in (1, 2, 3)
            for op in ("sum", "min", "max", "mean", "count")]
    assert_table_equal(JG.groupby_aggregate(jt, [0], aggs),
                       G.groupby_aggregate(table_to_port(jt), [0], aggs))
    # a DECIMAL64 key, and an empty input keeps the output types
    assert_table_equal(JG.groupby_aggregate(jt, [2], [(3, "max")]),
                       G.groupby_aggregate(table_to_port(jt), [2],
                                           [(3, "max")]))
    je = JT.slice_table(jt, 0, 0)
    assert_table_equal(JG.groupby_aggregate(je, [0], aggs),
                       G.groupby_aggregate(table_to_port(je), [0], aggs))


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
def test_joins_on_decimal128_key_match_jax(kind):
    jt, pt = _table(6)
    rng = np.random.default_rng(7)
    pick = rng.integers(0, N, N)  # N rows a side: shapes compile once
    jr = JT.gather_table(jt, pick)
    pr = T.gather_table(pt, torch.from_numpy(pick))
    for nulls_equal in (False, True):
        jfn = {"inner": JJ.inner_join, "left": JJ.left_join,
               "semi": JJ.left_semi_join, "anti": JJ.left_anti_join}[kind]
        pfn = {"inner": J.inner_join, "left": J.left_join,
               "semi": J.left_semi_join, "anti": J.left_anti_join}[kind]
        for keys in ([2], [2, 0]):
            want = jfn([jt.columns[i] for i in keys],
                       [jr.columns[i] for i in keys], nulls_equal)
            got = pfn([pt.columns[i] for i in keys],
                      [pr.columns[i] for i in keys], nulls_equal)
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rows_round_trip_matches_jax():
    """JCUDF rows with a 16-byte DECIMAL128 slot equal the JAX package's,
    and come back bit for bit; with a STRING column after the decimal
    (its slot's lanes past the decimal's four) the rows come back too."""
    jt, pt = _table(8)
    jfixed = JTable((jt.columns[1], jt.columns[0], jt.columns[2],
                     jt.columns[3]))
    fixed = table_to_port(jfixed)
    want = JR.convert_to_rows(jfixed)
    got = R.convert_to_rows(fixed)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(
        got[0].children[0].data.numpy().view(np.uint8),
        np.asarray(want[0].children[0].data).view(np.uint8))
    dtypes = [c.dtype for c in fixed.columns]
    assert_table_equal(JR.convert_from_rows(want[0], [c.dtype for c in
                                                      jfixed.columns]),
                       R.convert_from_rows(got[0], dtypes))
    rows = R.convert_to_rows(pt)
    back = R.convert_from_rows(rows[0], [c.dtype for c in pt.columns])
    for a, b in zip(back.columns, pt.columns):
        assert a.to_pylist() == b.to_pylist()


def test_partition_ids_and_concat_match_jax():
    """The shuffle on a DECIMAL128 key: the partition route (B1 over the
    Java bytes) == the JAX package's; the split by partition reassembles
    to the rows in partition order; concat == the JAX package's."""
    jt, pt = _table(9)
    for keys in ([2], [1, 0]):
        want = np.asarray(JX.partition_ids(jt, keys, 7))
        pid = partition_ids(pt, keys, 7)
        np.testing.assert_array_equal(pid.numpy(), want)
    parts = [T.filter_table(pt, pid == p) for p in range(7)]
    order = torch.argsort(pid, stable=True)
    assert_table_equal(T.gather_table(pt, order), T.concat_tables(parts))
    fixed = JTable(jt.columns[:4])
    halves = [JT.slice_table(fixed, 0, 250), JT.slice_table(fixed, 250, N)]
    assert_table_equal(JT.concat_tables(halves), T.concat_tables(
        [table_to_port(h) for h in halves]))


def _pyarrow_file(path, n=700, seed=10):
    rng = np.random.default_rng(seed)
    cents = rng.integers(-10**11, 10**11, n)
    wide = datagen.decimal128_draws(n + 9, rng, 30)[9:]  # no edge values
    nulls = rng.random(n) < 0.1
    t = pa.table({
        "price": pa.array([None if z else Decimal(int(v)).scaleb(-2)
                           for v, z in zip(cents, nulls)],
                          pa.decimal128(12, 2)),
        "wide": pa.array([Decimal(v).scaleb(-4) for v in wide],
                         pa.decimal128(38, 4)),
        "k": pa.array(rng.integers(0, 9, n))})
    pq.write_table(t, path, row_group_size=300, use_dictionary=False)
    return t


def test_flba_decimal_file_both_packages_and_tiers(tmp_path):
    """A pyarrow-written FLBA decimal file: the port on both tiers == the
    JAX package's reader == pyarrow; the device tier's reader routes the
    FLBA columns to the host tier, counted host_columns_unsupported."""
    from spark_rapids_jni_tpu.utils import config as jconfig
    path = str(tmp_path / "flba.parquet")
    t = _pyarrow_file(path)
    for tier in ("native", "device"):
        with jconfig.override("parquet.device_decode", tier):
            want = jreader.read_parquet(path)
        before = preader.route_metrics.snapshot()
        with config.override("parquet.device_decode", tier):
            got = preader.read_parquet(path, device="cpu")
        after = preader.route_metrics.snapshot()
        assert_table_equal(want, got)
        for name, col in zip(("price", "wide"), got.columns):
            assert col.to_pylist() == t.column(name).to_pylist()
        if tier == "device":
            assert after["host_columns_unsupported"] \
                - before["host_columns_unsupported"] == 2
            assert after["device_columns"] - before["device_columns"] == 1


def test_writer_flba_decimal_matches_pyarrow_and_jax(tmp_path):
    """The port's writer lays out FLBA decimal(12, 2) as parquet-mr and
    pyarrow do (6 bytes, big-endian, DECIMAL(12, 2)): pyarrow reads its
    values; both packages' readers agree."""
    rng = np.random.default_rng(11)
    n = 5000
    v = rng.integers(-10**11, 10**11, n)
    valid = rng.random(n) > 0.05
    path = str(tmp_path / "w.parquet")
    W.write_parquet(path, [W.ParquetColumn("p", values=v, valid=valid,
                                           decimal=(12, 2)),
                           W.ParquetColumn("q", values=rng.integers(
                               1, 51, n))], page_rows=1000)
    meta = pq.ParquetFile(path)
    col = meta.schema.column(0)
    assert (col.physical_type, col.length) == ("FIXED_LEN_BYTE_ARRAY", 6)
    assert (col.precision, col.scale) == (12, 2)
    assert pq.read_table(path).column("p").to_pylist() == [
        Decimal(int(x)).scaleb(-2) if ok else None
        for x, ok in zip(v, valid)]
    assert_table_equal(jreader.read_parquet(path),
                       preader.read_parquet(path, device="cpu"))


def _q1_decimal(li, dec_ops, groupby, literal, cutoff=2400):
    """TPC-H q1 in Spark's decimal types over a lineitem whose four money
    columns are DECIMAL128 at scale 2 (quantity, price, discount, tax;
    then returnflag, linestatus, shipdate): disc_price at scale 4,
    charge at scale 6, the sums, the means at scale 6 and the count by
    (returnflag, linestatus) where shipdate <= cutoff."""
    qty, price, disc, tax, rf, ls, ship = li.columns
    n = qty.size
    one = literal(n)
    d1 = dec_ops.sub_decimal128(one, disc, 2)[1]
    t1 = dec_ops.add_decimal128(one, tax, 2)[1]
    disc_price = dec_ops.multiply_decimal128(price, d1, 4)[1]
    charge = dec_ops.multiply_decimal128(disc_price, t1, 6)[1]
    cols = (rf, ls, qty, price, disc_price, charge, disc)
    return cols, [(2, "sum"), (3, "sum"), (4, "sum"), (5, "sum"),
                  (2, "mean"), (3, "mean"), (6, "mean"), (2, "count")]


def test_decimal_q1_matches_jax():
    """A small TPC-H q1 (600 rows) in Spark's decimal types through both
    packages' ops: DECIMAL128 arithmetic, then the groupby, then the sort
    by the keys."""
    from spark_rapids_jni_tpu_torch import tpch
    n, cutoff = N, 2400
    a = tpch.q1_arrays(n, 3)
    money = {"l_quantity": a["l_quantity"] * 100,
             "l_extendedprice": a["l_extendedprice"],
             "l_discount": a["l_discount"], "l_tax": a["l_tax"]}
    jcols = [_jdec(v, 2) for v in money.values()] + [
        JColumn.from_numpy(a[k]) for k in ("l_returnflag", "l_linestatus",
                                           "l_shipdate")]
    jli = JTable(tuple(jcols))
    pli = table_to_port(jli)
    import jax.numpy as jnp
    from spark_rapids_jni_tpu.columnar.column import int128_to_limbs
    one_limbs = jnp.asarray(np.tile(int128_to_limbs(100), (n, 1)))

    def jlit(k):
        return JColumn(jdt.decimal128(2), k, data=one_limbs)

    jc, aggs = _q1_decimal(jli, JD, JG, jlit)
    pc, _ = _q1_decimal(pli, D, G,
                        lambda k: decimal128_literal("1.00", 2, k, "cpu"))
    for w, g in zip(jc, pc):
        assert_col_equal(w, g, "q1 columns")
    mask = np.asarray(a["l_shipdate"] <= cutoff)
    want = JG.groupby_aggregate(JTable(jc), [0, 1], aggs, row_mask=mask)
    got = G.groupby_aggregate(Table(pc), [0, 1], aggs,
                              row_mask=torch.from_numpy(mask))
    assert_table_equal(want, got)
    assert_table_equal(JS.sort_table(want, [0, 1]),
                       S.sort_table(got, [0, 1]))
    # the answer itself, in Python ints: charge = price (100 - d)(100 + t)
    m = mask
    for g, (rf, ls) in enumerate(zip(got.columns[0].to_pylist(),
                                     got.columns[1].to_pylist())):
        sel = m & (a["l_returnflag"] == rf) & (a["l_linestatus"] == ls)
        p, d, t = (a[k][sel].astype(object) for k in
                   ("l_extendedprice", "l_discount", "l_tax"))
        charge = int((p * (100 - d) * (100 + t)).sum())
        assert got.columns[5].to_pylist()[g] == Decimal(charge).scaleb(-6)
        cnt = int(sel.sum())
        q = int(a["l_quantity"][sel].sum()) * 100 * 10**4
        mean = (2 * q + cnt) // (2 * cnt)  # HALF_UP of positive values
        assert got.columns[6].to_pylist()[g] == Decimal(mean).scaleb(-6)
