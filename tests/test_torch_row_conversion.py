"""Port parity: JCUDF row conversion and kernel B3
(spark_rapids_jni_tpu_torch.ops.row_conversion, ops.kernels) against the
JAX package, bit-exact. The JAX package's Pallas word-assembly kernel runs
in interpret mode (``rowconv.pallas=on``) at n <= 4096 rows, and its XLA
path (``off``) is held too."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.ops import pallas_kernels as PK
from spark_rapids_jni_tpu.ops import row_conversion as JR
from spark_rapids_jni_tpu.utils import config
from spark_rapids_jni_tpu_torch.columnar import dtype as dt
from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.ops import row_conversion as R

from torch_parity import assert_table_equal
from torch_parity import table_to_port

_GEN = {
    "int8": (jdt.INT8, lambda r, n: r.integers(-128, 128, n).astype(np.int8)),
    "bool8": (jdt.BOOL8, lambda r, n: r.integers(0, 2, n).astype(np.uint8)),
    "int16": (jdt.INT16, lambda r, n: r.integers(-2**15, 2**15, n)
              .astype(np.int16)),
    "uint16": (jdt.UINT16, lambda r, n: r.integers(0, 2**16, n)
               .astype(np.uint16)),
    "int32": (jdt.INT32, lambda r, n: r.integers(-2**31, 2**31, n)
              .astype(np.int32)),
    "float32": (jdt.FLOAT32, lambda r, n: r.standard_normal(n)
                .astype(np.float32)),
    "int64": (jdt.INT64, lambda r, n: r.integers(-2**63, 2**63 - 1, n)),
    "float64": (jdt.FLOAT64, lambda r, n: np.concatenate(
        [[np.nan, -0.0], r.standard_normal(n - 2)])),
    "uint64": (jdt.UINT64, lambda r, n: r.integers(0, 2**64, n,
                                                   dtype=np.uint64)),
}

SCHEMAS = {
    "subword": ["int8", "int16", "bool8", "uint16", "int8"],
    "words32": ["int32", "float32", "int32"],
    "words64": ["int64", "float64", "uint64"],
    "mixed11": ["int8", "int64", "int16", "float32", "bool8", "float64",
                "int32", "uint16", "int8", "int64", "int32"],
    "lineitem": ["int64", "int32", "int64", "int32"],
}


def _table(schema, n, seed=0, nulls=True):
    r = np.random.default_rng(seed)
    cols = []
    for i, name in enumerate(SCHEMAS[schema]):
        jd, gen = _GEN[name]
        v = r.random(n) > 0.2 if nulls and i % 3 != 1 else None
        cols.append(JColumn.from_numpy(gen(r, n), jd, validity=v))
    return JTable(tuple(cols))


def _blob(col) -> np.ndarray:
    data = col.children[0].data
    if isinstance(data, torch.Tensor):
        return data.numpy().view(np.uint8)
    return np.asarray(data).view(np.uint8)


def _offsets(col) -> np.ndarray:
    o = col.offsets
    return (o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)) \
        .astype(np.int64)


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_convert_to_rows_matches(schema):
    jt = _table(schema, 4096 if schema == "mixed11" else 517)
    got = R.convert_to_rows(table_to_port(jt))
    for mode in ("on", "off"):  # Pallas kernel (interpreted), XLA path
        with config.override("rowconv.pallas", mode):
            want = JR.convert_to_rows(jt)
        assert len(got) == len(want) == 1
        np.testing.assert_array_equal(_blob(got[0]), _blob(want[0]),
                                      err_msg=mode)
        np.testing.assert_array_equal(_offsets(got[0]), _offsets(want[0]))


def test_batching_splits_like_the_jax_package():
    jt = _table("mixed11", 517, seed=4)
    with config.override("rowconv.pallas", "off"):
        want = JR.convert_to_rows(jt, max_batch_bytes=1000)
    got = R.convert_to_rows(table_to_port(jt), max_batch_bytes=1000)
    assert len(got) == len(want) > 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_blob(g), _blob(w))
        np.testing.assert_array_equal(_offsets(g), _offsets(w))
        assert g.size == w.size


@pytest.mark.parametrize("schema", ["mixed11", "lineitem", "words64"])
@pytest.mark.parametrize("nulls", [True, False])
def test_convert_from_rows_matches(schema, nulls):
    """The port reads the JAX package's rows back to the same columns
    (validity None where a column has no null), and round-trips its own."""
    jt = _table(schema, 517, seed=2, nulls=nulls)
    with config.override("rowconv.pallas", "off"):
        jrows = JR.convert_to_rows(jt)[0]
    dtypes = [dt.parse_dtype(c.dtype.id.value) for c in jt.columns]
    want = JR.convert_from_rows(jrows, [c.dtype for c in jt.columns])
    prows = Column.list_of(
        Column(dt.INT8, int(jrows.children[0].size),
               data=torch.from_numpy(_blob(jrows).view(np.int8).copy())),
        torch.from_numpy(_offsets(jrows)))
    assert_table_equal(want, R.convert_from_rows(prows, dtypes))
    pt = table_to_port(jt)
    back = R.convert_from_rows(R.convert_to_rows(pt)[0], dtypes)
    assert_table_equal(jt, back)


def test_convert_from_rows_with_padded_rows():
    """Rows that are not packed back to back (here a 16-byte gap after each
    row) take the gather path and still read back exactly."""
    jt = _table("mixed11", 517, seed=6)
    with config.override("rowconv.pallas", "off"):
        jrows = JR.convert_to_rows(jt)[0]
    blob, offs = _blob(jrows), _offsets(jrows)
    rs = int(offs[1] - offs[0])
    n = jt.num_rows
    wide = np.zeros((n, rs + 16), np.uint8)
    wide[:, :rs] = blob.reshape(n, rs)
    offsets = np.arange(n + 1, dtype=np.int64) * (rs + 16)
    jwide = JColumn.list_of(
        JColumn(jdt.INT8, wide.size, data=np.asarray(wide.reshape(-1))
                .view(np.int8)), offsets.astype(np.int32))
    pwide = Column.list_of(
        Column(dt.INT8, wide.size,
               data=torch.from_numpy(wide.reshape(-1).view(np.int8).copy())),
        torch.from_numpy(offsets))
    dtypes = [c.dtype for c in jt.columns]
    assert_table_equal(JR.convert_from_rows(jwide, dtypes),
                       R.convert_from_rows(pwide, [dt.parse_dtype(
                           d.id.value) for d in dtypes]))


@pytest.mark.parametrize("n", [0, 1, 2])
def test_tiny_tables_round_trip(n):
    """0-2 rows: every column comes back with dense strides and its bits."""
    pt = table_to_port(_table("mixed11", 517, seed=1))
    small = Table(tuple(Column(c.dtype, n, data=c.data[:n],
                               validity=None if c.validity is None
                               else c.validity[:n]) for c in pt.columns))
    rows = R.convert_to_rows(small)
    assert rows[0].size == n
    back = R.convert_from_rows(rows[0], [c.dtype for c in small])
    for a, b in zip(small.columns, back.columns):
        assert b.data.stride() == (1,) and b.data.shape == (n,)
        assert torch.equal(a.data.view(torch.uint8), b.data.view(torch.uint8))
        assert torch.equal(a.valid_mask(), b.valid_mask())


def test_column_information_matches():
    for schema in SCHEMAS.values():
        jd = [_GEN[s][0] for s in schema]
        want = JR.compute_column_information(jd)
        got = R.compute_column_information(
            [dt.parse_dtype(d.id.value) for d in jd])
        assert (got.size_per_row, got.column_starts, got.column_sizes,
                got.validity_offset) == (
            want.size_per_row, want.column_starts, want.column_sizes,
            want.validity_offset)


def test_rowconv_plain_matches_pallas_kernel():
    """ops/kernels.py's B3 plain version against the Pallas kernel it
    replaces, called directly (interpret mode) with the JAX package's
    lane plan."""
    jt = _table("mixed11", 1000, seed=8)
    info = JR.compute_column_information([c.dtype for c in jt.columns])
    row_size = -(-info.size_per_row // 8) * 8
    lanes, plan = JR._word_plan(jt, info, None, None)
    want = PK.rowconv_fixed_words(lanes, tuple(plan), row_size // 4,
                                  jt.num_rows, interpret=True)
    pt = table_to_port(jt)
    pinfo = R.compute_column_information([c.dtype for c in pt.columns])
    cols, valids, pplan = R._word_plan(pt, pinfo)
    got = kernels.rowconv_fixed_words(cols, valids, pplan, row_size // 4,
                                      pt.num_rows)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def test_fixed_width_optimized_limits():
    t = Table(tuple(Column.from_numpy(np.arange(3, dtype=np.int64),
                                      device="cpu") for _ in range(129)))
    with pytest.raises(ValueError, match="100 columns"):
        R.convert_to_rows_fixed_width_optimized(t)
    small = Table(t.columns[:3])
    rows = R.convert_to_rows_fixed_width_optimized(small)
    back = R.convert_from_rows_fixed_width_optimized(
        rows[0], [c.dtype for c in small])
    assert all(torch.equal(a.data, b.data) for a, b in zip(small, back))
    with pytest.raises(ValueError, match="fixed-width and STRING"):
        R.compute_column_information([dt.LIST])
    strings = Table((Column.from_pylist(["a"], dt.STRING, device="cpu"),))
    with pytest.raises(ValueError, match="requires fixed-width"):
        R.convert_to_rows_fixed_width_optimized(strings)
