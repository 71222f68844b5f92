"""Port parity: JCUDF row conversion of tables with STRING columns
(spark_rapids_jni_tpu_torch.ops.row_conversion, kernel B3's plain version
with the string slot lanes) against the JAX package on the CPU, bit for
bit: row bytes, row offsets and batch boundaries, on both assembly paths
(row matrix and per-byte), with the column-matrix guard, and the
convert_from_rows round trip. The JAX package runs its XLA path
(``rowconv.pallas=off``), and its Pallas word kernel in interpret mode for
the word check."""

import functools

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
from spark_rapids_jni_tpu_torch.columnar.table_ops import concat_tables
from spark_rapids_jni_tpu_torch.ops import kernels as K
from spark_rapids_jni_tpu_torch.ops import row_conversion as R

from test_torch_strings import random_strings
from torch_parity import assert_table_equal, table_to_port
from torch_parity import quick_jax_reference  # noqa: F401

pytestmark = pytest.mark.usefixtures("quick_jax_reference")


def _table(n, nstr, seed, jumbo=None, max_len=40):
    """INT64 (nullable), then per string column a STRING column (random
    bytes, nulls) and an INT8; ``jumbo`` puts a 5000-byte string in that
    row of the last string column."""
    rng = np.random.default_rng(seed)
    cols = [JColumn.from_numpy(rng.integers(-2**40, 2**40, n), jdt.INT64,
                               validity=rng.random(n) > 0.2)]
    for s in range(nstr):
        vals = random_strings(n, seed * 10 + s, max_len=max_len)
        if jumbo is not None and s == nstr - 1:
            vals[jumbo] = b"j" * 5000
        cols.append(JColumn.from_pylist(vals, jdt.STRING))
        cols.append(JColumn.from_numpy(
            rng.integers(-128, 128, n).astype(np.int8), jdt.INT8,
            validity=rng.random(n) > 0.5 if s % 2 else None))
    return JTable(tuple(cols))


# rows, string columns, jumbo row: the jumbo row's padded width (>4 KB)
# sends its batch down the per-byte path, the others take the row matrix
# (one row count: the JAX package's op compiles are shared across them)
TABLES = {"one_string": (512, 1, 200), "two_strings": (512, 2, None),
          "three_strings": (512, 3, 7)}


@functools.lru_cache(maxsize=None)
def _jax_rows(name):
    """(JAX table, port table, the JAX package's rows of the whole table
    as one batch)."""
    n, nstr, jumbo = TABLES[name]
    jt = _table(n, nstr, seed=nstr, jumbo=jumbo)
    with config.override("rowconv.pallas", "off"):
        (one,) = JR.convert_to_rows(jt)
    return jt, table_to_port(jt), one


@pytest.fixture(scope="module", params=sorted(TABLES))
def rows(request):
    """(JAX table, port table, the JAX package's rows of the whole table
    as one batch: bytes and int64 offsets)."""
    jt, pt, one = _jax_rows(request.param)
    return (jt, pt, np.asarray(one.children[0].data).view(np.uint8),
            np.asarray(one.offsets).astype(np.int64))


# max_batch_bytes, and whether the column-matrix floor is 0 (padding every
# string column to its global max is then too wide: the port pads per
# batch and cuts batches before jumbo rows, the JAX package's pad_blowup)
CAPS = {"one_batch": (R.MAX_BATCH_BYTES, False),
        "batches": (9_000, False),
        "pad_blowup": (30_000, True)}


@pytest.mark.parametrize("cap", sorted(CAPS))
def test_convert_to_rows_matches(rows, cap, monkeypatch):
    """Each batch is the JAX package's rows [b0, b1): their bytes and
    rebased offsets, with the boundaries of the JAX package's rule."""
    jt, pt, blob, offs = rows
    max_bytes, blowup = CAPS[cap]
    if blowup:
        monkeypatch.setattr(R, "_MAT_BYTES_FLOOR", 0)
        monkeypatch.setattr(JR, "_MAT_BYTES_FLOOR", 0)
    got = R.convert_to_rows(pt, max_batch_bytes=max_bytes)
    sizes = np.diff(offs)
    want = JR._batch_boundaries(sizes, max_bytes, 8 if blowup else None)
    if cap != "one_batch":
        assert len(want) > 2
    assert [0] + list(np.cumsum([g.size for g in got])) == want
    for g, b0, b1 in zip(got, want[:-1], want[1:]):
        np.testing.assert_array_equal(g.offsets.numpy(),
                                      offs[b0:b1 + 1] - offs[b0])
        np.testing.assert_array_equal(g.children[0].data.numpy()
                                      .view(np.uint8), blob[offs[b0]:offs[b1]])
    dtypes = [c.dtype for c in pt]
    back = concat_tables([R.convert_from_rows(g, dtypes) for g in got])
    # every column of these tables with a validity mask has a null row, so
    # the presence of the masks survives the round trip too
    assert_table_equal(jt, back)


def test_convert_from_rows_matches():
    """One batch of three string columns back to columns, against the JAX
    package's convert_from_rows (validity presence included)."""
    jt, pt, one = _jax_rows("three_strings")
    (got,) = R.convert_to_rows(pt)
    with config.override("rowconv.pallas", "off"):
        want = JR.convert_from_rows(one, [c.dtype for c in jt])
    assert_table_equal(want, R.convert_from_rows(got, [c.dtype for c in pt]))


def test_empty_table_round_trip():
    pt = table_to_port(_table(0, 2, seed=1))
    (got,) = R.convert_to_rows(pt)
    assert got.size == 0 and got.offsets.tolist() == [0]
    back = R.convert_from_rows(got, [c.dtype for c in pt])
    assert [c.size for c in back] == [0] * pt.num_columns


@pytest.mark.parametrize("seed", range(4))
def test_batch_boundaries_match(seed):
    """The host rule, the device search and the JAX package's rule give
    the same boundaries for random row sizes and batch caps."""
    rng = np.random.default_rng(seed)
    sizes = (rng.integers(1, 60, 600) * 8).astype(np.int64)
    sizes[rng.integers(0, 600, 3)] = 4096 * 8
    cum = torch.zeros(sizes.size + 1, dtype=torch.int64)
    torch.cumsum(torch.from_numpy(sizes), 0, out=cum[1:])
    for cap in (200, 4096, 40_000, 10**6):
        want = JR._batch_boundaries(sizes, cap)
        assert R._batch_boundaries(sizes, cap) == want
        got, starts = R._device_boundaries(cum, sizes.size, int(cum[-1]),
                                           int(sizes.max()), cap)
        assert got == want
        assert starts == [int(cum[b]) for b in want]
        for blow in (1, 8):
            assert R._batch_boundaries(sizes, cap, blow) == \
                JR._batch_boundaries(sizes, cap, blow)


def test_column_information_matches():
    for names in (["string"], ["int8", "string", "int64"],
                  ["bool8", "string", "int16", "string", "float64"],
                  ["string"] * 9):
        want = JR.compute_column_information(
            [jdt.DType(jdt.TypeId(s)) for s in names])
        got = R.compute_column_information([dt.parse_dtype(s)
                                            for s in names])
        assert got == R.ColumnInfo(*(getattr(want, f) for f in (
            "size_per_row", "column_starts", "column_sizes",
            "validity_offset", "variable_width_column_starts")))


def test_string_slot_words_match_pallas_kernel():
    """B3's plain version with the string slot lanes against the Pallas
    kernel it replaces (interpret mode), fed the JAX package's lanes."""
    import jax.numpy as jnp
    jt = _jax_rows("three_strings")[0]
    n = jt.num_rows
    info = JR.compute_column_information([c.dtype for c in jt.columns])
    offs = [jnp.asarray(c.offsets, dtype=jnp.int32) for c in jt.columns
            if c.dtype.id is jdt.TypeId.STRING]
    lengths = jnp.stack([o[1:] - o[:-1] for o in offs], axis=1)
    var = info.size_per_row + jnp.cumsum(lengths, axis=1) - lengths
    nwords = -(-info.size_per_row // 8) * 2
    lanes, plan = JR._word_plan(jt, info, var, lengths)
    want = PK.rowconv_fixed_words(lanes, tuple(plan), nwords, jt.num_rows,
                                  interpret=True)
    pt = table_to_port(jt)
    pinfo = R.compute_column_information([c.dtype for c in pt])
    cols, valids, pplan = R._word_plan(pt, pinfo)
    assert all(c.is_contiguous() and c.shape == (n,) for c in cols)
    assert len(cols) == pt.num_columns + 3
    got = K.rowconv_fixed_words(cols, valids, pplan, nwords, pt.num_rows)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
