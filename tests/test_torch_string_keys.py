"""Port parity: STRING keys in sort, groupby, the four eager joins and the
shuffle's partition route (spark_rapids_jni_tpu_torch.ops.sort,
ops.groupby, ops.join, parallel.exchange) against the JAX package on the
CPU, bit for bit; and the slice as a whole — shuffle write, shuffle read,
a string-keyed aggregation and a string-keyed dimension join — on 50K
rows of the JAX package's string row-conversion table."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.ops import groupby as JG
from spark_rapids_jni_tpu.ops import join as JJ
from spark_rapids_jni_tpu.ops import row_conversion as JR
from spark_rapids_jni_tpu.ops import sort as JS
from spark_rapids_jni_tpu.parallel import exchange as JX
from spark_rapids_jni_tpu.utils import datagen as JD
from spark_rapids_jni_tpu_torch.columnar import dtype as dt
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.columnar.table_ops import (concat_tables,
                                                          filter_table)
from spark_rapids_jni_tpu_torch.ops import groupby as G
from spark_rapids_jni_tpu_torch.ops import join as J
from spark_rapids_jni_tpu_torch.ops import row_conversion as R
from spark_rapids_jni_tpu_torch.ops import sort as S
from spark_rapids_jni_tpu_torch.parallel.exchange import partition_ids
from spark_rapids_jni_tpu_torch.utils import datagen as D

from torch_parity import (assert_table_equal, quick_jax_reference,  # noqa: F401
                          table_to_port, to_port)

pytestmark = pytest.mark.usefixtures("quick_jax_reference")

# a pool with NUL-suffixed twins: they tie in the sort (zero-padded byte
# order) but are different keys for groupby and joins (lengths differ)
POOL = [b"", b"\x00", b"a", b"ab", b"ab\x00", b"ab\x00\x00", b"abc",
        b"\xff", b"\xff\x00", "héllo".encode(), b"x" * 31, b"x" * 32,
        b"zz"]
N = 600


def _keys(seed, n=N, p_null=0.1):
    rng = np.random.default_rng(seed)
    vals = [POOL[i] for i in rng.integers(0, len(POOL), n)]
    return [None if rng.random() < p_null else v for v in vals]


@pytest.fixture(scope="module")
def keyed():
    """(JAX table, port table): a STRING key with nulls, an INT32 second
    key, INT64 values with nulls."""
    rng = np.random.default_rng(21)
    jt = JTable((JColumn.from_pylist(_keys(22), jdt.STRING),
                 JColumn.from_numpy(rng.integers(0, 3, N).astype(np.int32),
                                    jdt.INT32),
                 JColumn.from_numpy(rng.integers(-1000, 1000, N), jdt.INT64,
                                    validity=rng.random(N) > 0.15)))
    return jt, table_to_port(jt)


@pytest.mark.parametrize("ascending,nulls_first", [
    ([True, True], None), ([False, True], [False, True]),
    ([True, False], [True, False])])
def test_sort_order_matches(keyed, ascending, nulls_first):
    jt, pt = keyed
    want = JS.sort_order([jt[0], jt[1]], ascending, nulls_first)
    got = S.sort_order([pt[0], pt[1]], ascending, nulls_first)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nul_suffix_ties_keep_input_order():
    c = Column.from_pylist([b"ab\x00", b"ab", b"a", b"ab\x00\x00", b"ab"],
                           dt.STRING, device="cpu")
    assert S.sort_order([c]).tolist() == [2, 0, 1, 3, 4]


def test_groupby_aggregate_matches(keyed):
    """Groups by (STRING, INT32): null keys group together, NUL-suffixed
    twins apart. With a pushed-down row mask the result is the groupby of
    the filtered table (the JAX package's contract), dead groups
    dropped."""
    jt, pt = keyed
    aggs = [(2, "sum"), (2, "count"), (1, "min"), (1, "max")]
    assert_table_equal(JG.groupby_aggregate(jt, [0, 1], aggs),
                       G.groupby_aggregate(pt, [0, 1], aggs))
    mask = torch.from_numpy(np.random.default_rng(23).random(N) > 0.3)
    assert_table_equal(
        G.groupby_aggregate(filter_table(pt, mask), [0, 1], aggs),
        G.groupby_aggregate(pt, [0, 1], aggs, row_mask=mask))


@pytest.fixture(scope="module")
def join_keys():
    """Left and right STRING keys (nulls, duplicates on both sides; one
    shape, so the JAX package compiles its hashes once)."""
    jl = JColumn.from_pylist(_keys(24), jdt.STRING)
    jr = JColumn.from_pylist(_keys(25, p_null=0.2), jdt.STRING)
    return jl, jr, to_port(jl), to_port(jr)


@pytest.mark.parametrize("nulls_equal", [False, True])
@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_joins_match(join_keys, how, nulls_equal):
    jl, jr, pl, pr = join_keys
    jfn, pfn = {"inner": (JJ.inner_join, J.inner_join),
                "left": (JJ.left_join, J.left_join),
                "semi": (JJ.left_semi_join, J.left_semi_join),
                "anti": (JJ.left_anti_join, J.left_anti_join)}[how]
    want = jfn([jl], [jr], nulls_equal=nulls_equal)
    got = pfn([pl], [pr], nulls_equal=nulls_equal)
    if how in ("semi", "anti"):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_join_key_types_must_agree(keyed):
    _, pt = keyed
    with pytest.raises(TypeError, match="join key types differ"):
        J.inner_join([pt[0]], [pt[1]])


def test_partition_ids_on_string_key(keyed):
    jt, pt = keyed
    for parts in (200, 7):
        want = JX.partition_ids(jt, [0], parts)
        got = partition_ids(pt, [0], parts)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the slice: S1-S4 at 50K rows
# ---------------------------------------------------------------------------

ROWS = 50_000


@pytest.fixture(scope="module")
def slice_tables():
    """The JAX package's string row-conversion table (bench_ops.py:109-137)
    built by each package, and the port generator's draws of its STRING
    column."""
    rng = np.random.default_rng(0)
    jt = JTable((
        JColumn.from_numpy(rng.integers(-2**31, 2**31, ROWS), jdt.INT64),
        JColumn.from_numpy(rng.integers(0, 100, ROWS).astype(np.int32),
                           jdt.INT32),
        JColumn.from_numpy(rng.standard_normal(ROWS), jdt.FLOAT64),
        JColumn.from_numpy(rng.integers(0, 2, ROWS).astype(np.uint8),
                           jdt.BOOL8),
        JD.generate_column(ROWS, JD.ColumnProfile(
            jdt.STRING, string_len=JD.Dist("normal", 0, 32),
            cardinality=1000, null_frequency=None), seed=0)))
    pt = D.string_rows_table(ROWS, 0, device="cpu")
    draws = D.string_draws(ROWS, D.STRING_ROWS_PROFILE,
                           np.random.default_rng(0), None)
    return jt, pt, draws


def test_slice_s1_to_s4_matches(slice_tables):
    """S1-S4 of the slice. The partition route is held against the JAX
    package; the aggregate and the join against numpy over the generator's
    own draws (each row's pool entry), grouping by the strings' bytes —
    pool entries can repeat (several empty strings, say)."""
    jt, pt, draws = slice_tables
    assert_table_equal(jt, pt)
    # S1: the map side — partition route and JCUDF rows in two batches
    np.testing.assert_array_equal(
        partition_ids(pt, [4], 200).numpy(),
        np.asarray(JX.partition_ids(jt, [4], 200)))
    spr = R.compute_column_information([c.dtype for c in pt]).size_per_row
    assert spr == 37
    sizes = ((spr + np.diff(pt[4].host_offsets()).astype(np.int64) + 7)
             // 8 * 8)
    cap = int(sizes.sum()) // 2 + 1000
    batches = R.convert_to_rows(pt, max_batch_bytes=cap)
    bounds = JR._batch_boundaries(sizes, cap)
    assert len(batches) == len(bounds) - 1 == 2
    assert [0, batches[0].size, ROWS] == bounds
    # S2: the reduce side — back to columns, bit for bit
    back = concat_tables([R.convert_from_rows(b, [c.dtype for c in pt])
                          for b in batches])
    assert_table_equal(jt, back)
    # S3: aggregate by the string key
    keys, gid = np.unique(np.array(draws.pool_strings(), dtype=object),
                          return_inverse=True)
    rows_gid = gid[draws.index]
    v0 = pt[0].to_numpy()
    v1 = pt[1].to_numpy()
    got = G.groupby_aggregate(back, [4], [(0, "sum"), (0, "count"),
                                          (1, "min"), (1, "max")])
    assert got[0].to_pylist() == [k.decode() for k in keys]
    for col, want in zip(got.columns[1:], (
            [int(v0[rows_gid == g].sum()) for g in range(len(keys))],
            np.bincount(rows_gid).tolist(),
            [int(v1[rows_gid == g].min()) for g in range(len(keys))],
            [int(v1[rows_gid == g].max()) for g in range(len(keys))])):
        assert col.to_pylist() == want
    # S4: join to the dimension table of distinct keys: one match a row
    dim = Column.from_pylist(list(keys), dt.STRING, device="cpu")
    l_idx, r_idx = J.inner_join([back[4]], [dim])
    assert l_idx.tolist() == list(range(ROWS))
    assert r_idx.tolist() == rows_gid.tolist()
