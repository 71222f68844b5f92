"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version, and the slice on the card against the slice on the CPU.

Marked ``gpu``: every test skips where no card is present. The file imports
no JAX (the card's machine has none), so it runs there on its own:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch import tpch
from spark_rapids_jni_tpu_torch.columnar import dtype as dt
from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
from spark_rapids_jni_tpu_torch.ops import hashing as H
from spark_rapids_jni_tpu_torch.ops import kernels as K
from spark_rapids_jni_tpu_torch.ops import row_conversion as R
from spark_rapids_jni_tpu_torch.columnar.table_ops import concat_tables
from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate
from spark_rapids_jni_tpu_torch.ops.join import inner_join
from spark_rapids_jni_tpu_torch.parallel.exchange import partition_ids
from spark_rapids_jni_tpu_torch.utils import datagen

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m gpu on the card)")
    return torch.device("cuda")


_MIXED = [(np.int8, dt.INT8), (np.int64, dt.INT64), (np.int16, dt.INT16),
          (np.float32, dt.FLOAT32), (np.uint8, dt.BOOL8),
          (np.float64, dt.FLOAT64), (np.int32, dt.INT32),
          (np.uint16, dt.UINT16), (np.int8, dt.INT8), (np.uint64, dt.UINT64),
          (np.int32, dt.INT32)]


def _mixed(n, device, nulls=True, seed=0):
    """11 columns, sub-word to 64-bit, floats with -0.0 and NaN."""
    rng = np.random.default_rng(seed)
    cols = []
    for i, (npt, d) in enumerate(_MIXED):
        vals = rng.integers(0, 2**63, n).astype(npt)
        if d.is_floating:
            vals = rng.standard_normal(n).astype(npt)
            specials = np.array([0.0, -0.0, np.nan, -np.inf], npt)[:n]
            vals[:len(specials)] = specials
        v = rng.random(n) > 0.2 if nulls and i % 3 else None
        cols.append(Column.from_numpy(vals, d, validity=v, device=device))
    return Table(tuple(cols))


@pytest.mark.parametrize("algo", ["murmur3", "xxhash64"])
@pytest.mark.parametrize("nulls", [True, False])
def test_hash_kernels_match_plain(cuda, algo, nulls):
    t = _mixed(100_003, cuda, nulls)
    xx = algo == "xxhash64"
    schema = [(*H._fixed_element_words(c.dtype, c.data, xx), c.validity)
              for c in t.columns]
    fn = K.xxhash64_fixed_rows if xx else K.murmur3_fixed_rows
    plain = K.xxhash64_fixed_rows_plain if xx else K.murmur3_fixed_rows_plain
    for seed in (0, 42, -1):
        before = fn.launches
        got = fn(schema, seed, t.num_rows)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.device.type == "cuda"
        assert torch.equal(got, plain(schema, seed, t.num_rows))


def _string_schema(t, xx):
    return [(("str", (c.offsets, c.data)) if c.dtype.id is dt.TypeId.STRING
             else H._fixed_element_words(c.dtype, c.data, xx)) + (c.validity,)
            for c in t.columns]


@pytest.mark.parametrize("algo", ["murmur3", "xxhash64"])
@pytest.mark.parametrize("where", ["only", "first", "middle", "last"])
def test_string_hash_kernels_match_plain(cuda, algo, where):
    """B1/B2 with a STRING column of random bytes 0-255, lengths 0-100
    (every tail and stripe branch), 1% nulls, alone or among fixed-width
    columns."""
    s = datagen.random_bytes_column(50_001, 100, 0.01, seed=3, device=cuda)
    fixed = _mixed(50_001, cuda, seed=4).columns[:3]
    cols = {"only": [s], "first": [s, *fixed],
            "middle": [fixed[0], s, *fixed[1:]], "last": [*fixed, s]}[where]
    xx = algo == "xxhash64"
    schema = _string_schema(Table(tuple(cols)), xx)
    fn = K.xxhash64_fixed_rows if xx else K.murmur3_fixed_rows
    plain = K.xxhash64_fixed_rows_plain if xx else K.murmur3_fixed_rows_plain
    for seed in (42, 0):
        got = fn(schema, seed, s.size)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(schema, seed, s.size))


def _b2_matches_plain(cols):
    """B2 over ``cols`` launches once per call and equals its plain
    version bit for bit, seeds 42 and 0."""
    schema = _string_schema(Table(tuple(cols)), True)
    n = cols[0].size
    for seed in (42, 0):
        before = K.xxhash64_fixed_rows.launches
        got = K.xxhash64_fixed_rows(schema, seed, n)
        torch.cuda.synchronize()
        assert K.xxhash64_fixed_rows.launches == before + 1
        assert torch.equal(got, K.xxhash64_fixed_rows_plain(schema, seed, n))


def _at_residue(col, r, row0):
    """``col`` from row ``row0`` on (offsets not starting at 0), its
    characters copied to an address that is r mod 16."""
    buf = torch.empty(col.data.numel() + 32, dtype=torch.uint8,
                      device=col.data.device)
    start = (r - buf.data_ptr()) % 16
    data = buf[start:start + col.data.numel()]
    data.copy_(col.data)
    return Column(dt.STRING, col.size - row0, data=data,
                  validity=col.validity[row0:], offsets=col.offsets[row0:])


@pytest.mark.parametrize("residue", range(16))
def test_b2_strings_at_every_address_residue(cuda, residue):
    """B2's 16-byte staging copies over characters that start at every
    address residue mod 16, from a row whose offset is not 0."""
    base = datagen.random_bytes_column(4099, 100, 0.05, seed=20, device=cuda)
    col = _at_residue(base, residue, residue + 1)
    assert col.data.data_ptr() % 16 == residue
    assert int(col.offsets[0]) > 0
    _b2_matches_plain([col])


@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_b2_strings_ragged_tiles(cuda, n):
    """Row counts around B2's 32-row tile."""
    _b2_matches_plain([datagen.random_bytes_column(n, 100, 0.1, seed=n,
                                                   device=cuda)])


@pytest.mark.parametrize("case", ["all_empty", "all_null"])
def test_b2_strings_all_empty_or_null(cuda, case):
    col = (datagen.random_bytes_column(1000, 0, seed=2, device=cuda)
           if case == "all_empty" else
           datagen.random_bytes_column(1000, 100, 1.0, seed=3, device=cuda))
    _b2_matches_plain([col])


@pytest.mark.parametrize("nstr", [2, 3])
def test_b2_several_string_columns_among_fixed(cuda, nstr):
    m = 5003
    fixed = _mixed(m, cuda, seed=6).columns
    strs = [datagen.random_bytes_column(m, 60 * (i + 1), 0.1, seed=30 + i,
                                        device=cuda) for i in range(nstr)]
    cols = [fixed[1], strs[0], fixed[6], strs[1]]
    if nstr == 3:
        cols = [strs[0], fixed[1], strs[1], fixed[6], strs[2]]
    _b2_matches_plain(cols)


def test_b2_long_strings_take_both_paths(cuda):
    """1M rows, ~1% of them strings of 2-8 KB: the tiles without one are
    staged, a long string is hashed from device memory, in one launch."""
    n = 1 << 20
    rng = np.random.default_rng(5)
    lengths = rng.integers(0, 101, n)
    long = rng.random(n) < 0.01
    lengths[long] = rng.integers(2048, 8001, int(long.sum()))
    offs = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(lengths, out=offs[1:])
    chars = rng.integers(0, 256, int(offs[-1]), dtype=np.uint8)
    col = Column(dt.STRING, n, data=torch.from_numpy(chars).to(cuda),
                 validity=torch.from_numpy(rng.random(n) > 0.01).to(cuda),
                 offsets=torch.from_numpy(offs).to(cuda))
    tiles = K.xxhash64_tile_plan(offs, col.data.data_ptr() % 16)
    assert any(t.windows for t in tiles)
    assert any(t.device_rows for t in tiles)
    _b2_matches_plain([col])


@pytest.mark.parametrize("nstr", [1, 2, 3])
def test_string_slot_rowconv_kernel_matches_plain(cuda, nstr):
    """B3 with the (offset, length) lanes of 1-3 string slots."""
    n = 70_001
    base = _mixed(n, cuda, seed=5).columns
    cols = []
    for i in range(nstr):
        cols += [base[i], datagen.random_bytes_column(n, 40, 0.1, seed=i,
                                                      device=cuda)]
    t = Table(tuple(cols))
    info = R.compute_column_information([c.dtype for c in t])
    args = (*R._word_plan(t, info), R._round_up(info.size_per_row, 8) // 4,
            n)
    got = K.rowconv_fixed_words(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, K.rowconv_fixed_words_plain(*args))


def test_string_slice_on_card_equals_cpu(cuda):
    """The string slice (partition route, JCUDF rows in batches, back,
    aggregate and join by the string key) on the card and on the CPU."""
    out = {}
    for dev in (cuda, torch.device("cpu")):
        t = datagen.string_rows_table(100_000, 0, device=dev)
        rows = R.convert_to_rows(t, max_batch_bytes=2_000_000)
        back = concat_tables([R.convert_from_rows(b, [c.dtype for c in t])
                              for b in rows])
        agg = groupby_aggregate(back, [4], [(0, "sum"), (0, "count"),
                                            (1, "min"), (1, "max")])
        dim = Table((agg[0],))
        out[dev.type] = ([partition_ids(t, [4], 200)]
                         + [b.children[0].data for b in rows]
                         + [c.data for c in back]
                         + [c.data for c in agg]
                         + list(inner_join([back[4]], [dim[0]])))
    assert len(out["cuda"]) == len(out["cpu"])
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a.cpu(), b)


def test_hash_wrapper_checks_its_inputs(cuda):
    words = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="u32 words"):
        K.murmur3_fixed_rows([("u32", words, None)], 42, 8)
    with pytest.raises(ValueError, match="span devices"):
        K.murmur3_fixed_rows([("u64", words, None),
                              ("u64", words.cpu(), None)], 42, 8)


def test_rowconv_wrapper_checks_its_plan(cuda):
    col = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):  # 8-byte read
        K.rowconv_fixed_words([col], [None], [(0, 0, K.PART_LO, 0)], 2, 8)


@pytest.mark.parametrize("n", [1, 777, 65_536])
def test_rowconv_kernel_matches_plain(cuda, n):
    for table in (_mixed(n, cuda), Table(_mixed(n, cuda).columns[:4])):
        info = R.compute_column_information([c.dtype for c in table])
        cols, valids, plan = R._word_plan(table, info)
        nwords = R._round_up(info.size_per_row, 8) // 4
        before = K.rowconv_fixed_words.launches
        got = K.rowconv_fixed_words(cols, valids, plan, nwords, n)
        torch.cuda.synchronize()
        assert K.rowconv_fixed_words.launches == before + 1
        assert torch.equal(got, K.rowconv_fixed_words_plain(
            cols, valids, plan, nwords, n))
        back = R.convert_from_rows(R.convert_to_rows(table)[0],
                                   [c.dtype for c in table])
        for a, b in zip(table, back):
            assert torch.equal(a.data.view(torch.uint8),
                               b.data.view(torch.uint8))
            assert torch.equal(a.valid_mask(), b.valid_mask())


def _rowconv_matches_plain(table):
    info = R.compute_column_information([c.dtype for c in table])
    cols, valids, plan = R._word_plan(table, info)
    nwords = R._round_up(info.size_per_row, 8) // 4
    before = K.rowconv_fixed_words.launches
    got = K.rowconv_fixed_words(cols, valids, plan, nwords, table.num_rows)
    torch.cuda.synchronize()
    assert K.rowconv_fixed_words.launches == before + 1
    assert torch.equal(got, K.rowconv_fixed_words_plain(
        cols, valids, plan, nwords, table.num_rows))
    return nwords


_ROW_SIZES = {  # bytes per row -> schema (indices into _MIXED)
    8: [6],              # int32 + validity byte
    24: [1, 9],          # int64, uint64 + validity
    32: [1, 6, 5, 10],   # lineitem's widths
    40: [1, 5, 9, 1],    # 4 x 8 bytes + validity
}


@pytest.mark.parametrize("row_size", sorted(_ROW_SIZES))
@pytest.mark.parametrize("n", [1, 3001])
@pytest.mark.parametrize("validity", ["mixed", "all_null", "no_null"])
def test_rowconv_tiles_match_plain(cuda, row_size, n, validity):
    """B3 at R-ragged row counts and rows of 8-40 bytes (nwords % 4 != 0
    for 8, 24 and 40), with every validity a mix, all false, or all true."""
    t = Table(tuple(_mixed(n, cuda, nulls=True).columns[i]
                    for i in _ROW_SIZES[row_size]))
    if validity != "mixed":
        fill = torch.zeros if validity == "all_null" else torch.ones
        t = Table(tuple(c.with_validity(fill(n, dtype=torch.bool,
                                             device=cuda)) for c in t))
    assert 4 * _rowconv_matches_plain(t) == row_size


@pytest.mark.parametrize("start", [1, 3])
def test_rowconv_misaligned_views(cuda, start):
    """Column views that start at element 1 or 3 of int8, int16 and int32
    columns (data pointers not 16-byte aligned), nullable and not."""
    base = _mixed(70_007, cuda)
    n = base.num_rows - 3
    cols = []
    for i in (0, 2, 6, 7, 1, 10):
        c = base.columns[i]
        v = None if c.validity is None else c.validity[start:start + n]
        cols.append(Column(c.dtype, n, data=c.data[start:start + n],
                           validity=v))
    assert any(c.data.data_ptr() % 16 for c in cols)
    _rowconv_matches_plain(Table(tuple(cols)))


def test_rowconv_wide_schema_windows(cuda):
    """600 mixed columns, a third of them nullable: the row is split into
    several word windows."""
    rng = np.random.default_rng(5)
    n = 5_003
    cols = []
    for i in range(600):
        npt, d = _MIXED[i % len(_MIXED)]
        vals = rng.integers(0, 256, n * np.dtype(npt).itemsize,
                            dtype=np.uint8).view(npt)
        v = rng.random(n) > 0.3 if i % 3 == 0 else None
        cols.append(Column.from_numpy(vals, d, validity=v, device=cuda))
    t = Table(tuple(cols))
    info = R.compute_column_information([c.dtype for c in t])
    _, valids, plan = R._word_plan(t, info)
    nwords = R._round_up(info.size_per_row, 8) // 4
    tiles = K.rowconv_tile_plan(plan, [c.data.element_size() for c in t],
                                [v is not None for v in valids], nwords)
    assert len(tiles.windows) > 1
    _rowconv_matches_plain(t)


def test_q3_on_card_equals_cpu(cuda):
    """Shuffle write/read and q3 on the card give the CPU's q3 table bit for
    bit, and the card's run launches B1, B2 and B3."""
    K.reset_launches()
    cust, orders, lineitem = tpch.generate_q3_tables(1 << 16, 3, cuda)
    assert partition_ids(lineitem, [0], 200).device.type == "cuda"
    rows = R.convert_to_rows(lineitem)
    back = R.convert_from_rows(rows[0], [c.dtype for c in lineitem])
    top_card = tpch.run_q3(cust, orders, back)
    torch.cuda.synchronize()
    assert K.murmur3_fixed_rows.launches == 1
    assert K.xxhash64_fixed_rows.launches == 4
    assert K.rowconv_fixed_words.launches == 1
    top_cpu = tpch.run_q3(*tpch.generate_q3_tables(1 << 16, 3, "cpu"))
    assert top_card.num_rows == top_cpu.num_rows == 10
    for a, b in zip(top_card.columns, top_cpu.columns):
        assert a.data.device.type == "cuda"
        assert torch.equal(a.data.cpu(), b.data)
        assert torch.equal(a.valid_mask().cpu(), b.valid_mask())


_PLAN_ROWS = 1_000_000
_QUERIES = {
    "q1": (lambda d: (tpch.generate_q1_lineitem(_PLAN_ROWS, 5, d),),
           tpch.run_q1),
    "q6": (lambda d: (tpch.generate_q1_lineitem(_PLAN_ROWS, 5, d),),
           tpch.run_q6),
    "q3": (lambda d: tpch.generate_q3_tables(_PLAN_ROWS, 6, d), tpch.run_q3),
    "q5": (lambda d: tpch.generate_q5_tables(_PLAN_ROWS, 7, d), tpch.run_q5),
}


def _same_answer(a, b):
    """Same values and validity bits (validity presence may differ
    between the engines)."""
    if isinstance(a, int):
        return a == b
    return a.num_rows == b.num_rows and all(
        x.dtype == y.dtype
        and torch.equal(x.data.cpu().view(torch.uint8),
                        y.data.cpu().view(torch.uint8))
        and torch.equal(x.valid_mask().cpu(), y.valid_mask().cpu())
        for x, y in zip(a.columns, b.columns))


@pytest.mark.parametrize("q", sorted(_QUERIES))
def test_plan_engine_on_card_equals_eager_and_cpu(cuda, q):
    """At 1M rows the fused plan engine on the card runs with no
    fallback, equals the eager engine on the card bit for bit, and
    equals the fused engine on the CPU."""
    from spark_rapids_jni_tpu_torch.plan import plan_metrics
    gen, run = _QUERIES[q]
    card = gen(cuda)
    plan_metrics.reset()
    fused = run(*card)                       # engine="auto": fused here
    snap = plan_metrics.snapshot()
    assert (snap["plan_executes"], snap["plan_fallbacks"]) == (1, 0), snap
    assert _same_answer(fused, run(*card, engine="eager"))
    assert _same_answer(fused, run(*gen("cpu"), engine="plan"))


# ---------------------------------------------------------------------------
# H1: the ordered segment float aggregate
# ---------------------------------------------------------------------------

def _h1_args(key, vcol):
    """(z, valid, starts) of a value column grouped by an integer key."""
    from spark_rapids_jni_tpu_torch.ops import groupby as G
    from spark_rapids_jni_tpu_torch.ops.sort import sort_order
    order = sort_order([key])
    k = key.data.index_select(0, order)
    seg = torch.cat([torch.zeros(1, dtype=torch.int64, device=k.device),
                     torch.cumsum((k[1:] != k[:-1]).to(torch.int64), 0)])
    G_ = int(seg[-1]) + 1
    starts = torch.searchsorted(seg, torch.arange(G_ + 1, device=k.device))
    z = G._f64_values(vcol).index_select(0, order)
    return z, vcol.valid_mask().index_select(0, order), starts


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.mark.parametrize("col", [1, 2], ids=["f64", "f32"])
def test_h1_matches_plain_on_edge_table(cuda, col):
    t = datagen.float_edge_table(1 << 20, 0, device=cuda)
    z, valid, starts = _h1_args(t.columns[0], t.columns[col])
    before = K.segment_float_agg.launches
    got = K.segment_float_agg(z, valid, starts)
    torch.cuda.synchronize()
    assert K.segment_float_agg.launches == before + 1
    want = K.segment_float_agg_plain(z, valid, starts)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and _bits_equal(g, w)


def test_h1_long_and_empty_segments(cuda):
    """Two long segments, empty ones between, and a one-row tail."""
    rng = np.random.default_rng(5)
    n = 60_001
    z = torch.from_numpy(rng.standard_normal(n) * 1e-300).to(cuda)
    valid = torch.from_numpy(rng.random(n) > 0.2).to(cuda)
    starts = torch.tensor([0, 0, 25_000, 25_000, 25_000, 60_000, n],
                          dtype=torch.int64, device=cuda)
    got = K.segment_float_agg(z, valid, starts)
    want = K.segment_float_agg_plain(z, valid, starts)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


def _h1_counted(z, valid, starts):
    """H1 with its flushed-chunk count, held bit for bit against plain and
    the count against ``flushed_chunks_plain``; returns the count."""
    cnt = torch.zeros(1, dtype=torch.int64, device=z.device)
    got = K.segment_float_agg(z, valid, starts, flushed=cnt)
    want = K.segment_float_agg_plain(z, valid, starts)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)
    assert int(cnt) == K.flushed_chunks_plain(z, valid, starts)
    return int(cnt)


def test_h1_flushed_path_on_subnormal_partial_sums(cuda):
    """Sums through subnormal partial sums take the flushed path and keep
    the reference's bits."""
    t = datagen.subnormal_sum_table(seed=0, device=cuda)
    z, valid, starts = _h1_args(t.columns[0], t.columns[1])
    assert _h1_counted(z, valid, starts) > 0


def test_h1_normal_draw_takes_no_flushed_chunk(cuda):
    rng = np.random.default_rng(8)
    n = 1_000_003
    z = torch.from_numpy(rng.standard_normal(n)).to(cuda)
    valid = torch.from_numpy(rng.random(n) > 0.1).to(cuda)
    cuts = np.sort(rng.integers(0, n, 99))
    starts = torch.from_numpy(np.concatenate([[0], cuts, [n]])).to(cuda)
    assert _h1_counted(z, valid, starts) == 0


def test_h1_segments_longer_than_the_ring_odd_starts(cuda):
    """Segments of many ring slots (4 x 256 rows) with starts that are not
    16-byte aligned, tiny inputs in a few chunks; the inputs are views one
    row into their tensors."""
    rng = np.random.default_rng(9)
    n = 200_001
    z = rng.standard_normal(n + 1)
    z[rng.integers(0, n, 40)] = 2.0 ** -1021
    valid = rng.random(n + 1) > 0.1
    starts = torch.tensor([0, 1, 3, 1_030, 1_031, 9_999, 77_777, 150_001,
                           n], dtype=torch.int64, device=cuda)
    assert _h1_counted(torch.from_numpy(z).to(cuda)[1:],
                       torch.from_numpy(valid).to(cuda)[1:], starts) > 0


def test_h1_groupby_on_card_equals_cpu(cuda):
    t = datagen.float_edge_table(200_000, 1, device=cuda)
    c = datagen.float_edge_table(200_000, 1, device="cpu")
    aggs = [(1, "sum"), (1, "mean"), (1, "min"), (1, "max"), (2, "sum"),
            (2, "mean"), (2, "min"), (2, "max"), (2, "count")]
    got = groupby_aggregate(t, [0], aggs)
    want = groupby_aggregate(c, [0], aggs)
    assert got.num_rows == want.num_rows
    for g, w in zip(got.columns, want.columns):
        assert torch.equal(g.valid_mask().cpu(), w.valid_mask())
        assert torch.equal(g.data.cpu().view(torch.uint8),
                           w.data.view(torch.uint8))


def test_c1_float32_subnormal_keys_on_card(cuda):
    from spark_rapids_jni_tpu_torch.ops.sort import sort_order
    v = np.array([1e-45, 0.0, -1e-45, -0.0, 1e-40, 1.0], np.float32)
    k = Column.from_numpy(v, dt.FLOAT32, device=cuda)
    h = H.xxhash64([k]).data.cpu().numpy()
    assert (h[[0, 2, 4]] == 3614696996920510707).all()
    assert sort_order([k]).cpu().tolist() == [0, 1, 2, 3, 4, 5]
    assert inner_join([k], [k])[0].numel() == 26
    one = Column.from_numpy(np.ones(6, np.int64), dt.INT64, device=cuda)
    g = groupby_aggregate(Table((k, one)), [0], [(1, "count")])
    assert g.columns[1].data.cpu().tolist() == [5, 1]


def test_dict32_join_and_groupby_on_card_equal_cpu(cuda):
    from spark_rapids_jni_tpu_torch.columnar import dictionary as D
    rng = np.random.default_rng(9)
    pool = [f"k{i:04d}".encode() * (i % 3 + 1) for i in range(300)]
    n = 100_000
    draws = rng.integers(0, 300, n)
    vals = rng.integers(-1000, 1000, n)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        values = D.values_from_entries(pool, dev)
        key = D.dict_column(torch.from_numpy(draws).to(dev), values,
                            validity=torch.from_numpy(
                                np.arange(n) % 17 != 0).to(dev))
        dim = D.dict_column(torch.arange(300, device=dev), values)
        t = Table((key, Column.from_numpy(vals, dt.INT64, device=dev)))
        g = groupby_aggregate(t, [0], [(1, "sum"), (1, "min"),
                                       (1, "count")])
        li, ri = inner_join([key], [dim])
        out[dev.type] = ([c.data.cpu() for c in g.columns],
                         li.cpu(), ri.cpu())
    (gc, lc, rc), (gp, lp, rp) = out["cuda"], out["cpu"]
    assert all(torch.equal(a, b) for a, b in zip(gc, gp))
    assert torch.equal(lc, lp) and torch.equal(rc, rp)
    assert lc.numel() == int((np.arange(n) % 17 != 0).sum())


# ---------------------------------------------------------------------------
# the memory and fault domains on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def task_thread():
    """An installed RmmSpark with this thread dedicated to task 1."""
    from spark_rapids_jni_tpu_torch.memory import RmmSpark
    RmmSpark.set_event_handler(pool_bytes=8 << 30, watchdog_period_s=0.01)
    RmmSpark.current_thread_is_dedicated_to_task(1)
    try:
        yield RmmSpark
    finally:
        RmmSpark.remove_current_thread_association()
        RmmSpark.task_done(1)
        RmmSpark.clear_event_handler()


@pytest.mark.parametrize("took", [True, False])
def test_release_barrier_waits_only_for_a_taken_bracket(cuda, took):
    from spark_rapids_jni_tpu_torch.memory import release_barrier
    out = torch.ones(4, device=cuda)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of queued work
    out += 1
    assert release_barrier(out, took) is out
    assert torch.cuda.current_stream(cuda).query() is took
    torch.cuda.synchronize()


def test_hbm_audit_validates_every_taken_bracket(cuda, task_thread):
    from spark_rapids_jni_tpu_torch.memory import hbm
    from spark_rapids_jni_tpu_torch.ops.sort import sort_table
    from spark_rapids_jni_tpu_torch.utils import config
    hbm.reset()
    t = _mixed(1 << 20, cuda)
    with config.override("rmm.validate_hbm", True):
        sort_table(t, [0, 1])
        groupby_aggregate(t, [6], [(1, "sum"), (9, "count")])
        R.convert_from_rows(R.convert_to_rows(t)[0],
                            [c.dtype for c in t.columns])
    rep = hbm.report()
    assert rep["brackets"] == 4 and rep["validated"] == 4
    assert rep["worst"] and all(r > 0 for _, r, _ in rep["worst"])
    assert task_thread.pool_used() == 0
    hbm.reset()


def test_guarded_cuda_oom_is_typed_and_leaves_the_card_usable(cuda):
    from spark_rapids_jni_tpu_torch.faultinj.guard import guarded_dispatch
    from spark_rapids_jni_tpu_torch.memory import TpuRetryOOM
    idx = torch.cuda.current_device()
    total = torch.cuda.get_device_properties(idx).total_memory
    torch.cuda.empty_cache()
    cap = (torch.cuda.memory_reserved(idx) + (256 << 20)) / total
    torch.cuda.set_per_process_memory_fraction(cap, idx)
    try:
        with pytest.raises(TpuRetryOOM) as ei:
            guarded_dispatch("plan_execute",
                             lambda: torch.empty(1 << 30, device=cuda))
        assert isinstance(ei.value.__cause__, torch.cuda.OutOfMemoryError)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, idx)
        torch.cuda.empty_cache()
    big = torch.ones(1 << 30, dtype=torch.uint8, device=cuda)
    assert int(big.sum()) == 1 << 30


def _parquet_file(path, n=60_000, seed=0):
    """A file of the port's writer with nulls, a STRING dictionary and a
    chunk whose dictionary falls back to PLAIN mid-chunk."""
    from spark_rapids_jni_tpu_torch.utils import datagen_parquet as W
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.1
    entries = [f"key{i}".encode() for i in range(300)] + [b""]
    cols = [
        W.ParquetColumn("i32", values=rng.integers(0, 90, n)
                        .astype(np.int32), valid=valid),
        W.ParquetColumn("i64", values=rng.integers(-2**62, 2**62, n)),
        W.ParquetColumn("f64", values=rng.standard_normal(n), valid=valid),
        W.ParquetColumn("b", values=rng.random(n) > 0.5, valid=valid),
        W.string_codes("key", rng.integers(0, len(entries), n), entries,
                       valid=valid),
        W.ParquetColumn("mixed", values=np.where(
            np.arange(n) % 20_000 < 5_000, rng.integers(0, 10, n),
            np.arange(n)).astype(np.int64)),
    ]
    W.write_parquet(path, cols, row_group_rows=20_000, page_rows=5_000,
                    dict_page_bytes=4096)


def test_parquet_device_tier_on_cuda(cuda, tmp_path):
    """The device tier on the card: bit for bit the device tier on the
    CPU, and on the valid rows the host tier; the mixed chunk takes the
    host tier; DICT32 codes and dictionary equal the CPU's."""
    from spark_rapids_jni_tpu_torch.columnar import dictionary as D
    from spark_rapids_jni_tpu_torch.parquet import reader as PR
    from spark_rapids_jni_tpu_torch.utils import config
    path = str(tmp_path / "g.parquet")
    _parquet_file(path)

    def read(device, tier, encoded=False):
        with config.override("parquet.device_decode", tier), \
                config.override("parquet.encoded_strings", encoded):
            return PR.read_parquet(path, device=device)

    before = PR.route_metrics.snapshot()
    got = read(cuda, "auto")
    after = PR.route_metrics.snapshot()
    assert after["device_columns"] - before["device_columns"] == 5
    assert after["host_columns_unsupported"] \
        - before["host_columns_unsupported"] == 1
    cpu = read("cpu", "device")
    host = read(cuda, "native")
    for i, (g, c, h) in enumerate(zip(got, cpu, host)):
        assert g.device.type == cuda.type, i
        assert (g.validity is None) == (c.validity is None), i
        assert torch.equal(g.valid_mask().cpu(), c.valid_mask()), i
        assert torch.equal(g.valid_mask(), h.valid_mask()), i
        if g.dtype.id is dt.TypeId.STRING:
            assert torch.equal(g.offsets.cpu(), c.offsets), i
            assert torch.equal(g.data.cpu(), c.data), i
            assert g.to_pylist() == h.to_pylist(), i
            continue
        bits = {1: torch.uint8, 4: torch.int32, 8: torch.int64}[
            g.data.element_size()]
        assert torch.equal(g.data.cpu().view(bits), c.data.view(bits)), i
        v = g.valid_mask()
        assert torch.equal(g.data.view(bits)[v], h.data.view(bits)[v]), i
    gd = read(cuda, "device", encoded=True)[4]
    cd = read("cpu", "device", encoded=True)[4]
    assert D.is_dict(gd) and torch.equal(gd.data.cpu(), cd.data)
    assert D._entries(D.dict_values(gd)) == D._entries(D.dict_values(cd))


# ---------------------------------------------------------------------------
# DECIMAL128: kernel H2, and B1-B3 over decimal columns
# ---------------------------------------------------------------------------

def test_h2_edge_table_matches_plain(cuda):
    """H2 == its plain version, bit for bit (limbs, overflow, validity),
    on every case of the edge table; every case launches once."""
    from spark_rapids_jni_tpu_torch.ops import decimal128 as D
    for op, a, b, scale, cast in datagen.decimal128_edge_cases(512, 3,
                                                               cuda):
        kw = {"cast_interim_result": cast} if op == "multiply" else {}
        fn = getattr(D, f"{op}_decimal128")
        args = (a, b) if op == "integer_divide" else (a, b, scale)
        before = K.decimal128_op.launches
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert K.decimal128_op.launches == before + 1, op
        cpu = lambda c: Column(c.dtype, c.size, data=c.data.cpu(),
                               validity=None if c.validity is None
                               else c.validity.cpu())
        want = fn(*((cpu(a), cpu(b)) + args[2:]), **kw)
        for g, w in zip(got.columns, want.columns):
            assert g.dtype == w.dtype, (op, scale)
            assert torch.equal(g.data.cpu(), w.data), (op, scale, cast)
            assert torch.equal(g.valid_mask().cpu(), w.valid_mask()), op


@pytest.mark.parametrize("rows,seed", [(64, 0), (4096, 5)])
def test_h2_division_table_matches_plain(cuda, rows, seed):
    """H2 == its plain version, bit for bit (limbs, overflow, validity),
    on every case of the division table (every branch of the long
    division: datagen.decimal128_division_cases); every case launches
    once."""
    from spark_rapids_jni_tpu_torch.ops import decimal128 as D
    for op, a, b, scale, cast in datagen.decimal128_division_cases(
            rows, seed, cuda):
        kw = {"cast_interim_result": cast} if op == "multiply" else {}
        fn = getattr(D, f"{op}_decimal128")
        args = (a, b) if op == "integer_divide" else (a, b, scale)
        before = K.decimal128_op.launches
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert K.decimal128_op.launches == before + 1, op
        cpu = lambda c: Column(c.dtype, c.size, data=c.data.cpu(),
                               validity=None if c.validity is None
                               else c.validity.cpu())
        want = fn(*((cpu(a), cpu(b)) + args[2:]), **kw)
        for g, w in zip(got.columns, want.columns):
            assert g.dtype == w.dtype, (op, scale)
            assert torch.equal(g.data.cpu(), w.data), (op, scale, cast)
            assert torch.equal(g.valid_mask().cpu(), w.valid_mask()), op


def test_h2_literal_operand_and_raise(cuda):
    """A stride-0 literal operand (Spark's 1 - l_discount) reads one row;
    a multiply whose rescale needs a power past 10^76 raises on the card
    as on the CPU."""
    from spark_rapids_jni_tpu_torch.columnar.column import decimal128_literal
    from spark_rapids_jni_tpu_torch.ops import decimal128 as D
    disc = datagen.decimal128_column(list(range(11)) * 3, 2, device=cuda)
    one = decimal128_literal("1.00", 2, disc.size, cuda)
    assert one.data.stride(0) == 0
    got = D.sub_decimal128(one, disc, 2)[1].to_pylist()
    assert [int(v * 100) for v in got] == [100 - v for v in
                                           list(range(11)) * 3]
    # 10^67 at scale -20 to scale 38: 10^(58 + 29) after the interim cast
    big = datagen.decimal128_column([10 ** 37, 1], -10, device=cuda)
    tiny = datagen.decimal128_column([10 ** 30, 1], -10, device=cuda)
    for dev in (cuda, torch.device("cpu")):
        x = Column(big.dtype, 2, data=big.data.to(dev))
        y = Column(tiny.dtype, 2, data=tiny.data.to(dev))
        with pytest.raises(ValueError, match="pow10"):
            D.multiply_decimal128(x, y, 38)
            torch.cuda.synchronize()


@pytest.mark.parametrize("algo", ["murmur3", "xxhash64"])
def test_decimal128_hashes_match_plain(cuda, algo):
    """B1/B2 over a DECIMAL128 column (its Java bytes as a "str" entry)
    among fixed-width columns == the plain versions."""
    rng = np.random.default_rng(5)
    n = 20_011
    d = datagen.decimal128_column(datagen.decimal128_draws(n, rng), 2,
                                  rng.random(n) > 0.1, device=cuda)
    k = Column.from_numpy(rng.integers(-2**62, 2**62, n), dt.INT64,
                          device=cuda)
    xx = algo == "xxhash64"
    fn = H.xxhash64 if xx else H.murmur_hash3_32
    plain = K.xxhash64_fixed_rows_plain if xx else \
        K.murmur3_fixed_rows_plain
    wrapper = K.xxhash64_fixed_rows if xx else K.murmur3_fixed_rows
    for cols in ([d], [k, d], [d, k]):
        before = wrapper.launches
        got = fn(cols).data
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        schema = [(("str", H.dec128_hash_words(c))
                   if c.dtype.id is dt.TypeId.DECIMAL128 else
                   H._fixed_element_words(c.dtype, c.data, xx))
                  + (c.validity,) for c in cols]
        assert torch.equal(got, plain(schema, 42, n))


def test_decimal128_rows_round_trip(cuda):
    """B3 writes a DECIMAL128 column's 16-byte JCUDF slot from its four
    limb lanes; convert_from_rows gives the table back, bit for bit, and
    the rows equal the CPU's."""
    rng = np.random.default_rng(6)
    n = 30_007
    d = datagen.decimal128_column(datagen.decimal128_draws(n, rng), 4,
                                  rng.random(n) > 0.1, device=cuda)
    t = Table((Column.from_numpy(rng.integers(0, 100, n).astype(np.int32),
                                 device=cuda), d,
               Column.from_numpy(rng.standard_normal(n), device=cuda)))
    before = K.rowconv_fixed_words.launches
    rows = R.convert_to_rows(t)
    assert K.rowconv_fixed_words.launches == before + 1
    cpu_t = Table(tuple(Column(c.dtype, c.size, data=c.data.cpu(),
                               validity=None if c.validity is None
                               else c.validity.cpu()) for c in t.columns))
    cpu_rows = R.convert_to_rows(cpu_t)
    assert torch.equal(rows[0].children[0].data.cpu(),
                       cpu_rows[0].children[0].data)
    back = R.convert_from_rows(rows[0], [c.dtype for c in t.columns])
    for a, b in zip(back.columns, t.columns):
        assert torch.equal(a.data, b.data)
        assert torch.equal(a.valid_mask(), b.valid_mask())


def _on(cols, device):
    return [Column(c.dtype, c.size, data=c.data.to(device),
                   validity=None if c.validity is None
                   else c.validity.to(device),
                   offsets=None if c.offsets is None
                   else c.offsets.to(device)) for c in cols]


def _same(a, b):
    """Same value bytes (NaN payloads too), validity bits and (a
    STRING's) offsets."""
    return (torch.equal(a.data.cpu().contiguous().view(torch.uint8),
                        b.data.cpu().contiguous().view(torch.uint8))
            and torch.equal(a.valid_mask().cpu(), b.valid_mask().cpu())
            and (a.offsets is None) == (b.offsets is None)
            and (a.offsets is None
                 or torch.equal(a.offsets.cpu(), b.offsets.cpu())))


def test_bloom_filter_on_card_equals_plain(cuda):
    """Put, merge and probe on the card (h1, h2 from kernel B1) give the
    bytes and probes of the plain version on the CPU."""
    from spark_rapids_jni_tpu_torch.ops import bloom_filter as B
    rng = np.random.default_rng(21)
    keys = rng.integers(-2**63, 2**63 - 1, 200_003)
    valid = rng.random(keys.size) > 0.05
    out = {}
    for dev in ("cpu", cuda):
        col = Column.from_numpy(keys, dt.INT64, validity=valid, device=dev)
        half = keys.size // 2
        parts = [B.bloom_filter_put(B.bloom_filter_create(5, 4096, dev),
                                    Column(dt.INT64, n, data=col.data[s],
                                           validity=col.validity[s]))
                 for s, n in ((slice(0, half), half),
                              (slice(half, None), keys.size - half))]
        before = K.murmur3_fixed_rows.launches
        bf = B.bloom_filter_merge(parts)
        probe = Column.from_numpy(keys[::-1].copy(), dt.INT64, device=dev)
        out[str(dev)] = (B.serialize(bf), B.bloom_filter_probe(probe, bf))
        if dev is cuda:
            assert K.murmur3_fixed_rows.launches == before + 2
    assert out["cpu"][0] == out[str(cuda)][0]
    assert _same(out["cpu"][1], out[str(cuda)][1])


def test_full_join_on_card_equals_cpu(cuda):
    from spark_rapids_jni_tpu_torch.ops.join import full_join
    rng = np.random.default_rng(22)
    lk = Column.from_numpy(rng.integers(0, 5000, 100_000), dt.INT64,
                           validity=rng.random(100_000) > 0.05, device="cpu")
    rk = Column.from_numpy(rng.integers(2500, 9000, 40_000), dt.INT64,
                           device="cpu")
    want = full_join([lk], [rk])
    got = full_join(_on([lk], cuda), _on([rk], cuda))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_donated_q1_on_card_equals_undonated(cuda):
    li = tpch.generate_q1_lineitem(1 << 20, 3, device=cuda)
    want = tpch.run_q1(li)
    from spark_rapids_jni_tpu_torch.plan import execute_plan
    donor = Table(tuple(li.columns))
    got = execute_plan(tpch._q1_plan(2400), donor, donate_input=True)
    assert donor.is_donated
    for a, b in zip(want.columns, got.columns):
        assert _same(a, b)
    with pytest.raises(RuntimeError, match="donated"):
        donor.columns


def test_hilbert_rebase_timezones_on_card_equal_cpu(cuda):
    from spark_rapids_jni_tpu_torch.ops import datetime_rebase as DR
    from spark_rapids_jni_tpu_torch.ops import timezones as TZ
    from spark_rapids_jni_tpu_torch.ops.zorder import hilbert_index
    rng = np.random.default_rng(23)
    n = 300_001
    ints = [Column.from_numpy(rng.integers(-2**31, 2**31, n).astype(
        np.int32), dt.INT32, validity=rng.random(n) > 0.05, device="cpu")
        for _ in range(3)]
    assert _same(hilbert_index(21, ints), hilbert_index(21, _on(ints, cuda)))
    days = Column.from_numpy(rng.integers(-719162, 47846, n).astype(
        np.int32), dt.DType(dt.TypeId.TIMESTAMP_DAYS), device="cpu")
    micros = Column.from_numpy(rng.integers(-62135596800, 4133980800, n)
                               * 1_000_000,
                               dt.DType(dt.TypeId.TIMESTAMP_MICROSECONDS),
                               device="cpu")
    table = TZ.make_transition_table(
        [[(TZ.INT64_MIN, TZ.INT64_MIN, 21200), (-2000000000, -1999978800,
                                                19800)]], ["Z"])
    for col in (days, micros):
        for fn in (DR.rebase_gregorian_to_julian,
                   DR.rebase_julian_to_gregorian):
            assert _same(fn(col), fn(_on([col], cuda)[0]))
    for fn in (TZ.convert_timestamp_to_utc,
               TZ.convert_utc_timestamp_to_timezone):
        assert _same(fn(micros, table, 0), fn(_on([micros], cuda)[0],
                                              table, 0))


def test_decimal_to_string_on_card_equals_cpu(cuda):
    from spark_rapids_jni_tpu_torch.ops.decimal_to_string import \
        decimal_to_string
    rng = np.random.default_rng(24)
    limbs = datagen.decimal128_limbs(rng.integers(-10**12, 10**12, 10_000))
    col = Column.from_numpy(limbs, dt.decimal128(2), device="cpu")
    want = decimal_to_string(col)
    got = decimal_to_string(Column(col.dtype, col.size,
                                   data=col.data.to(cuda)))
    assert got.data.device.type == "cuda"
    assert torch.equal(got.data.cpu(), want.data)
    assert torch.equal(got.offsets.cpu(), want.offsets)


def _strings_cpu(strs, validity=None):
    return Column.from_pylist([s if validity is None or validity[i] else None
                               for i, s in enumerate(strs)], dt.STRING,
                              device="cpu")


def _cast_strings(n, seed):
    """Integer, decimal and float strings with signs, exponents, padding,
    junk and nulls."""
    rng = np.random.default_rng(seed)
    words = ["42", "-7", " 12 ", "bogus", "1.5", "99999999999", "", "+3",
             "1e3", "-0.25", "21168.23", "0.04", "NaN", "-Infinity", "1.0f",
             "4.9e-324", "1e-40", "18446744073709551615", "-1.0E14",
             "123456789012345678901234567890123456.01"]
    strs = [words[i] for i in rng.integers(0, len(words), n)]
    vals = rng.standard_normal(n) * 10.0 ** rng.integers(-30, 30, n)
    strs = [s if i % 3 else f"{v:.17g}" for i, (s, v) in enumerate(
        zip(strs, vals))]
    return _strings_cpu(strs, rng.random(n) > 0.05)


@pytest.mark.parametrize("t", ["INT8", "INT32", "UINT64", "INT64"])
def test_string_to_integer_on_card_equals_cpu(cuda, t):
    from spark_rapids_jni_tpu_torch.ops import cast_string as CS
    col = _cast_strings(50_001, 31)
    assert _same(CS.string_to_integer(col, getattr(dt, t)),
                 CS.string_to_integer(_on([col], cuda)[0], getattr(dt, t)))


@pytest.mark.parametrize("precision,scale", [(5, 0), (12, -2), (18, -9),
                                             (30, -4), (38, 2)])
def test_string_to_decimal_on_card_equals_cpu(cuda, precision, scale):
    from spark_rapids_jni_tpu_torch.ops import cast_string as CS
    col = _cast_strings(50_001, 32)
    assert _same(CS.string_to_decimal(col, precision, scale),
                 CS.string_to_decimal(_on([col], cuda)[0], precision, scale))


@pytest.mark.parametrize("t", ["FLOAT32", "FLOAT64"])
def test_string_to_float_on_card_equals_cpu(cuda, t):
    from spark_rapids_jni_tpu_torch.ops import cast_string as CS
    col = _cast_strings(50_001, 33)
    got = CS.string_to_float(_on([col], cuda)[0], getattr(dt, t))
    assert got.data.device.type == "cuda"
    assert _same(CS.string_to_float(col, getattr(dt, t)), got)


def test_float_to_string_and_base_casts_on_card_equal_cpu(cuda):
    from spark_rapids_jni_tpu_torch.ops import cast_float_to_string as CF
    from spark_rapids_jni_tpu_torch.ops import cast_string_base as CB
    rng = np.random.default_rng(34)
    n = 20_001
    bits = rng.integers(0, 2**63, n, dtype=np.int64)
    for vals, d in ((bits.view(np.float64), dt.FLOAT64),
                    (bits.astype(np.int32).view(np.float32), dt.FLOAT32)):
        col = Column.from_numpy(vals, d, validity=rng.random(n) > 0.1,
                                device="cpu")
        assert _same(CF.float_to_string(col),
                     CF.float_to_string(_on([col], cuda)[0]))
        assert _same(CF.format_number(col, 3),
                     CF.format_number(_on([col], cuda)[0], 3))
    ints = Column.from_numpy(bits, dt.INT64, device="cpu")
    for base in (10, 16):
        want = CB.from_integers_with_base(ints, base)
        got = CB.from_integers_with_base(_on([ints], cuda)[0], base)
        assert _same(want, got)
        assert _same(CB.to_integers_with_base(want, base, dt.INT64),
                     CB.to_integers_with_base(got, base, dt.INT64))


def test_ansi_cast_on_card_raises_its_row(cuda):
    from spark_rapids_jni_tpu_torch.ops import cast_string as CS
    col = Column.from_pylist(["1", "2", None, "x3", "4y"], dt.STRING,
                             device=cuda)
    with pytest.raises(CS.CastException) as ei:
        CS.string_to_integer(col, dt.INT32, ansi_mode=True)
    assert (ei.value.row_number, ei.value.string_with_error) == (3, "x3")


def test_bridge_on_card_equals_cpu(cuda):
    """Every op the port's bridge runs (chip_smoke's cases at 20K rows),
    on the card and on the CPU: equal wire bytes and meta."""
    import json
    import chip_smoke
    from spark_rapids_jni_tpu_torch import bridge
    cases, wires = chip_smoke.bridge_cases(torch.device("cpu"), 20_000, 35)
    for op, args, names, _ in cases:
        ws = [wires[k] for k in names]
        want = bridge.call(op, json.dumps(args), ws, device="cpu")
        assert bridge.call(op, json.dumps(args), ws) == want, op


def _nested_hash_columns(n, device, seed=0):
    """A STRUCT key, LIST<INT64>, LIST<STRING> and LIST<LIST<INT32>> with
    nulls at every level, on ``device``."""
    rng = np.random.default_rng(seed)

    def offsets(k, most):
        lens = rng.integers(0, most + 1, k)
        return torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])
                                .astype(np.int32)).to(device)

    def valid(k):
        return torch.from_numpy(rng.random(k) > 0.1).to(device)

    o = offsets(n, 6)
    m = int(o[-1])
    leaf = Column.from_numpy(rng.integers(-2**62, 2**62, m), dt.INT64,
                             validity=rng.random(m) > 0.2, device=device)
    strs = Column.from_pylist([None if rng.random() < 0.2 else
                               "s" * int(rng.integers(0, 40))
                               for _ in range(m)], dt.STRING, device=device)
    inner = offsets(m, 3)
    ints = Column.from_numpy(rng.integers(-9, 9, int(inner[-1]))
                             .astype(np.int32), dt.INT32, device=device)
    key = Column.struct_of([
        Column.from_numpy(rng.integers(0, 10**6, n), dt.INT64,
                          validity=rng.random(n) > 0.1, device=device),
        Column.from_numpy(rng.integers(0, 2400, n).astype(np.int32),
                          dt.INT32, device=device)], valid(n))
    return [key, Column.list_of(leaf, o, valid(n)),
            Column.list_of(strs, o), Column.list_of(
                Column.list_of(ints, inner, valid(m)), o, valid(n))]


@pytest.mark.parametrize("n", [1, 33, 20_000])
def test_nested_murmur3_on_card_equals_cpu(cuda, n):
    """B1's LIST entries (u64, byte and u32 leaves, composed LIST<LIST>)
    and a flattened STRUCT, one launch, == the plain version on the
    CPU."""
    K.reset_launches()
    got = H.murmur_hash3_32(_nested_hash_columns(n, cuda))
    assert K.murmur3_fixed_rows.launches == 1
    want = H.murmur_hash3_32(_nested_hash_columns(n, "cpu"))
    assert torch.equal(got.data.cpu(), want.data)


@pytest.mark.parametrize("algo", ["murmur3", "xxhash64", "strings"])
def test_hash_past_64_units_takes_seeded_launches(cuda, algo):
    """130 units: three launches, each seeded per row by the last, ==
    the plain version ("strings": xxhash64 with a STRING entry in each
    launch, B2's staged kernel)."""
    rng = np.random.default_rng(5)
    n = 5000
    schema = [("u32" if i % 2 else "u64",
               torch.from_numpy(rng.integers(-99, 99, n).astype(
                   np.int32 if i % 2 else np.int64)).to(cuda),
               torch.from_numpy(rng.random(n) > 0.1).to(cuda))
              for i in range(130)]
    if algo == "strings":
        s = Column.from_pylist(["x" * int(k) for k in
                                rng.integers(0, 70, n)], dt.STRING,
                               device=cuda)
        for at in (3, 70, 129):
            schema[at] = ("str", (s.offsets, s.data), schema[at][2])
    fn = K.murmur3_fixed_rows if algo == "murmur3" else K.xxhash64_fixed_rows
    plain = (K.murmur3_fixed_rows_plain if algo == "murmur3"
             else K.xxhash64_fixed_rows_plain)
    K.reset_launches()
    got = fn(schema, 42, n)
    assert fn.launches == 3
    assert torch.equal(got, plain(schema, 42, n))


def test_b2_refuses_a_list_entry_on_card(cuda):
    s = torch.zeros(4, dtype=torch.int32, device=cuda)
    leaf = torch.zeros(0, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="no LIST schema entry"):
        K.xxhash64_fixed_rows([("list", (s, s, "u64", leaf, None), None)],
                              42, 4)


def test_nested_ops_on_card_equal_cpu(cuda):
    """Gather, concat, histograms, percentiles and interleave_bits of
    nested columns on the card == on the CPU."""
    from spark_rapids_jni_tpu_torch.columnar.table_ops import concat_columns
    from spark_rapids_jni_tpu_torch.ops import histogram as HI
    from spark_rapids_jni_tpu_torch.ops.sort import gather
    from spark_rapids_jni_tpu_torch.ops.zorder import interleave_bits
    out = {}
    for d in ("cpu", cuda):
        cols = _nested_hash_columns(3000, d, seed=9)
        idx = torch.from_numpy(np.random.default_rng(1).integers(
            0, 3000, 5000)).to(d)
        lst = cols[3]
        g = gather(lst, idx)
        c = concat_columns([cols[0], gather(cols[0], idx)])
        leaf = cols[1].children[0]
        freq = Column(dt.INT64, leaf.size, data=torch.ones(
            leaf.size, dtype=torch.int64, device=d))
        h = HI.create_histogram_if_valid(leaf, freq, False)
        hist = Column.list_of(Column.struct_of(
            [Column(dt.INT64, leaf.size, data=leaf.data), freq]),
            cols[1].offsets, cols[1].validity)
        p = HI.percentile_from_histogram(hist, [0.1, 0.5, 0.9], True)
        z = interleave_bits([Column(dt.INT32, 3000, data=(
            idx[:3000] * 7919).to(torch.int32)), cols[0].children[1]])
        out[str(d)] = [x.to_pylist() for x in (g, c, h, p, z)]
    assert out["cpu"] == out[str(cuda)]


def test_nested_parquet_on_card_equals_cpu(cuda, tmp_path):
    """The writer's nested layouts read on the card (the LIST<INT64>
    through the device tier) == read on the CPU."""
    import chip_smoke
    from spark_rapids_jni_tpu_torch.parquet.reader import ParquetReader
    from spark_rapids_jni_tpu_torch.utils import datagen_parquet as W
    o = chip_smoke.nested_orders_arrays(40_000, torch.device("cpu"))
    path = str(tmp_path / "orders.parquet")
    W.write_parquet(path, chip_smoke.nested_orders_columns(o),
                    page_rows=2000, row_group_rows=3000)
    with ParquetReader(path, device=cuda) as r:
        card = r.read_all()
        assert r.routes["o_linekeys"]["tier"] == "device"
    with ParquetReader(path, device="cpu") as r:
        host = r.read_all()
    for a, b in zip(card, host):
        assert a.to_pylist() == b.to_pylist()


def _string_tier_results(col_u, col_d):
    """parse_url's three parts, four get_json_object paths and a wildcard,
    and from_json's raw map of a URL and a document column, under the
    tier keys as they stand."""
    from spark_rapids_jni_tpu_torch.ops import get_json_object as G
    from spark_rapids_jni_tpu_torch.ops import map_utils as M
    from spark_rapids_jni_tpu_torch.ops import parse_uri as P
    out = [P.parse_uri_to_protocol(col_u), P.parse_uri_to_host(col_u),
           P.parse_uri_to_query(col_u),
           P.parse_uri_to_query_with_literal(col_u, "utm_source")]
    out += [G.get_json_object(col_d, p) for p in (
        "$.user.id", "$.event.items[0].sku", "$.ts", "$.tags[1]",
        "$.event.items[*].sku")]
    m = M.extract_raw_map_from_json_string(col_d)
    return out + [m, m.children[0].children[0], m.children[0].children[1]]


def _same_bytes(a, b):
    """Equal offsets, validity bits and characters (a LIST: its offsets
    and validity)."""
    pairs = [(a.offsets, b.offsets), (a.valid_mask(), b.valid_mask())]
    if a.data is not None:
        pairs.append((a.data, b.data))
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in pairs)


def test_string_tiers_on_card_equal_cpu(cuda):
    """The string device tiers under ``auto`` on the card (the device tier
    for a CUDA column, its rows counted) == the device tier forced on the
    CPU == the host tier, over weblog rows, bit for bit."""
    from spark_rapids_jni_tpu_torch.utils import config
    from spark_rapids_jni_tpu_torch.utils.backend import string_routes
    got = {}
    for d in ("cpu", cuda):
        col_u = datagen.weblog_urls(20_000, seed=2, device=d)[0]
        col_d = datagen.weblog_docs(20_000, seed=2, device=d)[0]
        string_routes.reset()
        if d == "cpu":
            with config.override("parse_uri.tier", "device"), \
                    config.override("get_json.tier", "device"), \
                    config.override("from_json.tier", "device"):
                got["device_cpu"] = _string_tier_results(col_u, col_d)
            got["host"] = _string_tier_results(col_u, col_d)
        else:
            got["card"] = _string_tier_results(col_u, col_d)
            snap = string_routes.snapshot()
            assert snap["parse_uri_device"] == 3 * 20_000
            assert snap["get_json_device"] == 4 * 20_000
            assert snap["get_json_host_path"] == 20_000
            assert snap["from_json_device"] == 20_000
            assert snap["get_json_host_by_config"] == 0
    for k, (a, b, c) in enumerate(zip(got["host"], got["device_cpu"],
                                      got["card"])):
        assert _same_bytes(a, b) and _same_bytes(b, c), k


# ---------------------------------------------------------------------------
# the task executor: one CUDA stream per task (parallel/task_executor.py)
# ---------------------------------------------------------------------------

SLEEP_CYCLES = 1_000_000_000  # torch.cuda._sleep: ~0.5 s of queued work


def test_two_tasks_get_distinct_streams_current_in_their_threads(cuda):
    from spark_rapids_jni_tpu_torch.parallel import TaskExecutor

    def current():
        return torch.cuda.current_stream().cuda_stream

    with TaskExecutor(device=cuda) as ex:
        got = {t: ex.submit(t, current).result(timeout=60) for t in (1, 2)}
        want = {t: s.cuda_stream for t, s in ex.task_streams().items()}
    assert got == want
    assert len(set(got.values())) == 2
    assert torch.cuda.current_stream().cuda_stream not in got.values()


def test_a_result_resolves_after_its_stream_and_the_submitter_waits_not(
        cuda):
    """The submitter's own stream is free while the task's stream still
    works; the future resolves only once the task's stream has finished,
    and the result then reads right on the submitter's stream."""
    from spark_rapids_jni_tpu_torch.parallel import TaskExecutor
    x = torch.arange(1 << 20, device=cuda, dtype=torch.int64)

    def body(t):
        torch.cuda._sleep(SLEEP_CYCLES)
        return t * 3

    with TaskExecutor(device=cuda) as ex:
        fut = ex.submit(1, body, x)
        y = x + 1
        torch.cuda.current_stream().synchronize()
        assert not fut.done()  # the task's stream still sleeps
        out = fut.result(timeout=60)
        assert ex.task_streams()[1].query()
        assert torch.equal(out, x * 3) and torch.equal(y, x + 1)


def test_inputs_and_outputs_survive_reallocation_across_streams(cuda):
    """A freed input re-allocated at once on the submitter's stream does
    not corrupt the task that still reads it; a result the submitter frees
    while its stream still reads it is not handed to the task's next
    allocation."""
    from spark_rapids_jni_tpu_torch.parallel import TaskExecutor
    n = 1 << 24

    def late_double(t):
        torch.cuda._sleep(SLEEP_CYCLES)
        return t * 2

    def scribble():
        return torch.full((n,), -7, dtype=torch.int64, device=cuda)

    with TaskExecutor(device=cuda) as ex:
        x = torch.ones(n, dtype=torch.int64, device=cuda)
        fut = ex.submit(1, late_double, x)
        del x
        junk = torch.full((n,), 5, dtype=torch.int64, device=cuda)
        out = fut.result(timeout=60)
        assert int(out.sum()) == 2 * n
        del junk
        torch.cuda._sleep(SLEEP_CYCLES)  # the consumer's read, queued
        total = out.sum()
        del out
        again = ex.submit(1, scribble).result(timeout=60)
        assert int(total) == 2 * n
        assert int(again.sum()) == -7 * n


def test_launch_counts_are_exact_under_four_task_threads(cuda):
    from spark_rapids_jni_tpu_torch.parallel import TaskExecutor
    t = _mixed(1 << 12, cuda, nulls=False)
    calls = 200

    def hashes():
        for _ in range(calls):
            H.murmur_hash3_32(t)

    K.reset_launches()
    with TaskExecutor(device=cuda) as ex:
        for f in [ex.submit(k, hashes) for k in range(4)]:
            f.result(timeout=120)
    assert K.murmur3_fixed_rows.launches == 4 * calls


def test_hbm_bracket_end_waits_only_on_its_own_stream(cuda, task_thread):
    """The audit's bracket drains the bracketed thread's stream alone: a
    task stream that still sleeps stays busy."""
    from spark_rapids_jni_tpu_torch.memory import hbm
    from spark_rapids_jni_tpu_torch.ops.sort import sort_table
    from spark_rapids_jni_tpu_torch.utils import config
    other = torch.cuda.Stream(cuda)
    t = _mixed(1 << 16, cuda)
    torch.cuda.synchronize()
    with torch.cuda.stream(other):
        torch.cuda._sleep(SLEEP_CYCLES)
    hbm.reset()
    with config.override("rmm.validate_hbm", True):
        sort_table(t, [0, 1])
    assert hbm.report()["validated"] == 1
    assert not other.query()
    other.synchronize()
    hbm.reset()


def test_a_task_read_runs_on_the_task_stream_alone(cuda, tmp_path):
    """A Parquet read inside a task: every kernel and copy of it is on one
    stream, the task's. The decode pool's threads (default stream) do
    host work only; the ship to the device runs in the task's thread."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_jni_tpu_torch.parallel import TaskExecutor
    from spark_rapids_jni_tpu_torch.parquet import read_parquet
    from spark_rapids_jni_tpu_torch.utils import datagen_parquet as W
    rng = np.random.default_rng(4)
    path = str(tmp_path / "task.parquet")
    W.write_parquet(path, [
        W.ParquetColumn("k", values=rng.integers(0, 1 << 40, 200_000)),
        W.ParquetColumn("d", values=rng.integers(0, 2400, 200_000)
                        .astype(np.int32))], row_group_rows=50_000)
    with TaskExecutor(device=cuda) as ex:
        ex.submit(1, read_parquet, path, device=cuda).result(timeout=120)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            table = ex.submit(1, read_parquet, path,
                              device=cuda).result(timeout=120)
            torch.cuda.synchronize()
    streams = {e.device_resource_id for e in prof.events()
               if e.device_type == DeviceType.CUDA}
    assert len(streams) == 1, streams
    assert table.num_rows == 200_000


def test_a_spill_from_another_task_waits_for_the_writing_stream(cuda):
    """Task A registers a table its stream is still writing; task B's
    rollback spills the store at once, on B's stream: the copy waits for
    A's stream (the event recorded at register), so the host bytes are
    the table's."""
    import threading
    from spark_rapids_jni_tpu_torch.memory.transport import SpillStore
    from spark_rapids_jni_tpu_torch.parallel import TaskExecutor
    n = 1 << 22
    store, registered = SpillStore(), threading.Event()

    def write():
        torch.cuda._sleep(SLEEP_CYCLES)
        col = Column(dt.INT64, n, data=torch.arange(n, device=cuda))
        st = store.register(Table((col,)))
        registered.set()
        return st

    def spill():
        registered.wait(timeout=60)
        store.spill_all()

    with TaskExecutor(device=cuda) as ex:
        fa = ex.submit(1, write)
        ex.submit(2, spill).result(timeout=60)
        st = fa.result(timeout=60)
        assert st.is_spilled
        host = st._table.columns[0].data
        assert host.device.type == "cpu"
        assert torch.equal(host, torch.arange(n))
