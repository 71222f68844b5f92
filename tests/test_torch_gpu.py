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
from spark_rapids_jni_tpu_torch.parallel.exchange import partition_ids

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
