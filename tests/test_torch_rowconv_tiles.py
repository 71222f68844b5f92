"""Kernel B3's tile plan and metadata (spark_rapids_jni_tpu_torch.ops.kernels
``rowconv_tile_plan``, ``rowconv_meta``), on the CPU.

The plan is checked on random schemas of 1-2000 fixed-width columns: R is a
positive multiple of 32, the windows are even-word aligned and cover the
row, every piece falls in exactly one window, and every window's staged
bytes fit the budget. The metadata is checked by executing it: a NumPy
model of csrc/rowconv.cu (stage each slice at its address % 16, then OR the
pair pieces) must give the plain version's words bit for bit."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from spark_rapids_jni_tpu_torch.columnar import dtype as dt
from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
from spark_rapids_jni_tpu_torch.ops import kernels as K
from spark_rapids_jni_tpu_torch.ops import row_conversion as R

_TYPES = [(dt.INT8, np.int8), (dt.BOOL8, np.uint8), (dt.INT16, np.int16),
          (dt.UINT16, np.uint16), (dt.INT32, np.int32),
          (dt.FLOAT32, np.float32), (dt.INT64, np.int64),
          (dt.FLOAT64, np.float64), (dt.UINT64, np.uint64)]


def _table(kinds, nullable, n, seed=0):
    rng = np.random.default_rng(seed)
    cols = []
    for k, null in zip(kinds, nullable):
        d, npt = _TYPES[k]
        vals = rng.integers(0, 256, n * np.dtype(npt).itemsize,
                            dtype=np.uint8).view(npt)
        v = rng.random(n) > 0.3 if null else None
        cols.append(Column.from_numpy(vals, d, validity=v, device="cpu"))
    return Table(tuple(cols))


def _plan_args(table):
    info = R.compute_column_information([c.dtype for c in table])
    cols, valids, plan = R._word_plan(table, info)
    nwords = R._round_up(info.size_per_row, 8) // 4
    return cols, valids, plan, nwords


def _check_tiles(tiles, plan, sizes, has_valid, nwords, budget=None):
    assert tiles.rows > 0 and tiles.rows % 32 == 0
    bounds = [(w.word0, w.word1) for w in tiles.windows]
    assert bounds[0][0] == 0 and bounds[-1][1] == nwords
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0
    for w in tiles.windows:
        assert w.word0 % 2 == 0 and w.word1 % 2 == 0 and w.word0 < w.word1
        staged = sum(tiles.rows * (1 if v else sizes[c]) + K.SLOT_PAD
                     for c, v in w.slots)
        assert staged == w.stage_bytes <= tiles.stage_budget
    assert tiles.stage_budget <= (budget or K.STAGE_BUDGET)
    assert K._table_bytes(nwords // 2, len(tiles.windows), len(plan)) \
        + K.STAGES * tiles.stage_budget + K.OUT_BUDGET \
        <= K.SMEM_PER_BLOCK
    assert 0 < tiles.out_rows <= tiles.rows and tiles.out_rows % 32 == 0
    assert tiles.out_bytes <= K.OUT_BUDGET
    for word, c, part, _ in plan:
        hits = [w for w in tiles.windows if w.word0 <= word < w.word1]
        assert len(hits) == 1
        valid = part == K.PART_VALID
        if not valid or has_valid[c]:
            assert (c, valid) in hits[0].slots


def _schemas(max_cols):
    """(type index, nullable) of 1..max_cols columns."""
    return st.integers(1, max_cols).flatmap(lambda ncols: st.tuples(
        st.lists(st.integers(0, len(_TYPES) - 1), min_size=ncols,
                 max_size=ncols),
        st.lists(st.booleans(), min_size=ncols, max_size=ncols)))


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(_schemas(2000))
def test_tile_plan_random_schemas(schema):
    kinds, nullable = schema
    table = _table(kinds, nullable, 1)
    cols, valids, plan, nwords = _plan_args(table)
    sizes = [c.element_size() for c in cols]
    has_valid = [v is not None for v in valids]
    _check_tiles(K.rowconv_tile_plan(plan, sizes, has_valid, nwords), plan,
                 sizes, has_valid, nwords)


@settings(max_examples=30, deadline=None)
@given(_schemas(64),
       st.sampled_from([2048, 8192, 32768]))
def test_tile_plan_small_budgets(schema, budget):
    """A small stage budget splits even narrow rows into windows."""
    kinds, nullable = schema
    cols, valids, plan, nwords = _plan_args(_table(kinds, nullable, 1))
    sizes = [c.element_size() for c in cols]
    has_valid = [v is not None for v in valids]
    tiles = K.rowconv_tile_plan(plan, sizes, has_valid, nwords, budget)
    _check_tiles(tiles, plan, sizes, has_valid, nwords, budget)


def test_tile_plan_lineitem_is_one_window():
    """lineitem (int64, int32, int64, int32; 32-byte rows, 24 input bytes
    a row): one window over the whole row, R = 1024."""
    table = _table([6, 4, 6, 4], [False] * 4, 1)
    cols, valids, plan, nwords = _plan_args(table)
    tiles = K.rowconv_tile_plan(plan, [c.element_size() for c in cols],
                                [False] * 4, nwords)
    assert nwords == 8 and tiles.rows == K.TILE_ROWS_MAX
    assert [(w.word0, w.word1) for w in tiles.windows] == [(0, 8)]
    assert tiles.windows[0].slots == ((0, False), (1, False), (2, False),
                                      (3, False))


def test_tile_plan_wide_schema_splits_rows():
    """600 mixed columns, a third nullable: several windows at R = 256."""
    kinds = [i % len(_TYPES) for i in range(600)]
    table = _table(kinds, [i % 3 == 0 for i in range(600)], 1)
    cols, valids, plan, nwords = _plan_args(table)
    sizes = [c.element_size() for c in cols]
    has_valid = [v is not None for v in valids]
    tiles = K.rowconv_tile_plan(plan, sizes, has_valid, nwords)
    assert tiles.rows == K.TILE_ROWS_WIDE and len(tiles.windows) > 1
    _check_tiles(tiles, plan, sizes, has_valid, nwords)


def test_tile_plan_rejects_odd_words():
    with pytest.raises(ValueError, match="nwords must be even"):
        K.rowconv_tile_plan([(0, 0, K.PART_U32, 0)], [4], [False], 3)


def test_layout_rejects_pieces_that_do_not_fit():
    with pytest.raises(ValueError, match="does not fit"):  # 8-byte read
        K.rowconv_layout(((0, 0, K.PART_LO, 0),), (4,), (False,),
                         ((0, 0),), 2)
    with pytest.raises(ValueError, match="does not fit"):  # past the row
        K.rowconv_layout(((2, 0, K.PART_U32, 0),), (4,), (False,),
                         ((0, 0),), 2)


def test_layout_is_cached_per_schema():
    """Two calls on one schema share the pointer-free metadata; only the
    slot pointers differ."""
    a, b = (_table([6, 4, 0], [True, False, True], 64, seed=s)
            for s in (0, 1))
    ma, la = K.rowconv_meta(*_plan_args(a)[:3], _plan_args(a)[3])
    mb, lb = K.rowconv_meta(*_plan_args(b)[:3], _plan_args(b)[3])
    assert la is lb and ma[len(la.slots):] == mb[len(lb.slots):]
    assert ma[:len(la.slots)] != mb[:len(lb.slots)]


# ---------------------------------------------------------------------------
# The metadata, executed by a model of the kernel
# ---------------------------------------------------------------------------

def _model_kernel(cols, valids, plan, nwords, n, budget):
    """csrc/rowconv.cu in NumPy, reading only the metadata and the columns'
    bytes found at its pointers. Returns (words, tile plan)."""
    meta, lay = K.rowconv_meta(cols, valids, plan, nwords, budget)
    tiles, nslots, nwin = lay.tiles, len(lay.slots), lay.nwin
    npairs, npieces, stage_bytes = lay.npairs, lay.npieces, lay.stage_bytes
    memory = {t.data_ptr(): t.numpy().view(np.uint8)
              for t in list(cols) + [v for v in valids if v is not None]}
    m = np.array(meta, dtype=np.int64)
    ptrs, info = m[:nslots], m[nslots:2 * nslots]
    win = m[2 * nslots:2 * nslots + 2 * nwin]
    base = 2 * nslots + 2 * nwin
    consts = m[base:base + npairs].view(np.uint64)
    first = m[base + npairs:base + 2 * npairs + 1]
    pieces = m[base + 2 * npairs + 1:]
    assert len(pieces) == npieces
    assert all(w.stage_bytes <= stage_bytes for w in tiles.windows)
    assert len(m) == 2 * nslots + 2 * nwin + 2 * npairs + 1 + npieces
    out = np.zeros((n, npairs), np.uint64)
    for row0 in range(0, n, tiles.rows):
        rt = min(tiles.rows, n - row0)
        for wi in range(nwin):
            p0, p1 = int(win[2 * wi]) & 0xFFFFFFFF, int(win[2 * wi]) >> 32
            s0, s1 = (int(win[2 * wi + 1]) & 0xFFFFFFFF,
                      int(win[2 * wi + 1]) >> 32)
            stage = np.zeros(stage_bytes, np.uint8)
            for s in range(s0, s1):
                off, nb = int(info[s]) & 0xFFFFFFFF, int(info[s]) >> 32
                at = off + int(ptrs[s]) % 16
                stage[at:at + rt * nb] = \
                    memory[int(ptrs[s])][row0 * nb:(row0 + rt) * nb]
            for p in range(p0, p1):
                acc = np.full(rt, consts[p], np.uint64)
                for pc in pieces[first[p]:first[p + 1]]:
                    off, part, sh = pc & 0x3FFFF, (pc >> 18) & 7, pc >> 21
                    nb = {K.PART_U8: 1, K.PART_U16: 2, K.PART_U32: 4,
                          K.PART_LO: 8, K.PART_HI: 8, K.PART_U64: 8,
                          K.PART_VALID: 1}[part]
                    raw = stage[off:off + rt * nb]
                    v = raw.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                                  8: np.uint64}[nb]).astype(np.uint64)
                    if part == K.PART_LO:
                        v &= np.uint64(0xFFFFFFFF)
                    elif part == K.PART_HI:
                        v >>= np.uint64(32)
                    elif part == K.PART_VALID:
                        v = (v != 0).astype(np.uint64)
                    acc |= v << np.uint64(sh)
                out[row0:row0 + rt, p] = acc
    return (torch.from_numpy(out.view(np.int32).reshape(n, nwords).copy()),
            tiles)


def _assert_model_matches(table, budget=None):
    cols, valids, plan, nwords = _plan_args(table)
    n = table.num_rows
    got, tiles = _model_kernel(cols, valids, plan, nwords, n, budget)
    assert torch.equal(got, K.rowconv_fixed_words_plain(cols, valids, plan,
                                                        nwords, n))
    return tiles


@pytest.mark.parametrize("kinds,nullable", [
    ([4], [True]),                       # 8-byte rows
    ([6, 6], [False, True]),             # 24-byte rows
    ([6, 4, 6, 4], [False] * 4),         # lineitem, 32-byte rows
    ([6, 7, 8, 6], [True] * 4),          # 40-byte rows
    ([0, 6, 2, 5, 1, 7, 4, 3, 0, 8, 4], [i % 3 > 0 for i in range(11)]),
])
@pytest.mark.parametrize("n", [1, 1000, 2100])
def test_meta_model_matches_plain(kinds, nullable, n):
    _assert_model_matches(_table(kinds, nullable, n, seed=n))


@pytest.mark.parametrize("validity", ["all_null", "no_null"])
def test_meta_model_validity_extremes(validity):
    t = _table([0, 6, 4], [True] * 3, 700)
    fill = torch.zeros if validity == "all_null" else torch.ones
    t = Table(tuple(c.with_validity(fill(700, dtype=torch.bool))
                    for c in t))
    _assert_model_matches(t)


def test_meta_model_misaligned_views():
    """Columns that start at element 1 or 3 of a larger column: their data
    pointers are not 16-byte aligned, and their slices land at the same
    offset % 16 in the stage."""
    base = _table([0, 2, 4, 6, 1], [True, False, True, False, False], 1003)
    cols = []
    for i, c in enumerate(base):
        start, n = (1 if i % 2 else 3), 1000
        v = None if c.validity is None else c.validity[start:start + n]
        cols.append(Column(c.dtype, n, data=c.data[start:start + n],
                           validity=v))
    t = Table(tuple(cols))
    assert any(c.data.data_ptr() % 16 for c in t)
    _assert_model_matches(t)


@pytest.mark.parametrize("budget", [1024, 4096])
def test_meta_model_multi_window(budget):
    """A small budget forces several windows (and R below 256): each row's
    window segment is assembled from its own stage."""
    kinds = [i % len(_TYPES) for i in range(40)]
    tiles = _assert_model_matches(
        _table(kinds, [i % 3 == 0 for i in range(40)], 333), budget)
    assert len(tiles.windows) > 1


def test_meta_merges_8_byte_elements():
    """An 8-byte element is one U64 piece (read once), not LO and HI."""
    t = _table([6, 8], [False, False], 5)
    cols, valids, plan, nwords = _plan_args(t)
    meta, lay = K.rowconv_meta(cols, valids, plan, nwords)
    parts = [(p >> 18) & 7 for p in meta[len(meta) - lay.npieces:]]
    assert parts == [K.PART_U64, K.PART_U64]
