"""Port parity: float sum, mean, min and max (kernel H1's plain version on
the CPU) against the JAX package, bit for bit, through the eager groupby,
the fused plan engine's groupby core and the eager interpreter; and the
FLOAT32 subnormal keys the JAX package folds to +0.0 (ROADMAP C1).

The tables are the reference's own float-groupby cases
(tests/test_exec_ops.py) and seeded tables of NaN payloads, ±0, ±inf,
float32 and float64 subnormals, all-null and one-row groups, and masked
rows after a flushed -0.0 (``datagen.float_edge_table``, which builds the
same numpy draws for both packages). Every table of a test shares its row
count, so the JAX package compiles once per op.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import plan as JP
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.ops import groupby as JG
from spark_rapids_jni_tpu.ops import hashing as JH
from spark_rapids_jni_tpu.ops import join as JJ
from spark_rapids_jni_tpu.ops import sort as JS
from spark_rapids_jni_tpu.plan.compile import ProgramCache as JCache
from spark_rapids_jni_tpu_torch import plan as P
from spark_rapids_jni_tpu_torch.ops import groupby as G
from spark_rapids_jni_tpu_torch.ops import hashing as H
from spark_rapids_jni_tpu_torch.ops import join as J
from spark_rapids_jni_tpu_torch.ops import kernels as K
from spark_rapids_jni_tpu_torch.ops import sort as S
from spark_rapids_jni_tpu_torch.plan.compile import ProgramCache
from spark_rapids_jni_tpu_torch.utils import datagen

from torch_parity import assert_table_equal, plan_to_port, table_to_port

EDGE_ROWS = 512   # every table of the port's new parity tests


def _edge(seed):
    """The edge table of ``datagen.float_edge_table`` as a JAX table."""
    t = datagen.float_edge_table(EDGE_ROWS, seed, device="cpu")
    cols = []
    for c in t.columns:
        v = None if c.validity is None else c.validity.numpy()
        d = {"int32": jdt.INT32, "float64": jdt.FLOAT64,
             "float32": jdt.FLOAT32}[c.dtype.id.value]
        cols.append(JColumn.from_numpy(c.to_numpy(), d, validity=v))
    return JTable(tuple(cols))


AGGS = [(1, "sum"), (1, "mean"), (1, "min"), (1, "max"), (1, "count"),
        (2, "sum"), (2, "mean"), (2, "min"), (2, "max")]


# ---------------------------------------------------------------------------
# the reference's float-groupby cases (tests/test_exec_ops.py:192-245)
# ---------------------------------------------------------------------------

def _payload_nan():
    return np.frombuffer(np.uint64(0x7FF8000000000042).tobytes(),
                         np.float64)[0]


_REFERENCE_CASES = {
    # multi-key (STRING, INT32) groups summing FLOAT64
    "multi_key_strings_and_floats": lambda: (JTable((
        JColumn.from_pylist(["a", "b", "a", "a"], jdt.STRING),
        JColumn.from_pylist([1, 1, 2, 1], jdt.INT32),
        JColumn.from_pylist([1.5, 2.5, 3.5, 4.5], jdt.FLOAT64))),
        [0, 1], [(2, "sum")]),
    # float keys: zeros merge, NaNs of any payload merge
    "float_keys_spark_equality": lambda: (JTable((
        JColumn.from_pylist([0.0, -0.0, float("nan"), _payload_nan()],
                            jdt.FLOAT64),
        JColumn.from_pylist([1, 2, 4, 8], jdt.INT64))), [0], [(1, "sum")]),
    # FLOAT32 sums to FLOAT64
    "float32_sum_yields_double": lambda: (JTable((
        JColumn.from_pylist([1, 1, 2], jdt.INT32),
        JColumn.from_numpy(np.array([0.5, 0.25, 1.5], np.float32),
                           jdt.FLOAT32))), [0], [(1, "sum")]),
    # ... and so does an empty input
    "float32_sum_empty": lambda: (JTable((
        JColumn.from_pylist([], jdt.INT32),
        JColumn.from_pylist([], jdt.FLOAT32))), [0], [(1, "sum")]),
}


@pytest.mark.parametrize("case", sorted(_REFERENCE_CASES))
def test_reference_float_groupby_cases(case):
    jt, keys, aggs = _REFERENCE_CASES[case]()
    want = JG.groupby_aggregate(jt, keys, aggs)
    got = G.groupby_aggregate(table_to_port(jt), keys, aggs)
    assert_table_equal(want, got)
    assert got.columns[len(keys)].dtype.id.value == (
        "int64" if case == "float_keys_spark_equality" else "float64")


# ---------------------------------------------------------------------------
# seeded edge tables through every engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,masked", [(0, False), (1, True)])
def test_edge_groupby_aggregate_matches(seed, masked):
    jt = _edge(seed)
    mask = (np.random.default_rng(seed + 10).random(EDGE_ROWS) > 0.3
            if masked else None)
    want = JG.groupby_aggregate(jt, [0], AGGS, row_mask=mask)
    got = G.groupby_aggregate(
        table_to_port(jt), [0], AGGS,
        row_mask=None if mask is None else torch.from_numpy(mask))
    assert got.num_rows == want.num_rows > 20
    assert_table_equal(want, got)


def test_edge_plans_match():
    """A Filter pushed into the fused groupby core (dead rows add +0.0 in
    their sorted place), and the eager interpreter's groupby, each equal
    to the JAX package's fused result (which equals its eager one)."""
    jt = _edge(2)
    plan = JP.GroupBy(JP.Filter(JP.Scan(3), JP.col(0) < JP.lit(20)),
                      (0,), tuple(AGGS))
    pt = table_to_port(jt)
    want = JP.execute_plan(plan, jt, cache=JCache())
    P.plan_metrics.reset()
    fused = P.execute_plan(plan_to_port(plan), pt, cache=ProgramCache())
    snap = P.plan_metrics.snapshot()
    assert snap["plan_executes"] == 1 and snap["plan_fallbacks"] == 0
    assert fused.num_rows == want.num_rows > 10
    assert_table_equal(want, fused, presence=False)
    assert_table_equal(want, P.run_eager(plan_to_port(plan), pt),
                       presence=False)


def test_dict_key_float_aggregates():
    """Over a DICT32 key, float sum and mean decline the sort-free path
    (their order is the sorted path's, by ranks); min and max take it."""
    from spark_rapids_jni_tpu.columnar import dictionary as JD
    jt = _edge(3)
    keys = np.asarray(jt.columns[0].data) % 20
    jkey = JD.encode_strings(JColumn.from_pylist(
        [f"g{k:02d}" if k % 13 else None for k in keys], jdt.STRING))
    jt = JTable((jkey, jt.columns[1], jt.columns[2]))
    for aggs in (AGGS, [(1, "min"), (2, "max"), (2, "count")]):
        want = JG.groupby_aggregate(jt, [0], aggs)
        assert_table_equal(want, G.groupby_aggregate(table_to_port(jt), [0],
                                                     aggs))


# ---------------------------------------------------------------------------
# the plain version of H1 against the contract, row by row
# ---------------------------------------------------------------------------

def _x86_add(acc, x):
    """One step of the JAX package's sum on XLA:CPU, in Python."""
    def daz(b):
        return b & (1 << 63) if (b >> 52) & 0x7FF == 0 else b

    def nan(b):
        return (b & ((1 << 63) - 1)) > 0x7FF0000000000000
    x = daz(x)
    if nan(x):
        return x | 0x0008000000000000
    if nan(acc):
        return acc
    a, b = np.array([acc, x], np.uint64).view(np.float64)
    with np.errstate(all="ignore"):
        r = int(np.array([a + b]).view(np.uint64)[0])
    return 0xFFF8000000000000 if nan(r) else daz(r)


def test_plain_sum_steps_in_row_order():
    """Every segment's sum equals a Python fold of the contract: masked
    rows add +0.0 in their place (a -0.0 sum becomes +0.0)."""
    rng = np.random.default_rng(7)
    bits = datagen._F64_EDGE_BITS
    n = 400
    z = np.where(rng.random(n) < 0.5, bits[rng.integers(0, len(bits), n)],
                 (rng.standard_normal(n) * 1e-306).view(np.uint64))
    valid = rng.random(n) > 0.2
    starts = np.array([0, 0, 1, 2, 50, 51, 200, 399, 400])
    sums, _, _ = K.segment_float_agg_plain(
        torch.from_numpy(z.view(np.float64)), torch.from_numpy(valid),
        torch.from_numpy(starts))
    got = sums.view(torch.int64).numpy().view(np.uint64)
    for g in range(len(starts) - 1):
        acc = 0
        for i in range(starts[g], starts[g + 1]):
            acc = _x86_add(acc, int(z[i]) if valid[i] else 0)
        assert int(got[g]) == acc, g


# ---------------------------------------------------------------------------
# C1: FLOAT32 subnormal keys fold to +0.0
# ---------------------------------------------------------------------------

C1_KEYS = np.array([1e-45, 0.0, -1e-45, -0.0, 1e-40, 1.0], np.float32)


@pytest.mark.parametrize("op", ["xxhash64", "sort_order", "self_join",
                                "groupby"])
def test_c1_float32_subnormal_keys(op):
    jk = JColumn.from_numpy(C1_KEYS, jdt.FLOAT32)
    pk = table_to_port(JTable((jk,))).columns[0]
    if op == "xxhash64":
        want = np.asarray(JH.xxhash64(JTable((jk,))).data)
        got = H.xxhash64([pk]).data.numpy()
        assert (got[[0, 2, 4]] == 3614696996920510707).all()
    elif op == "sort_order":
        want = np.asarray(JS.sort_order([jk]))
        got = S.sort_order([pk]).numpy()
        assert got.tolist() == [0, 1, 2, 3, 4, 5]
    elif op == "self_join":
        want = np.stack([np.asarray(a) for a in JJ.inner_join([jk], [jk])])
        got = torch.stack(J.inner_join([pk], [pk])).numpy()
        assert got.shape[1] == 26
    else:
        jt = JTable((jk, JColumn.from_numpy(np.ones(6, np.int64))))
        want = np.asarray(JG.groupby_aggregate(jt, [0], [(1, "count")])
                          .columns[1].data)
        got = G.groupby_aggregate(table_to_port(jt), [0], [(1, "count")]
                                  ).columns[1].data.numpy()
        assert got.tolist() == [5, 1]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# H1's flush rule: plain adds for a chunk with no tiny input, the flush
# after every add for a chunk with one (csrc/segment_agg.cu)
# ---------------------------------------------------------------------------

def _subnormal_table(seed):
    """``datagen.subnormal_sum_table`` as a JAX table and a port table."""
    t = datagen.subnormal_sum_table(seed=seed, device="cpu")
    jt = JTable((JColumn.from_numpy(t[0].to_numpy(), jdt.INT32),
                 JColumn.from_numpy(t[1].to_numpy(), jdt.FLOAT64,
                                    validity=t[1].validity.numpy())))
    return jt, t


def test_subnormal_partial_sums_match_reference():
    """Groups whose sums pass through subnormal partial sums (at a group's
    first row, across 32- and 256-row boundaries, at its last row; back to
    a normal, back to ±0, or subnormal to the end) equal the JAX package's
    flushed sums bit for bit."""
    jt, t = _subnormal_table(0)
    aggs = [(1, "sum"), (1, "mean"), (1, "count")]
    want = JG.groupby_aggregate(jt, [0], aggs)
    got = G.groupby_aggregate(t, [0], aggs)
    assert got.num_rows == want.num_rows == 72
    assert_table_equal(want, got)


def _flushed_fold(x, tiny_rule):
    """Python fold of flushed f64 bits ``x``: chunks of H1_CHUNK_ROWS rows;
    a chunk folds with plain IEEE adds (numpy keeps subnormals) unless
    ``tiny_rule`` says it holds a tiny input, then with the flush after
    every add. Returns (bits of the sum, chunks flushed)."""
    acc, flushed = np.float64(0.0), 0
    xs = x.view(np.float64)
    for lo in range(0, len(x), K.H1_CHUNK_ROWS):
        chunk = xs[lo:lo + K.H1_CHUNK_ROWS]
        dirty = tiny_rule(chunk)
        flushed += dirty
        for v in chunk:
            acc = acc + v
            if dirty and 0 < abs(acc) < 2.0 ** -1022:
                acc = np.copysign(0.0, acc)
    return int(np.array([acc]).view(np.int64)[0]), flushed


def _is_tiny(chunk):
    a = np.abs(chunk)
    return bool(((a > 0) & (a < K.H1_TINY)).any())


def _rule_draw(rng, n):
    """Values whose sums hit subnormal partial sums often: chunks of tiny
    values (±1, 1.25, 1.5, 2 or 3 times 2^-1022, whose running sum walks
    near 0 and through 0.5 and 0.25 times 2^-1022), and chunks of values at
    and just above the threshold (exponents -969..-962, three mantissa
    bits), most in pairs (v, -v)."""
    t = 2.0 ** -1022
    rows = K.H1_CHUNK_ROWS
    out = []
    while len(out) < n:
        if rng.random() < 0.5:
            out += list(rng.choice([-1.0, 1.0], rows)
                        * rng.choice([1.0, 1.25, 1.5, 2.0, 3.0], rows) * t)
            continue
        end = len(out) + rows
        while len(out) < end:
            v = (rng.choice([-1.0, 1.0]) * (1 + rng.integers(0, 8) / 8)
                 * 2.0 ** int(rng.integers(-969, -961)))
            out += [v, -v] if rng.random() < 0.8 else [v]
    return np.array(out[:n])


@pytest.mark.parametrize("seed", [0, 1])
def test_flush_rule_model_equals_plain(seed):
    """A model of H1's rule on draws that hit subnormal partial sums often
    equals the plain version (the flushed sum of the contract) bit for bit,
    counts the chunks ``flushed_chunks_plain`` counts, and differs from an
    unflushed fold: the rule is what keeps the bits."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 700, 24)
    starts = np.concatenate([[0], np.cumsum(lens)])
    n = int(starts[-1])
    z = _rule_draw(rng, n)
    valid = rng.random(n) > 0.05
    x = np.where(valid, z, 0.0).view(np.int64)
    zt, vt, st = (torch.from_numpy(z), torch.from_numpy(valid),
                  torch.from_numpy(starts))
    cnt = torch.zeros(1, dtype=torch.int64)
    sums, _, _ = K.segment_float_agg(zt, vt, st, flushed=cnt)
    want = sums.view(torch.int64).numpy()
    rule, total, unflushed_differs, hits = [], 0, 0, 0
    for g in range(len(lens)):
        seg = x[starts[g]:starts[g + 1]]
        bits, f = _flushed_fold(seg, _is_tiny)
        rule.append(bits)
        total += f
        unflushed_differs += _flushed_fold(seg, lambda c: False)[0] != bits
        part = np.abs(np.cumsum(seg.view(np.float64)))
        hits += int(((part > 0) & (part < 2.0 ** -1022)).sum())
    assert rule == want.tolist()
    assert int(cnt) == total == K.flushed_chunks_plain(zt, vt, st) > 0
    assert hits >= 40 and unflushed_differs >= 2


def test_flush_rule_threshold():
    """One step of the unflushed chain from a partial sum that is not
    subnormal, adding an input of magnitude at least 2^-969 (H1_TINY), never
    makes a nonzero subnormal: a million near-cancelling pairs across the
    threshold. At 2^-970 one can."""
    rng = np.random.default_rng(11)
    m = 1_000_000
    # s: exponent fields 1..90 (2^-1022 .. 2^-933), any mantissa, any sign
    s_bits = ((rng.integers(1, 91, m) << 52)
              | rng.integers(0, 1 << 52, m)).astype(np.int64)
    # x: -s moved a few ulps and kept at or above 2^-969
    x_bits = np.maximum(s_bits + rng.integers(-3, 4, m),
                        np.int64((1023 - 969) << 52))
    s = s_bits.view(np.float64) * rng.choice([-1.0, 1.0], m)
    x = -np.sign(s) * x_bits.view(np.float64)
    r = np.abs(s + x)
    assert not ((r > 0) & (r < 2.0 ** -1022)).any()
    assert (r == 0).sum() > 1000            # the draws do cancel
    near = np.float64(2.0 ** -970)
    assert -(near - 2.0 ** -1023) + near == 2.0 ** -1023  # subnormal


def test_h1_constants_mirror_the_kernel():
    """H1_CHUNK_ROWS and H1_TINY are csrc/segment_agg.cu's kChunk and
    kTinyHi (the high word of 2^-969)."""
    import re
    src = (K._CSRC / "segment_agg.cu").read_text()
    assert int(re.search(r"constexpr int kChunk = (\d+);", src)[1]) == \
        K.H1_CHUNK_ROWS
    hi = int(re.search(r"kTinyHi = (0x[0-9A-Fa-f]+)u;", src)[1], 16)
    assert np.array([K.H1_TINY]).view(np.int64)[0] == hi << 32
