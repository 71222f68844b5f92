"""Port parity: encoded columns — DICT32 (columnar/dictionary.py), RLE
and FOR32/FOR64 (columnar/encodings.py) — against the JAX package, bit for
bit: values, validity and every child (dictionary values and ranks, run
values and lengths, FOR headers and packed bytes).

The cases are those of the JAX package's tests/test_dictionary.py and
tests/test_encodings.py that these modules reach, each JAX function beside
its port on the same numpy inputs: encode and decode, lookups and
fingerprints, sort, gather, filter, concat, groupby (the sort-free paths
and the sorted one), joins on codes, and linear and DAG plans with
dictionary literals on both engines. Tables of one kind share their row
count, so the JAX package compiles once per op.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import plan as JP
from spark_rapids_jni_tpu.columnar import dictionary as JD
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar import encodings as JE
from spark_rapids_jni_tpu.columnar import table_ops as JT_ops
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.ops import groupby as JG
from spark_rapids_jni_tpu.ops import join as JJ
from spark_rapids_jni_tpu.ops import sort as JS
from spark_rapids_jni_tpu.plan.compile import ProgramCache as JCache
from spark_rapids_jni_tpu.plan.compile import _shape_key as j_shape_key
from spark_rapids_jni_tpu_torch import plan as P
from spark_rapids_jni_tpu_torch.columnar import dictionary as D
from spark_rapids_jni_tpu_torch.columnar import encodings as E
from spark_rapids_jni_tpu_torch.columnar import table_ops as T_ops
from spark_rapids_jni_tpu_torch.ops import groupby as G
from spark_rapids_jni_tpu_torch.ops import hashing as H
from spark_rapids_jni_tpu_torch.ops import join as J
from spark_rapids_jni_tpu_torch.ops import sort as S
from spark_rapids_jni_tpu_torch.plan.compile import ProgramCache
from spark_rapids_jni_tpu_torch.plan.compile import _shape_key

from torch_parity import (assert_col_equal, assert_table_equal,  # noqa: F401
                          plan_to_port, quick_jax_reference, table_to_port,
                          tables_to_port, to_port)

pytestmark = pytest.mark.usefixtures("quick_jax_reference")

DICT_ROWS = 512   # every table of the port's new parity tests
ENC_ROWS = 512


def _strings(seed=0, nulls=True, card=23, rows=DICT_ROWS):
    rng = np.random.default_rng(seed)
    vals = [f"entry_{v:03d}_{'x' * (v % 7)}"
            for v in rng.integers(0, card, rows)]
    if nulls:
        vals = [None if i % 11 == 0 else v for i, v in enumerate(vals)]
    return JColumn.from_pylist(vals, jdt.STRING)


def _dict_table(seed=0, nulls=True, card=23):
    """(DICT32 key, INT64 value, FLOAT64 value)."""
    rng = np.random.default_rng(100 + seed)
    return JTable((JD.encode_strings(_strings(seed, nulls, card)),
                   JColumn.from_numpy(rng.integers(-1000, 1000, DICT_ROWS)),
                   JColumn.from_numpy(rng.standard_normal(DICT_ROWS),
                                      jdt.FLOAT64)))


def _sorted_col(card=64, nulls=False, dtype=jdt.INT64):
    vals = np.repeat(np.arange(card, dtype=np.int64) * 3 - card,
                     -(-ENC_ROWS // card))[:ENC_ROWS]
    valid = None
    if nulls:
        valid = np.ones(ENC_ROWS, dtype=bool)
        valid[::max(ENC_ROWS // card, 1) * 2] = False
    return JColumn.from_numpy(vals.astype(dtype.np_dtype), dtype,
                              validity=valid)


def _bounded_col(nulls=False, seed=1, dtype=np.int64):
    rng = np.random.default_rng(seed)
    vals = (10_000 + rng.integers(0, 900, ENC_ROWS)).astype(dtype)
    return JColumn.from_numpy(vals, validity=(rng.random(ENC_ROWS) > 0.1
                                              if nulls else None))


def _encoded_table(kind, nulls=False):
    key = _sorted_col(nulls=nulls) if kind == "rle" else _bounded_col(nulls)
    enc = JE.rle_encode(key) if kind == "rle" else JE.for_encode(key)
    val = JColumn.from_numpy(
        np.random.default_rng(7).integers(-1000, 1000, ENC_ROWS))
    return JTable((enc, val))


# ---------------------------------------------------------------------------
# encode / decode / identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["strings", "all_null", "zero_rows",
                                  "all_empty"])
def test_encode_strings_matches(case):
    col = {"strings": lambda: _strings(),
           "all_null": lambda: JColumn.from_pylist([None] * 64, jdt.STRING),
           "zero_rows": lambda: JColumn.from_pylist([], jdt.STRING),
           "all_empty": lambda: JColumn.from_pylist([""] * 5 + [None],
                                                    jdt.STRING)}[case]()
    want = JD.encode_strings(col)
    got = D.encode_strings(to_port(col))
    assert_col_equal(want, got)
    assert_col_equal(JD.materialize(want), D.materialize(got))
    assert got.to_pylist() == col.to_pylist()
    assert D.dictionary_fingerprint(got) == JD.dictionary_fingerprint(want)


def test_dictionary_lookup_fingerprint_and_align():
    a = JD.encode_strings(JColumn.from_pylist(["x", "y", "z"], jdt.STRING))
    b = JD.encode_strings(JColumn.from_pylist(["y", "w"], jdt.STRING))
    pa, pb = to_port(a), to_port(b)
    for needle in ("y", "absent", b"z"):
        assert D.lookup_code(pa, needle) == JD.lookup_code(a, needle)
    assert D.same_dictionary(pa, pa) and not D.same_dictionary(pa, pb)
    assert D.dictionary_fingerprint(pb) == JD.dictionary_fingerprint(b)
    for w, g in zip(JD.align_codes(a, b), D.align_codes(pa, pb)):
        assert_col_equal(w, g)
    empty = JD.dict_column(jnp.zeros((16,), jnp.int32),
                           JD.values_from_entries([]),
                           validity=jnp.zeros((16,), bool))
    pe = to_port(empty)
    assert D.lookup_code(pe, "anything") == -1
    assert_col_equal(JD.materialize(empty), D.materialize(pe))
    assert_table_equal(JS.sort_table(JTable((empty,)), [0]),
                       S.sort_table(Table_of(pe), [0]))


def Table_of(*cols):
    from spark_rapids_jni_tpu_torch.columnar.column import Table
    return Table(tuple(cols))


@pytest.mark.parametrize("case", ["rle_sorted", "rle_nulls", "rle_one_run",
                                  "rle_all_null", "rle_empty",
                                  "rle_zero_length_runs", "for_w1",
                                  "for_w5", "for_w13", "for_w32",
                                  "for_nulls_negative_ref", "for32"])
def test_rle_and_for_encode_match(case):
    if case == "rle_zero_length_runs":
        want = JE.rle_column(
            JColumn.from_numpy(np.array([5, 7, 9], np.int64)),
            JColumn.from_numpy(np.array([2, 0, 3], np.int32)))
        got = to_port(want)
        got = E.rle_column(got.children[0], got.children[1])
    elif case.startswith("rle"):
        plain = {"rle_sorted": lambda: _sorted_col(),
                 "rle_nulls": lambda: _sorted_col(card=8, nulls=True),
                 "rle_one_run": lambda: JColumn.from_numpy(
                     np.full(100, 42, np.int64)),
                 "rle_all_null": lambda: JColumn(
                     jdt.INT64, 10, data=jnp.zeros(10, jnp.int64),
                     validity=jnp.zeros(10, bool)),
                 "rle_empty": lambda: JColumn.from_numpy(
                     np.zeros(0, np.int64))}[case]()
        want = JE.rle_encode(plain)
        got = E.rle_encode(to_port(plain))
    else:
        rng = np.random.default_rng(3)
        if case == "for_nulls_negative_ref":
            plain = JColumn.from_numpy(rng.integers(-500, -100, 256),
                                       validity=rng.random(256) > 0.2)
            width = None
        elif case == "for32":
            plain = JColumn.from_numpy(np.arange(100, dtype=np.int32) + 7)
            width = None
        else:
            width = int(case[5:])
            plain = JColumn.from_numpy(
                10_000 + rng.integers(0, min(2 ** width, 2 ** 31), 37))
        want = JE.for_encode(plain, width=width)
        got = E.for_encode(to_port(plain), width=width)
    assert_col_equal(want, got)
    assert_col_equal(JE.materialize(want), E.materialize(got))
    assert got.to_pylist() == want.to_pylist()
    assert E.encoding_fingerprint(got) == JE.encoding_fingerprint(want)
    assert E.encoding_cache_key(got) == JE.encoding_cache_key(want)


# ---------------------------------------------------------------------------
# run-space and code-space predicates and aggregates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge", "eq", "ne"])
def test_predicates_match(op):
    r = JE.rle_encode(_sorted_col(card=16, nulls=True))
    f = JE.for_encode(_bounded_col(nulls=True))
    np.testing.assert_array_equal(np.asarray(JE.rle_predicate_runs(r, op, 5)),
                                  E.rle_predicate_runs(to_port(r), op,
                                                       5).numpy())
    np.testing.assert_array_equal(
        np.asarray(JE.for_predicate_mask(f, op, 10_450)),
        E.for_predicate_mask(to_port(f), op, 10_450).numpy())


def test_aggregates_match():
    r = JE.rle_encode(_sorted_col(nulls=True))
    f = JE.for_encode(_bounded_col(nulls=True))
    pr, pf = to_port(r), to_port(f)
    keep_r = JE.rle_predicate_runs(r, "ge", 10)
    keep_f = JE.for_predicate_mask(f, "lt", 10_500)
    for op in ("sum", "count", "min", "max"):
        assert int(E.rle_aggregate(pr, op)) == int(JE.rle_aggregate(r, op))
        assert int(E.for_aggregate(pf, op)) == int(JE.for_aggregate(f, op))
        assert int(E.rle_aggregate(pr, op, torch.from_numpy(
            np.array(keep_r)))) == int(JE.rle_aggregate(r, op, keep_r))
        assert int(E.for_aggregate(pf, op, torch.from_numpy(
            np.array(keep_f)))) == int(JE.for_aggregate(f, op, keep_f))
    big = JColumn.from_numpy(np.full(64, (1 << 62) + 12345, np.int64))
    assert int(E.rle_aggregate(E.rle_encode(to_port(big)), "sum")) == int(
        JE.rle_aggregate(JE.rle_encode(big), "sum"))  # int64 wraps


# ---------------------------------------------------------------------------
# ops: sort, gather/filter, concat, hashing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dict", "dict_desc_nulls_last", "rle",
                                  "for"])
def test_sort_table_matches(kind):
    jt = (_dict_table() if kind.startswith("dict")
          else _encoded_table(kind, nulls=True))
    kw = ({"ascending": [False], "nulls_first": [False]}
          if kind == "dict_desc_nulls_last" else {})
    assert_table_equal(JS.sort_table(jt, [0], **kw),
                       S.sort_table(table_to_port(jt), [0], **kw))


@pytest.mark.parametrize("kind", ["dict", "rle", "for"])
def test_filter_table_matches(kind):
    jt = _dict_table() if kind == "dict" else _encoded_table(kind, True)
    mask = np.random.default_rng(5).random(jt.num_rows) > 0.5
    assert_table_equal(JT_ops.filter_table(jt, jnp.asarray(mask)),
                       T_ops.filter_table(table_to_port(jt),
                                          torch.from_numpy(mask)))


@pytest.mark.parametrize("case", ["dict_merge", "dict_shared", "rle",
                                  "for_aligned", "for_ref_mismatch",
                                  "mixed_plain"])
def test_concat_matches(case):
    if case == "dict_merge":
        cols = [JD.encode_strings(JColumn.from_pylist(v, jdt.STRING))
                for v in (["a", "b", None], ["c", "b"])]
    elif case == "dict_shared":
        enc = JD.encode_strings(_strings())
        cols = [enc, enc]
    elif case == "rle":
        cols = [JE.rle_encode(_sorted_col(card=8)),
                JE.rle_encode(_sorted_col(card=4, nulls=True))]
    elif case == "for_aligned":
        base = np.arange(64, dtype=np.int64) % 32 + 1000
        cols = [JE.for_encode(JColumn.from_numpy(b), width=5)
                for b in (base, base[::-1].copy())]
    elif case == "for_ref_mismatch":
        cols = [JE.for_encode(JColumn.from_numpy(
            np.arange(64, dtype=np.int64) + o)) for o in (100, 900)]
    else:
        plain = _sorted_col(card=4)
        cols = [JE.rle_encode(plain), plain]
    want = JT_ops.concat_columns(cols)
    got = T_ops.concat_columns([to_port(c) for c in cols])
    assert_col_equal(want, got)


def test_hashing_an_encoded_column_raises_type_error():
    for c in (JD.encode_strings(_strings()), JE.rle_encode(_sorted_col()),
              JE.for_encode(_bounded_col())):
        with pytest.raises(TypeError):
            H.xxhash64([to_port(c)])


# ---------------------------------------------------------------------------
# groupby: the sort-free paths and the sorted one
# ---------------------------------------------------------------------------

INT_AGGS = [(1, "sum"), (1, "count"), (1, "min"), (1, "max"), (1, "mean")]


@pytest.mark.parametrize("kind,masked", [
    ("dict", True), ("dict_no_nulls", False), ("rle", True), ("for", True)])
def test_groupby_encoded_key_matches(kind, masked):
    jt = (_dict_table(nulls=kind == "dict") if kind.startswith("dict")
          else _encoded_table(kind, nulls=True))
    mask = (np.random.default_rng(8).random(jt.num_rows) > 0.4
            if masked else None)
    want = JG.groupby_aggregate(jt, [0], INT_AGGS, row_mask=mask)
    got = G.groupby_aggregate(
        table_to_port(jt), [0], INT_AGGS,
        row_mask=None if mask is None else torch.from_numpy(mask))
    assert got.num_rows == want.num_rows > 1
    assert_table_equal(want, got)


def test_groupby_edge_cases_match():
    """An all-null dictionary key (one null group); an RLE value column
    under a plain key (decoded at the boundary); a DICT32 value column
    (count only: a sum raises the JAX package's TypeError)."""
    enc = JD.encode_strings(JColumn.from_pylist([None] * 32, jdt.STRING))
    jt = JTable((enc, JColumn.from_numpy(np.arange(32, dtype=np.int64))))
    assert_table_equal(JG.groupby_aggregate(jt, [0], [(1, "sum")]),
                       G.groupby_aggregate(table_to_port(jt), [0],
                                           [(1, "sum")]))
    et = _encoded_table("rle", nulls=True)
    jt = JTable((et.columns[1], et.columns[0]))
    aggs = [(1, "sum"), (1, "min"), (1, "count")]
    assert_table_equal(JG.groupby_aggregate(jt, [0], aggs),
                       G.groupby_aggregate(table_to_port(jt), [0], aggs))
    dt_ = _dict_table()
    assert_table_equal(JG.groupby_aggregate(dt_, [1], [(0, "count")]),
                       G.groupby_aggregate(table_to_port(dt_), [1],
                                           [(0, "count")]))
    with pytest.raises(TypeError, match="count only"):
        G.groupby_aggregate(table_to_port(dt_), [1], [(0, "sum")])


# ---------------------------------------------------------------------------
# joins on codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("co_dict", [True, False])
def test_join_on_codes_matches(co_dict):
    n = DICT_ROWS
    left = _strings(seed=1)
    if co_dict:
        enc = JD.encode_strings(JT_ops.concat_columns(
            [left, _strings(seed=2)]))
        le = JColumn(enc.dtype, n, data=enc.data[:n],
                     validity=enc.validity[:n], children=enc.children)
        re_ = JColumn(enc.dtype, n, data=enc.data[n:],
                      validity=enc.validity[n:], children=enc.children)
    else:
        le = JD.encode_strings(left)
        re_ = JD.encode_strings(_strings(seed=2, card=17))
    want = JJ.inner_join([le], [re_])
    got = J.inner_join([to_port(le)], [to_port(re_)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].numel() > 0


# ---------------------------------------------------------------------------
# plans: fused and eager, dictionary literals, cache keys
# ---------------------------------------------------------------------------

def _dict_plan():
    return JP.GroupBy(
        JP.Filter(JP.Scan(ncols=3), ~(JP.col(0) == "entry_001_x")),
        keys=(0,), aggs=((1, "sum"), (1, "count"), (2, "sum"), (2, "max")))


_LINEAR = {
    "dict_filter_groupby": (lambda: _dict_table(), _dict_plan),
    "dict_sort": (lambda: _dict_table(), lambda: JP.Sort(JP.Filter(
        JP.Scan(ncols=3), ~(JP.col(0) == "nope")), keys=(0,))),
    "dict_passthrough": (lambda: _dict_table(), lambda: JP.Project(
        JP.Filter(JP.Scan(ncols=3), JP.col(1) > JP.lit(0)),
        (JP.col(0), JP.col(1)))),
    "rle_filter_groupby": (lambda: _encoded_table("rle", True), lambda:
                           JP.GroupBy(JP.Filter(JP.Scan(ncols=2),
                                                JP.col(0) >= JP.lit(0)),
                                      keys=(0,), aggs=((1, "sum"),
                                                       (1, "min")))),
    "for_filter_groupby": (lambda: _encoded_table("for", True), lambda:
                           JP.GroupBy(JP.Filter(JP.Scan(ncols=2),
                                                JP.col(0) >= JP.lit(10_300)),
                                      keys=(0,), aggs=((1, "count"),
                                                       (1, "max")))),
}


@pytest.mark.parametrize("case", sorted(_LINEAR))
def test_linear_plans_match(case):
    """Fused with no fallback, and eager on the resolved plan, each equal
    to the JAX package's fused result (which equals its eager one)."""
    make_table, make_plan = _LINEAR[case]
    jt, plan = make_table(), make_plan()
    want = JP.execute_plan(plan, jt, cache=JCache())
    pt = table_to_port(jt)
    pplan = plan_to_port(plan)
    P.plan_metrics.reset()
    fused = P.execute_plan(pplan, pt, cache=ProgramCache())
    snap = P.plan_metrics.snapshot()
    assert snap["plan_executes"] == 1 and snap["plan_fallbacks"] == 0
    assert_table_equal(want, fused)
    assert_table_equal(want, P.run_eager(P.resolve_literals(pplan, pt), pt),
                       presence=False)


def test_plan_cache_keys_on_the_dictionary():
    """One program per (plan, dictionary): a second dictionary of the same
    shape misses the cache; the same one hits it."""
    plan = plan_to_port(_dict_plan())
    a = table_to_port(_dict_table(seed=0, nulls=False))
    b = table_to_port(_dict_table(seed=7, nulls=False, card=29))
    cache = ProgramCache()
    P.plan_metrics.reset()
    P.execute_plan(plan, a, cache=cache)
    P.execute_plan(plan, a, cache=cache)
    P.execute_plan(plan, b, cache=cache)
    snap = P.plan_metrics.snapshot()
    assert (snap["plan_cache_misses"], snap["plan_cache_hits"]) == (2, 1)
    assert snap["plan_fallbacks"] == 0
    plain = _sorted_col(card=8)
    val = JColumn.from_numpy(np.arange(ENC_ROWS, dtype=np.int64))
    keys = {}
    for name, c in (("plain", plain), ("rle", JE.rle_encode(plain)),
                    ("for", JE.for_encode(plain))):
        keys[name] = _shape_key(table_to_port(JTable((c, val))))
        assert keys[name] == j_shape_key(JTable((c, val)))
    assert len(set(keys.values())) == 3


@pytest.mark.parametrize("case", ["co_dict_literal", "rle_input"])
def test_dag_plans_match(case):
    """A DAG with a dictionary literal on the probe side and a co-dictionary
    join (fused); RLE inputs fall back to the eager engine, labelled, in
    both packages."""
    if case == "co_dict_literal":
        enc = JD.encode_strings(_strings(seed=4, rows=DICT_ROWS + 64,
                                         nulls=False))
        probe = JTable((JColumn(enc.dtype, DICT_ROWS,
                                data=enc.data[:DICT_ROWS],
                                children=enc.children),
                        JColumn.from_numpy(np.arange(DICT_ROWS,
                                                     dtype=np.int64))))
        codes, first = np.unique(np.asarray(enc.data), return_index=True)
        build = JTable((JColumn(enc.dtype, len(codes),
                                data=jnp.asarray(codes.astype(np.int32)),
                                children=enc.children),
                        JColumn.from_numpy(first.astype(np.int64))))
        plan = JP.Join(JP.Filter(JP.Scan(2, input_index=0),
                                 JP.col(0) != "entry_002_xx"),
                       JP.Scan(2, input_index=1), (0,), (0,), "inner")
    else:
        probe = _encoded_table("rle")
        build = JTable((JColumn.from_numpy(np.arange(-64, 200, 3)),))
        plan = JP.Join(JP.Scan(2, input_index=0), JP.Scan(1, input_index=1),
                       (0,), (0,), "inner")
    JP.plan_metrics.reset()
    want = JP.execute_plan(plan, [probe, build], cache=JCache())
    jsnap = JP.plan_metrics.snapshot()
    P.plan_metrics.reset()
    got = P.execute_plan(plan_to_port(plan), tables_to_port([probe, build]),
                         cache=ProgramCache())
    snap = P.plan_metrics.snapshot()
    assert_table_equal(want, got)
    assert snap["plan_fallbacks"] == jsnap["plan_fallbacks"] == (
        1 if case == "rle_input" else 0)
    assert got.num_rows > 100
