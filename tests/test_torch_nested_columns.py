"""Port parity: LIST and STRUCT columns (``spark_rapids_jni_tpu_torch``'s
columnar/column.py, ops/sort.gather, columnar/table_ops.py) against the
JAX package's, bit for bit.

Nested columns are drawn with numpy from a seed: LIST<INT32>,
STRUCT<INT64, STRING>, LIST<LIST<INT64>>, LIST<STRUCT<FLOAT64, STRING>>
and STRUCT<LIST<INT32>, INT16>, with nulls at every level. Each crosses to
the port child by child (``torch_parity.to_port``) and must give the same
``to_pylist``, and the same column again after a gather, a concatenation,
a slice and a filter, validity presence included. The plan engine carries
nested payload columns through Filter, Sort and a join (held to the
port's own table ops, which the tests above hold to the JAX package). The error
contract holds both packages to the same exception types and messages
where a nested column is used where Spark refuses it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar import table_ops as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.ops import groupby as JG
from spark_rapids_jni_tpu.ops import hashing as JH
from spark_rapids_jni_tpu.ops import join as JJ
from spark_rapids_jni_tpu.ops import sort as JS
from spark_rapids_jni_tpu.ops import zorder as JZ
from spark_rapids_jni_tpu.plan import expr as jex
from spark_rapids_jni_tpu.plan import nodes as jnodes
from spark_rapids_jni_tpu.plan.executor import execute_plan as jexecute
from spark_rapids_jni_tpu_torch.columnar import dtype as dt
from spark_rapids_jni_tpu_torch.columnar import table_ops as T
from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
from spark_rapids_jni_tpu_torch.memory.transport import to_device, to_host
from spark_rapids_jni_tpu_torch.ops import groupby as G
from spark_rapids_jni_tpu_torch.ops import hashing as H
from spark_rapids_jni_tpu_torch.ops import join as J
from spark_rapids_jni_tpu_torch.ops import sort as S
from spark_rapids_jni_tpu_torch.ops import zorder as Z
from spark_rapids_jni_tpu_torch.plan.executor import execute_plan

from torch_parity import (assert_col_equal, assert_table_equal, plan_to_port,
                          quick_jax_reference, table_to_port,  # noqa: F401
                          to_port)

pytestmark = pytest.mark.usefixtures("quick_jax_reference")

N = 40  # rows of every drawn column


def _valid(rng, n, frac=0.2):
    return jnp.asarray(rng.random(n) >= frac)


def _offsets(rng, n, most=4):
    lens = rng.integers(0, most + 1, n)
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _ints(rng, n, jtype=jdt.INT32, npt=np.int32):
    return JColumn.from_numpy(rng.integers(-1000, 1000, n).astype(npt), jtype,
                              validity=np.asarray(rng.random(n) >= 0.2))


def _strings(rng, n):
    return JColumn.from_pylist(
        [None if rng.random() < 0.2 else f"s{int(rng.integers(0, 99))}"
         for _ in range(n)], jdt.STRING)


def draw(kind: str, seed: int = 0, n: int = N) -> JColumn:
    """One nested JAX column of ``kind``, ``n`` rows."""
    rng = np.random.default_rng(seed)
    if kind == "list_i32":
        o = _offsets(rng, n)
        return JColumn.list_of(_ints(rng, int(o[-1])), jnp.asarray(o),
                               _valid(rng, n))
    if kind == "struct":
        return JColumn.struct_of([_ints(rng, n, jdt.INT64, np.int64),
                                  _strings(rng, n)], _valid(rng, n))
    if kind == "list_list":
        o = _offsets(rng, n, 3)
        m = int(o[-1])
        inner = _offsets(rng, m, 3)
        leaf = _ints(rng, int(inner[-1]), jdt.INT64, np.int64)
        return JColumn.list_of(
            JColumn.list_of(leaf, jnp.asarray(inner), _valid(rng, m)),
            jnp.asarray(o), _valid(rng, n))
    if kind == "list_struct":
        o = _offsets(rng, n)
        m = int(o[-1])
        x = JColumn.from_numpy(rng.standard_normal(m), jdt.FLOAT64,
                               validity=np.asarray(rng.random(m) >= 0.2))
        return JColumn.list_of(
            JColumn.struct_of([x, _strings(rng, m)], _valid(rng, m)),
            jnp.asarray(o), _valid(rng, n))
    if kind == "struct_list":
        o = _offsets(rng, n)
        lst = JColumn.list_of(_ints(rng, int(o[-1])), jnp.asarray(o),
                              _valid(rng, n))
        return JColumn.struct_of([lst, _ints(rng, n, jdt.INT16, np.int16)],
                                 _valid(rng, n))
    raise ValueError(kind)


KINDS = ["list_i32", "struct", "list_list", "list_struct", "struct_list"]


@pytest.mark.parametrize("kind", KINDS)
def test_construction_and_to_pylist_match(kind):
    jc = draw(kind)
    pc = to_port(jc)
    assert pc.dtype.is_nested and not pc.dtype.is_fixed_width
    assert pc.to_pylist() == jc.to_pylist()
    assert pc.device_nbytes() == jc.device_nbytes()
    assert pc.valid_mask().dtype == torch.bool
    assert_col_equal(jc, to_device(to_host(pc), "cpu"))


def test_constructors_assert_as_the_jax_package():
    a = Column.from_pylist([1, 2], dt.INT32, device="cpu")
    b = Column.from_pylist([1], dt.INT32, device="cpu")
    for make in (lambda C, x, y: C.struct_of([]),
                 lambda C, x, y: C.struct_of([x, y])):
        with pytest.raises(AssertionError):
            make(JColumn, JColumn.from_pylist([1, 2], jdt.INT32),
                 JColumn.from_pylist([1], jdt.INT32))
        with pytest.raises(AssertionError):
            make(Column, a, b)
    s = Column.struct_of([a, Column.from_pylist(["x", None], dt.STRING,
                                                device="cpu")])
    assert s.size == 2 and s.to_pylist() == [(1, "x"), (2, None)]
    lst = Column.list_of(a, torch.tensor([0, 2, 2]),
                         torch.tensor([True, False]))
    assert lst.offsets.dtype == torch.int32
    assert lst.to_pylist() == [[1, 2], None]
    with pytest.raises(ValueError, match="no flat values"):
        lst.to_numpy()


@pytest.mark.parametrize("kind", ["list_list", "list_struct",
                                  "struct_list"])
def test_gather_matches(kind):
    jc = draw(kind, seed=1)
    idx = np.random.default_rng(5).integers(0, N, 2 * N)
    want = JS.gather(jc, jnp.asarray(idx.astype(np.int32)))
    got = S.gather(to_port(jc), torch.from_numpy(idx))
    assert_col_equal(want, got)


@pytest.mark.parametrize("kind", KINDS)
def test_concat_matches(kind):
    parts = [draw(kind, seed=s, n=n) for s, n in ((2, N), (3, 7), (4, 0))]
    want = JT.concat_columns(parts)
    got = T.concat_columns([to_port(c) for c in parts])
    assert_col_equal(want, got)


@pytest.mark.parametrize("what", ["slice", "filter"])
def test_slice_and_filter_tables_match(what):
    jt = JTable((draw("list_list" if what == "slice" else "struct_list",
                      6),))
    pt = table_to_port(jt)
    if what == "slice":
        want, got = JT.slice_table(jt, 5, 31), T.slice_table(pt, 5, 31)
    else:
        mask = np.random.default_rng(7).random(N) > 0.4
        want = JT.filter_table(jt, jnp.asarray(mask))
        got = T.filter_table(pt, torch.from_numpy(mask))
    assert_table_equal(want, got)


def test_out_of_bounds_gather_nullifies_nested_rows():
    """Index -1 or past the end gives a null row (an outer join's gather
    map)."""
    pc = to_port(draw("list_struct", 8))
    got = T.gather_column(pc, [3, -1, N], out_of_bounds_null=True)
    assert got.to_pylist() == [pc.to_pylist()[3], None, None]


def test_int32_offsets_overflow_raises():
    """A LIST past int32 offsets raises, as a STRING concat does (the
    offsets are checked before any element moves)."""
    empty = Column(dt.INT8, 0, data=torch.zeros(0, dtype=torch.int8))
    big = Column.list_of(empty, torch.tensor([0, 1 << 30]))
    with pytest.raises(ValueError, match="int32 offsets"):
        T.concat_columns([big, big])
    with pytest.raises(ValueError, match="int32 offsets"):
        S.gather(big, torch.tensor([0, 0]))


@pytest.mark.parametrize("what", ["filter", "sort", "join"])
def test_plan_engine_carries_nested_payloads(what):
    """The plan engine's result equals the same rows taken by the port's
    table ops (held to the JAX package above): nested payloads ride
    through the engine's gathers."""
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 10, N)
    pt = Table((Column.from_numpy(keys, dt.INT64, device="cpu"),
                to_port(draw("list_struct", 10)),
                to_port(draw("struct_list", 11))))
    if what == "join":
        right = Table((Column.from_numpy(np.arange(6, dtype=np.int64),
                                         dt.INT64, device="cpu"),))
        plan = jnodes.Join(jnodes.Scan(3, input_index=0),
                           jnodes.Scan(1, input_index=1), [0], [0], "inner")
        got = execute_plan(plan_to_port(plan), [pt, right])
        rows = np.flatnonzero(keys < 6)
        order = np.argsort(keys[rows], kind="stable")
        got_rows = sorted(zip(got[0].to_pylist(), got[1].to_pylist(),
                              got[2].to_pylist()), key=repr)
        want = T.gather_table(pt, torch.from_numpy(rows[order]))
        assert got_rows == sorted(zip(*(c.to_pylist() for c in want)),
                                  key=repr)
        return
    if what == "filter":
        plan = jnodes.Filter(jnodes.Scan(3),
                             jex.BinOp("gt", jex.Col(0), jex.Lit(4)))
        want = T.filter_table(pt, torch.from_numpy(keys > 4))
    else:
        plan = jnodes.Sort(jnodes.Scan(3), [0])
        want = S.sort_table(pt, [0])
    got = execute_plan(plan_to_port(plan), pt)
    for w, g in zip(want, got):
        assert g.to_pylist() == w.to_pylist()


def _contract_cases():
    """(name, JAX call, port call) over the same nested column."""
    jl, js = draw("list_i32", 12), draw("struct", 13)
    k = JColumn.from_numpy(np.arange(N, dtype=np.int64), jdt.INT64)
    jls = draw("list_struct", 14)
    cases = []
    for tag, jc in (("list", jl), ("struct", js)):
        pc, pk = to_port(jc), to_port(k)
        cases += [
            (f"{tag}_sort_key",
             lambda jc=jc: JS.sort_table(JTable((jc, k)), [0]),
             lambda pc=pc, pk=pk: S.sort_table(Table((pc, pk)), [0])),
            (f"{tag}_join_key",
             lambda jc=jc: JJ.inner_join([jc], [jc]),
             lambda pc=pc: J.inner_join([pc], [pc])),
            (f"{tag}_groupby_value",
             lambda jc=jc: JG.groupby_aggregate(JTable((k, jc)), [0],
                                                [(1, "sum")]),
             lambda pc=pc, pk=pk: G.groupby_aggregate(Table((pk, pc)), [0],
                                                      [(1, "sum")])),
            (f"{tag}_groupby_key",
             lambda jc=jc: JG.groupby_aggregate(JTable((jc, k)), [0],
                                                [(1, "sum")]),
             lambda pc=pc, pk=pk: G.groupby_aggregate(Table((pc, pk)), [0],
                                                      [(1, "sum")])),
            (f"{tag}_plan_reference",
             lambda jc=jc: jexecute(jnodes.Filter(
                 jnodes.Scan(2), jex.BinOp("eq", jex.Col(0), jex.Lit(1))),
                 JTable((jc, k))),
             lambda pc=pc, pk=pk: execute_plan(plan_to_port(jnodes.Filter(
                 jnodes.Scan(2), jex.BinOp("eq", jex.Col(0), jex.Lit(1)))),
                 Table((pc, pk)))),
            (f"{tag}_xxhash64", lambda jc=jc: JH.xxhash64([jc]),
             lambda pc=pc: H.xxhash64([pc])),
            (f"{tag}_interleave_bits",
             lambda jc=jc: JZ.interleave_bits([jc]),
             lambda pc=pc: Z.interleave_bits([pc])),
        ]
    pls = to_port(jls)
    cases.append(("list_of_struct_murmur3",
                  lambda: JH.murmur_hash3_32([jls]),
                  lambda: H.murmur_hash3_32([pls])))
    return cases


CONTRACT = _contract_cases()


@pytest.mark.parametrize("name,jcall,pcall", CONTRACT,
                         ids=[c[0] for c in CONTRACT])
def test_nested_error_contract_matches(name, jcall, pcall):
    """Both packages raise the same exception type with the same message
    for a nested column where Spark's contract refuses one."""
    with pytest.raises(Exception) as want:
        jcall()
    with pytest.raises(type(want.value)) as got:
        pcall()
    assert str(got.value) == str(want.value)
