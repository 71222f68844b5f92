"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are built with numpy from a seed, handed to the JAX package through
its own constructors and to the port through the JAX package's wire format
(``interop.wire_to_col(bridge.col_to_wire(c), "cpu")``), advisory column
stats included. Plans cross with ``plan_to_port``, which rebuilds a JAX
plan node by node from the port's constructors. Comparisons are bit-exact:
every value on the port's path is an integer or a bit pattern; a STRING
column compares its characters and its offsets. An encoded column (DICT32,
RLE, FOR) crosses child by child, and a child shared by several JAX
columns (a dictionary, a run-lengths buffer) is shared by their port
columns too. A LIST or STRUCT column crosses child by child, and compares
its offsets, validity and children.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import bridge
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.plan import expr as jex
from spark_rapids_jni_tpu.plan import nodes as jnodes
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.columnar.column import (Column, ColumnStats,
                                                        Table)
from spark_rapids_jni_tpu_torch.plan import expr as pex
from spark_rapids_jni_tpu_torch.plan import nodes as pnodes


@pytest.fixture(scope="module")
def quick_jax_reference():
    """The JAX package as a reference that compiles less, for one test
    module: its byte hashes under ``jax.jit`` (each padded shape compiles
    once, not once per op) and XLA's optimization passes off. Either
    changes how long its first calls take, not what they compute."""
    from spark_rapids_jni_tpu.columnar import strings as JS
    from spark_rapids_jni_tpu.ops import hashing as JH
    was = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JH, "_mm_bytes", jax.jit(JH._mm_bytes))
            mp.setattr(JH, "_xx_bytes", jax.jit(JH._xx_bytes))
            mp.setattr(JS, "densify_offsets", jax.jit(
                JS.densify_offsets, static_argnames=("L",)))
            yield
    finally:
        jax.config.update("jax_disable_most_optimizations", was)


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch intra-op thread for a test module whose ops are many and
    small (the string device tiers' loops over byte columns): the workers
    of a parallel test run share the cores, and each op's thread pool would
    spin on all of them. Restored after the module."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def jitted_jax_decimal():
    """The JAX package's DECIMAL128 long division and precision10 under
    ``jax.jit`` for one test module (eagerly, each call re-traces its
    256-step loop): how long its calls take changes, not what they
    compute."""
    from spark_rapids_jni_tpu.ops import decimal128 as JD
    from spark_rapids_jni_tpu.ops import int256 as JI
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JI, "divmod_unsigned", jax.jit(JI.divmod_unsigned))
        mp.setattr(JD, "precision10", jax.jit(JD.precision10))
        yield


class _Traced:
    """A traced integer that answers the storage-class and sign questions
    (``precision <= 9``, ``precision <= 18``, ``scale > 0``) from a static
    table and is arithmetic otherwise."""

    def __init__(self, t, answers):
        self.t, self.answers = t, answers

    def __le__(self, o):
        return self.answers[("<=", o)]

    def __gt__(self, o):
        return self.answers[(">", o)]

    def __lt__(self, o):  # array > self, reflected
        return self.t < o

    def __add__(self, o):
        return self.t + (o.t if isinstance(o, _Traced) else o)

    __radd__ = __add__

    def __sub__(self, o):
        return self.t - o

    def __rsub__(self, o):
        return o - self.t

    def __neg__(self):
        return -self.t


@pytest.fixture(scope="module")
def jax_decimal_any_scale():
    """The JAX package's string -> decimal cast for one test module,
    compiled once per storage class (precision <= 9, <= 18, <= 38) and
    sign of the scale, not once per (precision, scale) (~4 s each on the
    CPU): the same function, unchanged, under one ``jax.jit`` with the
    precision and scale as traced scalars. It asks only those three
    questions of them as Python bools and uses them in arithmetic
    otherwise, so how often it compiles changes, not what it computes."""
    from spark_rapids_jni_tpu.ops import cast_string as JC
    raw = JC._string_to_decimal_core.__wrapped__

    def core(mat, lengths, in_valid, p, s, *, cls):
        return raw(mat, lengths, in_valid,
                   precision=_Traced(p, {("<=", 9): cls[0],
                                         ("<=", 18): cls[1]}),
                   scale=_Traced(s, {(">", 0): cls[2]}), strip=cls[3])

    jcore = jax.jit(core, static_argnames="cls")

    def patched(mat, lengths, in_valid, *, precision, scale, strip):
        return jcore(mat, lengths, in_valid, jnp.int64(precision),
                     jnp.int64(scale), cls=(precision <= 9, precision <= 18,
                                            scale > 0, strip))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, "_string_to_decimal_core", patched)
        yield


_ENCODED = ("dict32", "rle", "for32", "for64")


def _encoded_to_port(col, device, memo):
    """``memo``: id of a JAX child -> (that child, its port column), so a
    child shared on the JAX side is one port column too (the JAX child is
    held so that its id is not reused)."""
    kids = []
    for c in col.children:
        hit = memo.get(id(c))
        if hit is None:
            hit = memo[id(c)] = (c, to_port(c, device))
        kids.append(hit[1])
    d = pdt.DType(pdt.TypeId(col.dtype.id.value), col.dtype.scale)
    data = (None if col.data is None
            else torch.from_numpy(np.array(col.data)).to(device))
    validity = (None if col.validity is None else torch.from_numpy(
        np.array(col.validity).astype(bool)).to(device))
    return Column(d, col.size, data=data, validity=validity,
                  children=tuple(kids))


_NESTED = ("list", "struct")


def _nested_to_port(col, device, memo):
    """A LIST or STRUCT column, child by child: its int32 offsets and
    validity as they are (the wire format carries no nested column)."""
    kids = tuple(to_port(c, device, memo) for c in col.children)
    offsets = (None if col.offsets is None else torch.from_numpy(
        np.array(col.offsets, dtype=np.int32)).to(device))
    validity = (None if col.validity is None else torch.from_numpy(
        np.array(col.validity).astype(bool)).to(device))
    return Column(pdt.DType(pdt.TypeId(col.dtype.id.value)), col.size,
                  validity=validity, offsets=offsets, children=kids)


def to_port(col, device="cpu", memo=None):
    """JAX-package Column -> port Column, through the wire format, with
    its advisory stats; encoded and nested columns child by child
    (``memo`` shares children across the columns of one conversion)."""
    if col.dtype.id.value in _ENCODED:
        return _encoded_to_port(col, device, {} if memo is None else memo)
    if col.dtype.id.value in _NESTED:
        return _nested_to_port(col, device, {} if memo is None else memo)
    out = interop.wire_to_col(bridge.col_to_wire(col), device)
    st = col.stats()
    if st is not None:
        out.with_stats(ColumnStats(**dataclasses.asdict(st)))
    return out


def table_to_port(table: JTable, device="cpu", memo=None) -> Table:
    memo = {} if memo is None else memo
    return Table(tuple(to_port(c, device, memo) for c in table.columns))


def col_bits(col) -> np.ndarray:
    """Raw value bytes of a column of either package, as uint8."""
    if hasattr(col.data, "device") and isinstance(col.data, torch.Tensor):
        if col.data.numel() == 0:
            return np.zeros(0, np.uint8)
        return col.data.detach().cpu().contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(col.data)).view(np.uint8)


def col_offsets(col) -> np.ndarray:
    """int64 offsets of a STRING or LIST column of either package."""
    o = col.offsets
    o = o.cpu().numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
    return o.astype(np.int64)


def assert_col_equal(jcol, pcol, where="", presence=True):
    """Same type id, rows, validity bits and value bytes — and, with
    ``presence``, validity present on both or neither. The engines of
    either package agree on the validity bits, not on their presence (a
    direct-slot groupby's sums carry none), so a comparison across
    engines passes ``presence=False``. An encoded column compares its
    scale (a FOR width) and every child the same way: dictionary values
    and ranks, run values and lengths, the FOR header. A LIST compares
    its offsets and child, a STRUCT its fields."""
    assert jcol.dtype.id.value == pcol.dtype.id.value, where
    assert jcol.size == pcol.size, where
    if pcol.dtype.id.value in _NESTED:
        assert not presence or (jcol.validity is None) == (
            pcol.validity is None), f"{where}: validity presence differs"
        np.testing.assert_array_equal(np.asarray(jcol.valid_mask()),
                                      pcol.valid_mask().cpu().numpy(),
                                      err_msg=f"{where}: validity")
        if pcol.dtype.id.value == "list":
            np.testing.assert_array_equal(col_offsets(jcol),
                                          col_offsets(pcol),
                                          err_msg=f"{where}: offsets")
        assert len(jcol.children) == len(pcol.children), where
        for i, (jc, pc) in enumerate(zip(jcol.children, pcol.children)):
            assert_col_equal(jc, pc, f"{where} child {i}", presence)
        return
    if pcol.dtype.id.value in _ENCODED:
        assert jcol.dtype.scale == pcol.dtype.scale, where
        assert len(jcol.children) == len(pcol.children), where
        for i, (jc, pc) in enumerate(zip(jcol.children, pcol.children)):
            assert_col_equal(jc, pc, f"{where} child {i}", presence)
        if pcol.data is None:
            assert jcol.data is None and pcol.validity is None, where
            return
    assert not presence or (jcol.validity is None) == (
        pcol.validity is None), f"{where}: validity presence differs"
    np.testing.assert_array_equal(np.asarray(jcol.valid_mask()),
                                  pcol.valid_mask().cpu().numpy(),
                                  err_msg=f"{where}: validity")
    np.testing.assert_array_equal(col_bits(jcol).reshape(-1),
                                  col_bits(pcol).reshape(-1),
                                  err_msg=f"{where}: value bytes")
    if pcol.dtype.id.value == "string":
        np.testing.assert_array_equal(col_offsets(jcol), col_offsets(pcol),
                                      err_msg=f"{where}: offsets")


def assert_table_equal(jt, pt, presence=True):
    assert jt.num_columns == pt.num_columns
    for i, (a, b) in enumerate(zip(jt.columns, pt.columns)):
        assert_col_equal(a, b, f"column {i}", presence)


def expr_to_port(e):
    """JAX plan expression -> the same expression of the port."""
    if isinstance(e, jex.Col):
        return pex.Col(e.index)
    if isinstance(e, jex.Lit):
        return pex.Lit(e.value)
    if isinstance(e, jex.Cast64):
        return pex.Cast64(expr_to_port(e.operand))
    if isinstance(e, jex.Not):
        return pex.Not(expr_to_port(e.operand))
    if isinstance(e, jex.BinOp):
        return pex.BinOp(e.op, expr_to_port(e.left), expr_to_port(e.right))
    raise TypeError(f"not a JAX plan expression: {e!r}")


def plan_to_port(n):
    """JAX plan -> the same plan built from the port's nodes."""
    if isinstance(n, jnodes.Scan):
        return pnodes.Scan(n.ncols, input_index=n.input_index)
    if isinstance(n, jnodes.Join):
        return pnodes.Join(plan_to_port(n.left), plan_to_port(n.right),
                           n.left_on, n.right_on, n.how)
    child = plan_to_port(n.child)
    if isinstance(n, jnodes.Filter):
        return pnodes.Filter(child, expr_to_port(n.predicate))
    if isinstance(n, jnodes.Project):
        return pnodes.Project(child, tuple(expr_to_port(e)
                                           for e in n.exprs))
    if isinstance(n, jnodes.GroupBy):
        return pnodes.GroupBy(child, n.keys, n.aggs)
    if isinstance(n, jnodes.Sort):
        return pnodes.Sort(child, n.keys, n.ascending, n.nulls_first)
    if isinstance(n, jnodes.Limit):
        return pnodes.Limit(child, n.count)
    raise TypeError(f"not a JAX plan node: {n!r}")


def tables_to_port(tables, device="cpu"):
    """One JAX Table or a sequence of them -> the port's."""
    if isinstance(tables, JTable):
        return table_to_port(tables, device)
    memo = {}
    return tuple(table_to_port(t, device, memo) for t in tables)


METRIC_KEYS = ("plan_executes", "plan_fallbacks", "plan_join_fallbacks",
               "plan_overflows", "plan_fallback_reasons")


def metric_counts(snapshot) -> dict:
    """The fallback counters both packages keep, from a snapshot."""
    return {k: snapshot[k] for k in METRIC_KEYS}


def byte_rows(col) -> list:
    """A port STRING column's rows as bytes, None where null (no UTF-8
    decoding: rows that are not UTF-8 cross to the JAX package as they
    are)."""
    chars = col.data.cpu().numpy().tobytes()
    offs = col.host_offsets()
    valid = col.valid_mask().cpu().numpy()
    return [chars[offs[i]:offs[i + 1]] if valid[i] else None
            for i in range(col.size)]
