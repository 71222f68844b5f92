"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are built with numpy from a seed, handed to the JAX package through
its own constructors and to the port through the JAX package's wire format
(``interop.wire_to_col(bridge.col_to_wire(c), "cpu")``), advisory column
stats included. Plans cross with ``plan_to_port``, which rebuilds a JAX
plan node by node from the port's constructors. Comparisons are bit-exact:
every value on the port's path is an integer or a bit pattern.
"""

import dataclasses

import numpy as np
import torch

from spark_rapids_jni_tpu import bridge
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.plan import expr as jex
from spark_rapids_jni_tpu.plan import nodes as jnodes
from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.columnar.column import ColumnStats, Table
from spark_rapids_jni_tpu_torch.plan import expr as pex
from spark_rapids_jni_tpu_torch.plan import nodes as pnodes


def to_port(col, device="cpu"):
    """JAX-package Column -> port Column, through the wire format, with
    its advisory stats."""
    out = interop.wire_to_col(bridge.col_to_wire(col), device)
    st = col.stats()
    if st is not None:
        out.with_stats(ColumnStats(**dataclasses.asdict(st)))
    return out


def table_to_port(table: JTable, device="cpu") -> Table:
    return Table(tuple(to_port(c, device) for c in table.columns))


def col_bits(col) -> np.ndarray:
    """Raw value bytes of a column of either package, as uint8."""
    if hasattr(col.data, "device") and isinstance(col.data, torch.Tensor):
        return col.data.detach().cpu().contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(col.data)).view(np.uint8)


def assert_col_equal(jcol, pcol, where="", presence=True):
    """Same type id, rows, validity bits and value bytes — and, with
    ``presence``, validity present on both or neither. The engines of
    either package agree on the validity bits, not on their presence (a
    direct-slot groupby's sums carry none), so a comparison across
    engines passes ``presence=False``."""
    assert jcol.dtype.id.value == pcol.dtype.id.value, where
    assert jcol.size == pcol.size, where
    assert not presence or (jcol.validity is None) == (
        pcol.validity is None), f"{where}: validity presence differs"
    np.testing.assert_array_equal(np.asarray(jcol.valid_mask()),
                                  pcol.valid_mask().cpu().numpy(),
                                  err_msg=f"{where}: validity")
    np.testing.assert_array_equal(col_bits(jcol).reshape(-1),
                                  col_bits(pcol).reshape(-1),
                                  err_msg=f"{where}: value bytes")


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
    return tuple(table_to_port(t, device) for t in tables)


METRIC_KEYS = ("plan_executes", "plan_fallbacks", "plan_join_fallbacks",
               "plan_overflows", "plan_fallback_reasons")


def metric_counts(snapshot) -> dict:
    """The fallback counters both packages keep, from a snapshot."""
    return {k: snapshot[k] for k in METRIC_KEYS}
