"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are built with numpy from a seed, handed to the JAX package through
its own constructors and to the port through the JAX package's wire format
(``interop.wire_to_col(bridge.col_to_wire(c), "cpu")``). Comparisons are
bit-exact: every value on the port's path is an integer or a bit pattern.
"""

import numpy as np
import torch

from spark_rapids_jni_tpu import bridge
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.columnar.column import Table


def to_port(col, device="cpu"):
    """JAX-package Column -> port Column, through the wire format."""
    return interop.wire_to_col(bridge.col_to_wire(col), device)


def table_to_port(table: JTable, device="cpu") -> Table:
    return Table(tuple(to_port(c, device) for c in table.columns))


def col_bits(col) -> np.ndarray:
    """Raw value bytes of a column of either package, as uint8."""
    if hasattr(col.data, "device") and isinstance(col.data, torch.Tensor):
        return col.data.detach().cpu().contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(col.data)).view(np.uint8)


def assert_col_equal(jcol, pcol, where=""):
    """Same type id, rows, validity (presence and bits) and value bytes."""
    assert jcol.dtype.id.value == pcol.dtype.id.value, where
    assert jcol.size == pcol.size, where
    assert (jcol.validity is None) == (pcol.validity is None), \
        f"{where}: validity presence differs"
    np.testing.assert_array_equal(np.asarray(jcol.valid_mask()),
                                  pcol.valid_mask().cpu().numpy(),
                                  err_msg=f"{where}: validity")
    np.testing.assert_array_equal(col_bits(jcol).reshape(-1),
                                  col_bits(pcol).reshape(-1),
                                  err_msg=f"{where}: value bytes")


def assert_table_equal(jt, pt):
    assert jt.num_columns == pt.num_columns
    for i, (a, b) in enumerate(zip(jt.columns, pt.columns)):
        assert_col_equal(a, b, f"column {i}")
