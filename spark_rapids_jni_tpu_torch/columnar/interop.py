"""Columns across the package boundary, in the JAX package's wire format.

The JAX package's engine bridge moves a column as the tuple
``(dtype_str, rows, data, offsets, validity)`` (its bridge.py, format at
the top of that file):

  * dtype_str: the TypeId value, with ":scale" for decimals
    ("int64", "decimal64:2", "timestamp_us", ...);
  * data:      raw little-endian value bytes (FLOAT64 = IEEE-754 bits);
  * offsets:   int64[rows+1] bytes for STRING, else None;
  * validity:  uint8[rows] 0/1 bytes, or None (= all valid).

``wire_to_col`` turns such a tuple (as the JAX package's
``bridge.col_to_wire`` writes it) into a port Column on ``device``, and
``col_to_wire`` writes a port Column back. Both carry bits: no value is
cast on the way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import dtype as dt
from .column import Column, resolve_device
from .dtype import TypeId

WireCol = Tuple[str, int, bytes, Optional[bytes], Optional[bytes]]


def wire_to_col(w: WireCol, device="cuda") -> Column:
    """Wire tuple -> port Column on ``device`` (fixed-width types)."""
    name, rows, data, offsets, validity = w
    d = dt.parse_dtype(name).require_stored()
    dev = resolve_device(device)
    rows = int(rows)
    vals = np.frombuffer(data, d.np_dtype)[:rows]
    col = Column.from_numpy(vals, d, device=dev)
    if validity is not None:
        v = np.frombuffer(validity, np.uint8)[:rows].astype(bool)
        col.validity = torch.from_numpy(v).to(dev)
    return col


def col_to_wire(col: Column) -> WireCol:
    """Port Column -> wire tuple (fixed-width types)."""
    if col.dtype.id is TypeId.LIST:
        raise ValueError("nested columns must be decomposed by the caller")
    validity = None
    if col.validity is not None:
        validity = col.validity.cpu().numpy().astype(np.uint8).tobytes()
    return (dt.dtype_str(col.dtype), col.size, col.to_numpy().tobytes(),
            None, validity)
