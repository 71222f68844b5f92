"""Columns across the package boundary, in the JAX package's wire format.

The JAX package's engine bridge moves a column as the tuple
``(dtype_str, rows, data, offsets, validity)`` (its bridge.py, format at
the top of that file):

  * dtype_str: the TypeId value, with ":scale" for decimals
    ("int64", "decimal64:2", "decimal128:2", "timestamp_us", ...);
  * data:      raw little-endian value bytes (FLOAT64 = IEEE-754 bits,
    DECIMAL128 = 16-byte two's complement);
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
    """Wire tuple -> port Column on ``device`` (fixed-width, DECIMAL128
    and STRING types; STRING offsets narrow to int32 and the characters
    stop at the last offset, as in the JAX package's bridge)."""
    name, rows, data, offsets, validity = w
    d = dt.parse_dtype(name)
    dev = resolve_device(device)
    rows = int(rows)
    if d.id is TypeId.STRING:
        offs = np.frombuffer(offsets, np.int64)[:rows + 1]
        chars = np.frombuffer(data, np.uint8)[:int(offs[-1])].copy()
        col = Column(d, rows, data=torch.from_numpy(chars).to(dev),
                     offsets=torch.from_numpy(offs.astype(np.int32)).to(dev))
    elif d.id is TypeId.DECIMAL128:
        limbs = np.frombuffer(data, np.uint32)[:4 * rows].reshape(rows, 4)
        col = Column.from_numpy(limbs, d, device=dev)
    else:
        vals = np.frombuffer(data, d.require_stored().np_dtype)[:rows]
        col = Column.from_numpy(vals, d, device=dev)
    if validity is not None:
        v = np.frombuffer(validity, np.uint8)[:rows].astype(bool)
        col.validity = torch.from_numpy(v).to(dev)
    return col


def col_to_wire(col: Column) -> WireCol:
    """Port Column -> wire tuple (fixed-width and STRING types)."""
    if col.dtype.is_nested:
        raise ValueError(
            "nested columns must be decomposed by the op handler")
    validity = None
    if col.validity is not None:
        validity = col.validity.cpu().numpy().astype(np.uint8).tobytes()
    if col.dtype.id is TypeId.STRING:
        return (dt.dtype_str(col.dtype), col.size,
                col.data.cpu().numpy().tobytes(),
                col.host_offsets().astype(np.int64).tobytes(), validity)
    return (dt.dtype_str(col.dtype), col.size, col.to_numpy().tobytes(),
            None, validity)
