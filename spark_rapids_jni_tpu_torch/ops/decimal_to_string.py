"""Spark non-ANSI decimal -> string (the JAX package's
ops/decimal_to_string.py).

Spark's ``cast(dec as string)`` follows ``java.math.BigDecimal.toString``:
plain notation while ``scale >= 0`` and the adjusted exponent is
``>= -6``; otherwise scientific ``d.dddE±adj`` with an explicit '+' on a
non-negative exponent.

As in the JAX package this is host work over the materialized values: the
digits of each row are data-dependent in length, and decimal columns print
at EXPLAIN/collect, not in query inner loops. The result is a STRING column
on the input column's device (``strings.pack_byte_rows``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..columnar.column import Column
from ..columnar.dtype import TypeId
from ..columnar.strings import pack_byte_rows


def _unscaled_ints(col: Column) -> List[int]:
    arr = col.to_numpy()
    if col.dtype.id is TypeId.DECIMAL128:
        # uint32[n, 4] little-endian limbs, two's complement
        u = arr.astype(np.uint64)
        lo = (u[:, 0] | (u[:, 1] << np.uint64(32))).tolist()
        hi = (u[:, 2] | (u[:, 3] << np.uint64(32))).view(np.int64).tolist()
        return [(h << 64) | low for h, low in zip(hi, lo)]
    return arr.tolist()


def _to_string(u: int, scale: int) -> bytes:
    neg = u < 0
    digits = str(-u if neg else u)
    k = len(digits)
    adjusted = (k - 1) - scale
    if scale >= 0 and adjusted >= -6:
        # plain notation
        if scale == 0:
            body = digits
        elif k > scale:
            body = digits[:k - scale] + "." + digits[k - scale:]
        else:
            body = "0." + "0" * (scale - k) + digits
    else:
        # scientific: d.dddE±adj (E+ for a non-negative adjusted exponent)
        exp = "E" + ("+" if adjusted >= 0 else "") + str(adjusted)
        if u == 0:
            body = "0" + exp
        else:
            rest = digits[1:]
            body = digits[0] + ("." + rest if rest else "") + exp
    return ("-" + body if neg else body).encode()


def decimal_to_string(col: Column) -> Column:
    """BigDecimal.toString semantics for DECIMAL32/64/128 columns."""
    if not col.dtype.is_decimal:
        raise TypeError(
            f"decimal_to_string: not a decimal column: {col.dtype}")
    scale = col.dtype.scale
    valid = (None if col.validity is None
             else col.validity.cpu().numpy())
    parts = [b"" if valid is not None and not valid[i] else
             _to_string(u, scale)
             for i, u in enumerate(_unscaled_ints(col))]
    return pack_byte_rows(parts, valid, device=col.device)
