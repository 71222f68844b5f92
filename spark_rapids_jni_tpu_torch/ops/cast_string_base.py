"""Base-10/16 string <-> integer casts, Spark's ``conv`` and ``hex`` (the
JAX package's ops/cast_string_base.py; reference
CastStrings.toIntegersWithBase / fromIntegersWithBase).

Semantics are the reference's regex pipeline, as the JAX package pins
them:

* ``to_integers_with_base``: the leading ``\\s*-?[digits]`` prefix of each
  string; a row with no digit prefix gives **0** (valid); an empty or
  whitespace-only row gives null; the value wraps at the target width
  (cudf's to_integers), and a leading '-' negates it;
* ``from_integers_with_base(16)``: uppercase hex of the value's unsigned
  bits without leading zeros; base 10: the signed decimal.

``to_integers_with_base`` runs as torch ops on the column's device (the
JAX package runs it in numpy on the host). ``from_integers_with_base``
renders each row on the host, as the JAX package does, and its column
goes to the input's device.
"""

from __future__ import annotations

import torch

from ..columnar import dtype as dt
from ..columnar.column import Column
from ..columnar.strings import pack_byte_rows, padded_bytes
from .cast_string import _narrow

_WS = (9, 10, 11, 12, 13, 32)


def _digit_value(mat: torch.Tensor, base: int) -> torch.Tensor:
    """Each byte's digit value in ``base``, or -1 where it is no digit."""
    m = mat.to(torch.int64)
    v = torch.where((m >= 48) & (m <= 57), m - 48, -1)
    if base == 16:
        v = torch.where((m >= 97) & (m <= 102), m - 87, v)
        v = torch.where((m >= 65) & (m <= 70), m - 55, v)
    return v


def to_integers_with_base(col: Column, base: int, out_dtype,
                          ansi_mode: bool = False) -> Column:
    """Parse a leading base-N integer prefix from each string."""
    if base not in (10, 16):
        raise ValueError(f"Bases supported 10, 16; Actual: {base}")
    if col.dtype.id is not dt.TypeId.STRING:
        raise TypeError("input must be a STRING column")
    n = col.size
    mat, lengths = padded_bytes(col)
    lengths = lengths.to(torch.int64)
    dev = mat.device
    L = mat.shape[1]
    pos = torch.arange(L, device=dev)[None, :]
    in_str = pos < lengths[:, None]

    is_ws = torch.zeros_like(in_str)
    for w in _WS:
        is_ws |= mat == w
    non_ws = ~is_ws & in_str
    has_non_ws = non_ws.any(dim=1)
    i0 = torch.where(has_non_ws, torch.argmax(non_ws.to(torch.uint8),
                                              dim=1), lengths)
    at_i0 = mat.gather(1, i0.clamp(0, L - 1)[:, None])[:, 0]
    neg = has_non_ws & (at_i0 == ord("-"))
    start = i0 + neg.to(torch.int64)

    dv = _digit_value(mat, base)
    is_digit = (dv >= 0) & in_str
    after_start = pos >= start[:, None]
    # the digit run that starts exactly at `start`
    breaks = after_start & ~is_digit
    run = after_start & is_digit & (torch.cumsum(
        breaks.to(torch.int32), dim=1) == 0)

    # accumulate with u64 wraparound (cudf to_integers' overflow)
    val = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(L):
        val = torch.where(run[:, j], val * base + dv[:, j], val)
    val = torch.where(neg, -val, val)  # two's complement negation
    val = torch.where(run.any(dim=1), val, 0)

    validity = col.valid_mask() & (i0 < lengths)
    return Column(out_dtype, n, data=_narrow(val, out_dtype.torch_dtype),
                  validity=validity)


def from_integers_with_base(col: Column, base: int) -> Column:
    """Render integers in base 10 (signed decimal) or 16 (the unsigned
    bits in uppercase hex, no leading zeros). Every row renders its value,
    null rows too, as in the JAX package."""
    if base not in (10, 16):
        raise ValueError(f"Bases supported 10, 16; Actual: {base}")
    vals = col.to_numpy()
    if base == 10:
        parts = [str(v).encode() for v in vals.tolist()]
    else:
        mask = (1 << (vals.dtype.itemsize * 8)) - 1
        parts = [format(v & mask, "X").encode() for v in vals.tolist()]
    validity = None if col.validity is None else col.validity.cpu().numpy()
    return pack_byte_rows(parts, validity, device=col.device)
