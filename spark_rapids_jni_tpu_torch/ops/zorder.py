"""Hilbert curve indices (Delta OPTIMIZE ZORDER BY support; the JAX
package's ops/zorder.py).

``hilbert_index`` is Skilling's transposed-index algorithm ("Programming
the Hilbert curve") as whole-column int64 ops over all rows, with the
bit and dimension loops unrolled in Python, as the JAX package unrolls
them at trace time. The unsigned 32-bit values are held in int64 lanes
(torch has no uint32 arithmetic), the 64-bit index is assembled in int64
bits.

``interleave_bits`` returns ``LIST<UINT8>``, which the port does not store
yet: it raises naming ROADMAP A1.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table
from ..columnar.dtype import TypeId

_U32 = 0xFFFFFFFF


def interleave_bits(table: Union[Table, Sequence[Column]],
                    num_rows: Optional[int] = None) -> Column:
    """Z-order bit interleaving into a LIST<UINT8> column: not ported."""
    raise dt.not_ported("LIST columns", "A1")


def _u32(col: Column) -> torch.Tensor:
    """INT32 values as unsigned 32-bit bits in int64 lanes; nulls -> 0."""
    data = col.data.to(torch.int64) & _U32
    if col.validity is not None:
        data = torch.where(col.validity, data, 0)
    return data


def hilbert_index(num_bits: int,
                  table: Union[Table, Sequence[Column]]) -> Column:
    """d-dimensional Hilbert index of INT32 columns -> INT64."""
    cols = tuple(table.columns if isinstance(table, Table) else table)
    ncols = len(cols)
    if not (0 < num_bits <= 32):
        raise ValueError("the number of bits must be >0 and <= 32.")
    if num_bits * ncols > 64:
        raise ValueError("we only support up to 64 bits of output right now.")
    if ncols == 0:
        raise ValueError("at least one column is required.")
    if any(c.dtype.id is not TypeId.INT32 for c in cols):
        raise TypeError("All columns of the input table must be INT32.")

    n = cols[0].size
    mask_entry = (1 << num_bits) - 1
    x: List[torch.Tensor] = [_u32(c) & mask_entry for c in cols]

    # inverse undo
    q = 1 << (num_bits - 1)
    while q > 1:
        p = q - 1
        for i in range(ncols):
            cond = (x[i] & q) != 0
            t = (x[0] ^ x[i]) & p
            new_x0 = torch.where(cond, x[0] ^ p, x[0] ^ t)
            if i != 0:
                x[i] = torch.where(cond, x[i], x[i] ^ t)
            x[0] = new_x0
        q >>= 1

    # gray encode
    for i in range(1, ncols):
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros(n, dtype=torch.int64, device=cols[0].device)
    q = 1 << (num_bits - 1)
    while q > 1:
        t = torch.where((x[ncols - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    for i in range(ncols):
        x[i] = x[i] ^ t

    # transposed index -> one integer, MSB first; bit 63 lands as the
    # int64 sign bit, as the JAX package's uint64 -> int64 cast does
    b = torch.zeros(n, dtype=torch.int64, device=cols[0].device)
    b_index = num_bits * ncols - 1
    for i in range(num_bits):
        bit_mask = 1 << (num_bits - 1 - i)
        for j in range(ncols):
            bit = ((x[j] & bit_mask) != 0).to(torch.int64)
            b = b | (bit << b_index)
            b_index -= 1
    return Column(dt.INT64, n, data=b)
