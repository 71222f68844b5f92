"""Z-order bit interleaving and Hilbert curve indices (Delta OPTIMIZE
ZORDER BY support; the JAX package's ops/zorder.py).

``interleave_bits`` interleaves the bits of same-typed fixed-width
columns, column 0 most significant, into a ``LIST<UINT8>`` column of
``itemsize x ncols`` bytes a row. The JAX package builds ``[n, nbits,
ncols]`` bit planes through uint64 lanes; here the output is built a
byte of the inputs at a time. Output bit ``t`` of a row is bit ``t //
ncols`` (from the most significant) of column ``t % ncols``, so byte
``i`` (from the most significant) of every column spreads into output
bytes ``[i x ncols, (i + 1) x ncols)``: column ``c``'s bit ``j`` of it to
that window's bit ``j x ncols + c``. A table of 256 x ncols spreads
(``_spread_table``) turns each input byte into its window's bits by one
gather, and the columns' spreads, whose bits are disjoint, add up to
the window. No tensor is wider than ncols times the output.

``hilbert_index`` is Skilling's transposed-index algorithm ("Programming
the Hilbert curve") as whole-column int64 ops over all rows, with the
bit and dimension loops unrolled in Python, as the JAX package unrolls
them at trace time. The unsigned 32-bit values are held in int64 lanes
(torch has no uint32 arithmetic), the 64-bit index is assembled in int64
bits.

"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table, resolve_device
from ..columnar.dtype import TypeId

_U32 = 0xFFFFFFFF
_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _spread_table(ncols: int, dev: torch.device) -> torch.Tensor:
    """uint8[ncols x 256, ncols]: row ``c x 256 + v`` is byte value v of
    column c spread over an ncols-byte window, its bit j (from the top) at
    the window's bit ``j x ncols + c`` (from the top)."""
    v = np.arange(256)
    table = np.zeros((ncols, 256, ncols), np.uint8)
    for c in range(ncols):
        for j in range(8):
            p = j * ncols + c
            table[c, :, p // 8] |= (((v >> (7 - j)) & 1)
                                    << (7 - p % 8)).astype(np.uint8)
    return torch.from_numpy(table.reshape(ncols * 256, ncols)).to(dev)


def _big_endian_bytes(col: Column) -> torch.Tensor:
    """uint8[n, itemsize]: each value's bits, most significant byte
    first; null rows 0."""
    size = col.dtype.itemsize
    if size not in _VIEW or col.data is None or col.data.dim() != 1:
        raise TypeError("Only flat fixed width columns can be used")
    data = col.data.view(_VIEW[size])
    if col.validity is not None:
        data = torch.where(col.validity, data, 0)
    return data.contiguous().view(torch.uint8).reshape(-1, size).flip(1)


def interleave_bits(table: Union[Table, Sequence[Column]],
                    num_rows: Optional[int] = None,
                    device="cuda") -> Column:
    """Interleave the bits of same-typed fixed-width columns, column 0
    most significant, into a LIST<UINT8> column (zorder.cu:138-222;
    deltalake's interleaveBits). With zero columns the reference
    (ZOrder.interleaveBits(numRows)) gives ``num_rows`` empty lists, on
    ``device`` (no column says where)."""
    cols = tuple(table.columns if isinstance(table, Table) else table)
    if not cols:
        if num_rows is None:
            raise ValueError("The input table must have at least one column"
                             " (or pass num_rows for the 0-column form).")
        dev = resolve_device(device)
        child = Column(dt.UINT8, 0, data=torch.zeros(0, dtype=torch.uint8,
                                                     device=dev))
        return Column.list_of(child, torch.zeros(num_rows + 1,
                                                 dtype=torch.int32,
                                                 device=dev))
    if any(not c.dtype.is_fixed_width for c in cols):
        raise TypeError("Only fixed width columns can be used")
    tid = cols[0].dtype.id
    if any(c.dtype.id is not tid for c in cols):
        raise TypeError("All columns of the input table must be the same "
                        "type.")
    n, ncols = cols[0].size, len(cols)
    size = cols[0].dtype.itemsize
    stride = size * ncols
    if n * stride >= 1 << 31:
        raise ValueError("interleaved LIST<UINT8> column exceeds int32 "
                         "offsets")
    planes = torch.stack([_big_endian_bytes(c) for c in cols], dim=1)
    dev = planes.device
    table = _spread_table(ncols, dev)
    first = torch.arange(ncols, dtype=torch.int32, device=dev) * 256
    out = torch.empty((n, stride), dtype=torch.uint8, device=dev)
    for i in range(size):
        idx = planes[:, :, i].to(torch.int32) + first        # [n, ncols]
        spread = table.index_select(0, idx.reshape(-1)).view(n, ncols,
                                                             ncols)
        out[:, i * ncols:(i + 1) * ncols] = spread.sum(1, dtype=torch.uint8)
    child = Column(dt.UINT8, n * stride, data=out.reshape(-1))
    offsets = torch.arange(n + 1, dtype=torch.int32, device=dev) * stride
    return Column.list_of(child, offsets)


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
