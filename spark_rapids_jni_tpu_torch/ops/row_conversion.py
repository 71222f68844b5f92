"""JCUDF row <-> column conversion, fixed-width columns.

The fixed-width part of the JAX package's ops/row_conversion.py. The JCUDF
row layout (row_conversion.cu:88-137, RowConversion.java:44-118):

  * fixed-width region: columns in declaration order, each aligned to its
    own byte size;
  * validity: byte-aligned right after the fixed region, bit c % 8 of byte
    c / 8 set when column c is valid;
  * each row padded to 8 bytes (JCUDF_ROW_ALIGNMENT);
  * output split into LIST<INT8> batches of at most 2 GB (int32 offsets).

Rows -> words runs in kernel B3 (ops/kernels.rowconv_fixed_words), which
reads every column in place through a per-column pointer table and a plan
of pieces per output word (``_word_plan``). The LIST<INT8> blob is a view
of the kernel's int32[n, row_size/4] words. Words -> columns is a strided
view of the blob and one copy per column. STRING columns are queued
(ROADMAP A9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table
from ..columnar.dtype import DType, TypeId
from . import kernels
from .kernels import PART_HI, PART_LO, PART_U8, PART_U16, PART_U32, PART_VALID

JCUDF_ROW_ALIGNMENT = 8
MAX_BATCH_BYTES = (1 << 31) - 1  # LIST<INT8> offsets are int32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ColumnInfo:
    """Static per-schema layout of the JCUDF fixed-width region."""

    size_per_row: int               # fixed-width + validity bytes
    column_starts: Tuple[int, ...]  # per column byte offset in the row
    column_sizes: Tuple[int, ...]   # per column byte size
    validity_offset: int            # byte offset of the validity bytes


def compute_column_information(dtypes: Sequence[DType]) -> ColumnInfo:
    """Row layout from a schema (row_conversion.cu:1324)."""
    size_per_row = 0
    starts: List[int] = []
    sizes: List[int] = []
    for d in dtypes:
        if d.id is TypeId.STRING:
            raise dt.not_ported("STRING row conversion", "A9, row "
                                "conversion strings")
        if not d.is_fixed_width:
            raise ValueError(f"JCUDF rows support fixed-width and STRING "
                             f"columns, not {d.id}")
        size = d.itemsize
        size_per_row = _round_up(size_per_row, size)
        starts.append(size_per_row)
        sizes.append(size)
        size_per_row += size
    validity_offset = size_per_row
    size_per_row += (len(dtypes) + 7) // 8
    return ColumnInfo(size_per_row, tuple(starts), tuple(sizes),
                      validity_offset)


def _column_words(col: Column) -> List[int]:
    """The 32-bit reads of one element, low word first: the kernel's piece
    parts (ops/kernels.PART_*). A column of itemsize >= 4 gives one part
    per word it fills; a 1- or 2-byte column gives one part that the plan
    shifts into its byte lane."""
    return {8: [PART_LO, PART_HI], 4: [PART_U32], 2: [PART_U16],
            1: [PART_U8]}[col.dtype.itemsize]


def _word_plan(table: Table, info: ColumnInfo):
    """(cols, valids, plan): each column's values and validity, and the
    (word, column, part, shift) pieces of the fixed + validity region in
    word order — the one plan both B3 and its plain version execute."""
    plan: List[Tuple[int, int, int, int]] = []
    for c, col in enumerate(table):
        o = info.column_starts[c]
        parts = _column_words(col)
        if info.column_sizes[c] >= 4:  # o is word-aligned (alignment=size)
            plan.extend((o // 4 + j, c, p, 0) for j, p in enumerate(parts))
        else:
            plan.append((o // 4, c, parts[0], 8 * (o % 4)))
    for c in range(table.num_columns):
        bo = info.validity_offset + c // 8
        plan.append((bo // 4, c, PART_VALID, 8 * (bo % 4) + c % 8))
    plan.sort(key=lambda p: p[0])  # stable: in-word order is irrelevant
    return ([c.data for c in table], [c.validity for c in table], plan)


def _build_fixed_words(table: Table, info: ColumnInfo,
                       row_size: int) -> torch.Tensor:
    """int32[n, row_size/4] fixed-width + validity words (kernel B3); the
    tail past size_per_row is zero."""
    cols, valids, plan = _word_plan(table, info)
    return kernels.rowconv_fixed_words(cols, valids, plan, row_size // 4,
                                       table.num_rows)


def _batch_boundaries(n: int, row_size: int,
                      max_batch_bytes: int) -> List[int]:
    """Row boundaries [0, ..., n] of batches of at most max_batch_bytes
    (build_batches, row_conversion.cu:1458). Fixed-width rows are uniform,
    so the boundaries are analytic."""
    if n == 0 or row_size == 0:
        return [0, n]
    per_batch = max(max_batch_bytes // row_size, 1)
    return list(range(0, n, per_batch)) + [n]


def _rows_column(words: torch.Tensor, row_size: int) -> Column:
    """LIST<INT8> column whose blob is a view of int32[nb, row_size/4]."""
    nb = words.shape[0]
    blob = words.reshape(-1).view(torch.int8)
    offsets = (torch.arange(nb + 1, dtype=torch.int32, device=words.device)
               * row_size)
    child = Column(dt.INT8, int(blob.shape[0]), data=blob)
    return Column.list_of(child, offsets)


def convert_to_rows(table: Table,
                    max_batch_bytes: int = MAX_BATCH_BYTES) -> List[Column]:
    """Columnar -> JCUDF rows (row_conversion.cu:1990).

    Returns one LIST<INT8> column per batch of at most ``max_batch_bytes``;
    batch k holds rows [bounds[k], bounds[k+1]) in table order."""
    info = compute_column_information([c.dtype for c in table.columns])
    n = table.num_rows
    row_size = _round_up(info.size_per_row, JCUDF_ROW_ALIGNMENT)
    words = _build_fixed_words(table, info, row_size)
    bounds = _batch_boundaries(n, row_size, max_batch_bytes)
    return [_rows_column(words[b0:b1], row_size)
            for b0, b1 in zip(bounds[:-1], bounds[1:])]


def convert_to_rows_fixed_width_optimized(
        table: Table, max_batch_bytes: int = MAX_BATCH_BYTES) -> List[Column]:
    """Fixed-width-only entry (row_conversion.cu:2053): the same layout,
    with the reference's limits (<100 columns, rows of at most 1 KB)."""
    if table.num_columns >= 100:
        raise ValueError("fixed-width-optimized path supports <100 columns")
    for c in table:
        if not c.dtype.is_fixed_width:
            raise ValueError("fixed-width-optimized path requires "
                             "fixed-width columns")
    info = compute_column_information([c.dtype for c in table.columns])
    if _round_up(info.size_per_row, JCUDF_ROW_ALIGNMENT) > 1024:
        raise ValueError("row size exceeds 1KB limit")
    return convert_to_rows(table, max_batch_bytes)


def _extract_validity_words(words: torch.Tensor, info: ColumnInfo,
                            ncols: int) -> torch.Tensor:
    """int32[n, W] row words -> bool[n, ncols] validity."""
    nbytes = (ncols + 7) // 8
    vbytes = torch.stack(
        [(words[:, (info.validity_offset + k) // 4]
          >> (8 * ((info.validity_offset + k) % 4))) & 0xFF
         for k in range(nbytes)], dim=1)                  # int32[n, nbytes]
    shifts = torch.arange(8, dtype=torch.int32, device=words.device)
    bits = (vbytes[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], nbytes * 8)[:, :ncols].bool()


def _dense(t: torch.Tensor) -> torch.Tensor:
    """A copy with dense strides. (``contiguous()`` keeps a one-row slice
    of the blob as a strided view, which dtype views then refuse.)"""
    return t.clone(memory_format=torch.contiguous_format)


def _words_to_column(words: torch.Tensor, word0: int, byte_off: int,
                     d: DType, validity: Optional[torch.Tensor]) -> Column:
    """One column out of int32[n, W] row words (inverse of the plan):
    word0 = the column's first word, byte_off = its byte within that word
    (non-zero only for 1- and 2-byte columns)."""
    n = words.shape[0]
    if d.itemsize == 8:
        data = _dense(words[:, word0:word0 + 2]).view(torch.int64)
        data = data.reshape(n).view(d.torch_dtype)
    elif d.itemsize == 4:
        data = _dense(words[:, word0]).view(d.torch_dtype)
    else:
        lane = words[:, word0] >> (8 * byte_off)
        if d.itemsize == 2:
            data = (lane & 0xFFFF).to(torch.int16).view(d.torch_dtype)
        else:
            data = (lane & 0xFF).to(torch.uint8).view(d.torch_dtype)
    return Column(d, n, data=data, validity=validity)


def _row_words(rows: Column, info: ColumnInfo) -> torch.Tensor:
    """int32[n, W] words of each row's fixed + validity region. Rows of a
    fixed-width schema are uniform (row_size each), and then the words are
    a view of the blob; other offsets take a gather from each row start."""
    n = rows.size
    row_size = _round_up(info.size_per_row, JCUDF_ROW_ALIGNMENT)
    blob = rows.children[0].data
    offsets = rows.offsets.to(torch.int64)
    dev = blob.device
    uniform = torch.arange(n + 1, dtype=torch.int64, device=dev) * row_size
    if blob.numel() == n * row_size and torch.equal(offsets, uniform):
        return blob.view(torch.int32).view(n, row_size // 4)
    nwords = (info.size_per_row + 3) // 4
    blob_words = blob[:blob.numel() // 4 * 4].view(torch.int32)
    wpos = (offsets[:-1] // 4)[:, None] + torch.arange(nwords, device=dev)
    return blob_words[wpos.clamp(0, max(blob_words.numel() - 1, 0))]


def convert_from_rows(rows: Column, dtypes: Sequence[DType]) -> Table:
    """JCUDF rows -> columnar (row_conversion.cu:2145). ``rows`` is a
    LIST<INT8> column as convert_to_rows returns. A column with no null
    row comes back with validity None, as in the JAX package."""
    if rows.dtype.id is not TypeId.LIST:
        raise ValueError("expected a LIST<INT8> row column")
    info = compute_column_information(dtypes)
    words = _row_words(rows, info)
    valid = _extract_validity_words(words, info, len(dtypes))
    any_null = (~valid).any(dim=0).tolist()  # the one host sync
    cols = []
    for c, d in enumerate(dtypes):
        o = info.column_starts[c]
        vmask = _dense(valid[:, c]) if any_null[c] else None
        cols.append(_words_to_column(words, o // 4, o % 4, d, vmask))
    return Table(tuple(cols))


def convert_from_rows_fixed_width_optimized(
        rows: Column, dtypes: Sequence[DType]) -> Table:
    """Fixed-width-only inverse (row_conversion.cu:2444)."""
    for d in dtypes:
        if not d.is_fixed_width:
            raise ValueError("fixed-width-optimized path requires "
                             "fixed-width columns")
    return convert_from_rows(rows, dtypes)
