"""JCUDF row <-> column conversion, fixed-width and STRING columns.

The JAX package's ops/row_conversion.py. The JCUDF row layout
(row_conversion.cu:88-137, RowConversion.java:44-118):

  * fixed-width region: columns in declaration order, each aligned to its
    own byte size; a STRING column takes an 8-byte slot, 4-byte aligned:
    its (offset, length) as two u32, the offset relative to the row start;
  * validity: byte-aligned right after the fixed region, bit c % 8 of byte
    c / 8 set when column c is valid;
  * string bytes: right after the validity (at ``size_per_row``), the
    string columns' bytes one after the other;
  * each row padded to 8 bytes (JCUDF_ROW_ALIGNMENT);
  * output split into LIST<INT8> batches of at most 2 GB (int32 offsets).

Rows -> words runs in kernel B3 (ops/kernels.rowconv_fixed_words), which
reads every column in place through a per-column pointer table and a plan
of pieces per output word (``_word_plan``); a STRING slot's offset and
length are two contiguous int32 lanes. Fixed-width rows are uniform: the
LIST<INT8> blob is a view of the kernel's int32[n, row_size/4] words.
Rows with strings are assembled batch by batch in torch (the JAX package
does this with XLA, not Pallas): a row matrix of each batch's rows padded
to the widest, flattened at 8-byte words (``_assemble_rowmat``), or, where
that matrix would be far larger than the rows (a skewed batch), a gather
of every output byte (``_assemble_bytes``). Words -> columns is a strided
view of the blob (or a gather from each row start) and one copy per
column; a string column's bytes come back by a gather of every byte.

Host reads, as in the JAX package: one sizing read per ``convert_to_rows``
of a table with strings (total bytes, longest row, each string column's
longest string), one per ``convert_from_rows``. Where the rows span
several batches the port adds one read of the batch boundaries, which it
finds on the device (``_device_boundaries``); the JAX package reads the
whole row-size array to the host instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table
from ..columnar.dtype import DType, TypeId
from ..columnar.strings import (densify_offsets, pad_width, padded_bytes,
                                row_of_position)
from ..memory.reservation import device_reservation, release_barrier
from ..utils.tracing import func_range
from . import kernels
from .kernels import PART_HI, PART_LO, PART_U8, PART_U16, PART_U32, PART_VALID

JCUDF_ROW_ALIGNMENT = 8
MAX_BATCH_BYTES = (1 << 31) - 1  # LIST<INT8> offsets are int32

# The JAX package's guards (its row_conversion.py):
# the row-matrix path pads every row of a batch to the batch's longest
# row; beyond 8x the rows' bytes (or rows over 4 KB) a batch takes the
# per-byte path, whose memory follows the bytes;
_ROWMAT_MAX_BLOWUP = 8
_ROWMAT_MAX_ROW_PAD = 4096
# and padding every string column to its global max length must stay
# within 8x the rows' bytes plus this floor, or the columns are padded per
# batch and the batch boundaries cut before jumbo rows (pad_blowup).
_MAT_BYTES_FLOOR = 64 << 20
# output bytes one step of the per-byte path indexes at a time
_BYTES_CHUNK = 1 << 26


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ColumnInfo:
    """Static per-schema layout of the JCUDF fixed-width region."""

    size_per_row: int               # fixed-width + validity bytes
    column_starts: Tuple[int, ...]  # per column byte offset in the row
    column_sizes: Tuple[int, ...]   # per column byte size (8 for STRING)
    validity_offset: int            # byte offset of the validity bytes
    variable_width_column_starts: Tuple[int, ...] = ()  # STRING slots


def compute_column_information(dtypes: Sequence[DType]) -> ColumnInfo:
    """Row layout from a schema (row_conversion.cu:1324)."""
    size_per_row = 0
    starts: List[int] = []
    sizes: List[int] = []
    var_starts: List[int] = []
    for d in dtypes:
        if d.id is TypeId.STRING:
            size, align = 8, 4
        elif d.is_fixed_width:
            size = align = d.itemsize
        else:
            raise ValueError(f"JCUDF rows support fixed-width and STRING "
                             f"columns, not {d.id}")
        size_per_row = _round_up(size_per_row, align)
        if d.id is TypeId.STRING:
            var_starts.append(size_per_row)
        starts.append(size_per_row)
        sizes.append(size)
        size_per_row += size
    validity_offset = size_per_row
    size_per_row += (len(dtypes) + 7) // 8
    return ColumnInfo(size_per_row, tuple(starts), tuple(sizes),
                      validity_offset, tuple(var_starts))


def _column_words(col: Column) -> List[int]:
    """The 32-bit reads of one element, low word first: the kernel's piece
    parts (ops/kernels.PART_*). A column of itemsize >= 4 gives one part
    per word it fills; a 1- or 2-byte column gives one part that the plan
    shifts into its byte lane."""
    return {8: [PART_LO, PART_HI], 4: [PART_U32], 2: [PART_U16],
            1: [PART_U8]}[col.dtype.itemsize]


def _string_lanes(table: Table, info: ColumnInfo
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(offset, length) ``int32[n]`` lanes of each STRING column's slot,
    contiguous (B3's pointer table reads a lane in place; a column of an
    [n, k] tensor would be a strided view): the offset is size_per_row
    plus the lengths of the row's earlier strings."""
    lanes: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for col in table:
        if col.dtype.id is TypeId.STRING:
            length = col.offsets[1:] - col.offsets[:-1]
            off = (torch.full_like(length, info.size_per_row) if not lanes
                   else lanes[-1][0] + lanes[-1][1])
            lanes.append((off, length))
    return lanes


def _word_plan(table: Table, info: ColumnInfo, var_lanes=None):
    """(cols, valids, plan): each column's values and validity, and the
    (word, column, part, shift) pieces of the fixed + validity region in
    word order — the one plan both B3 and its plain version execute.

    A STRING column's slot is two u32 lanes (``var_lanes``, by default
    ``_string_lanes``): its offset lane stands in the column's place (so
    the column's validity piece keeps its index), its length lane is an
    extra input column past the table's, with no validity. A DECIMAL128
    column's 16-byte slot is four u32 lanes the same way: its limbs, each
    copied out of the ``[n, 4]`` limb rows into a contiguous lane (B3
    reads a lane in place), limb 0 in the column's place."""
    if var_lanes is None:
        var_lanes = _string_lanes(table, info)
    ncols = table.num_columns
    cols = [c.data for c in table]
    valids = [c.validity for c in table]
    plan: List[Tuple[int, int, int, int]] = []
    n_str = 0
    for c, col in enumerate(table):
        o = info.column_starts[c]
        if col.dtype.id is TypeId.STRING:
            off, length = var_lanes[n_str]
            n_str += 1
            plan += [(o // 4, c, PART_U32, 0),
                     (o // 4 + 1, len(cols), PART_U32, 0)]
            cols[c] = off
            cols.append(length)
            valids.append(None)
            continue
        if col.dtype.id is TypeId.DECIMAL128:
            limbs = [col.data[:, j].contiguous() for j in range(4)]
            plan.append((o // 4, c, PART_U32, 0))
            cols[c] = limbs[0]
            for j in range(1, 4):
                plan.append((o // 4 + j, len(cols), PART_U32, 0))
                cols.append(limbs[j])
                valids.append(None)
            continue
        parts = _column_words(col)
        if info.column_sizes[c] >= 4:  # o is word-aligned (alignment=size)
            plan.extend((o // 4 + j, c, p, 0) for j, p in enumerate(parts))
        else:
            plan.append((o // 4, c, parts[0], 8 * (o % 4)))
    for c in range(ncols):
        bo = info.validity_offset + c // 8
        plan.append((bo // 4, c, PART_VALID, 8 * (bo % 4) + c % 8))
    plan.sort(key=lambda p: p[0])  # stable: in-word order is irrelevant
    return cols, valids, plan


def _build_fixed_words(table: Table, info: ColumnInfo, row_size: int,
                       var_lanes=None) -> torch.Tensor:
    """int32[n, row_size/4] fixed-width + validity words (kernel B3); the
    tail past size_per_row is zero."""
    cols, valids, plan = _word_plan(table, info, var_lanes)
    return kernels.rowconv_fixed_words(cols, valids, plan, row_size // 4,
                                       table.num_rows)


def _uniform_boundaries(n: int, row_size: int,
                        max_batch_bytes: int) -> List[int]:
    """Row boundaries [0, ..., n] of batches of at most max_batch_bytes
    of fixed-width rows: uniform rows, so the boundaries are analytic."""
    if n == 0 or row_size == 0:
        return [0, n]
    per_batch = max(max_batch_bytes // row_size, 1)
    return list(range(0, n, per_batch)) + [n]


def _batch_boundaries(row_sizes: np.ndarray, max_batch_bytes: int,
                      pad_blowup: Optional[int] = None) -> List[int]:
    """Row boundaries [0, ..., n] of batches whose bytes fit an int32
    offset column (build_batches, row_conversion.cu:1458), on the host:
    the JAX package's rule. Greedy fill; a row larger than the cap gets a
    batch of its own. With ``pad_blowup``, a batch whose rows padded to
    its longest row exceed ``pad_blowup`` times its bytes (plus
    _MAT_BYTES_FLOOR) is cut just before its longest row, so a jumbo row
    lands in a batch of its own."""
    n = len(row_sizes)
    if n == 0:
        return [0, 0]
    cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_sizes, out=cum[1:])
    bounds = [0]
    while bounds[-1] < n:
        s = bounds[-1]
        b = int(np.searchsorted(cum, cum[s] + max_batch_bytes,
                                side="right")) - 1
        if b == s:
            b += 1
        b = min(b, n)
        if pad_blowup is not None:
            while b > s + 1:
                w = _round_up(int(row_sizes[s:b].max()), 16)
                if (b - s) * w <= pad_blowup * int(cum[b] - cum[s]) \
                        + _MAT_BYTES_FLOOR:
                    break
                am = s + int(np.argmax(row_sizes[s:b]))
                b = am if am > s else s + 1
        bounds.append(b)
    return bounds


def _device_boundaries(cum: torch.Tensor, n: int, total: int, max_row: int,
                       max_batch_bytes: int) -> Tuple[List[int], List[int]]:
    """``_batch_boundaries``' greedy fill (no pad_blowup) on the device,
    over ``cum`` = int64[n+1] row starts: (boundaries, their byte
    offsets), read in one host transfer. Every batch but the last holds
    more than max_batch_bytes - max_row bytes, which bounds the steps;
    steps past the end stay at n."""
    if max_row > max_batch_bytes:
        steps = n
    else:
        steps = min(n, total // (max_batch_bytes - max_row + 1) + 1)
    s = torch.zeros(1, dtype=torch.int64, device=cum.device)
    picks = [s]
    for _ in range(steps):
        b = torch.searchsorted(cum, cum.index_select(0, s) + max_batch_bytes,
                               right=True) - 1
        s = torch.where(b == s, s + 1, b).clamp(max=n)
        picks.append(s)
    idx = torch.cat(picks)
    both = torch.cat([idx, cum.index_select(0, idx)]).tolist()
    bounds, starts = [0], [0]
    for b, at in zip(both[1:steps + 1], both[steps + 2:]):
        if b != bounds[-1]:
            bounds.append(b)
            starts.append(at)
    return bounds, starts


def _rows_column(words: torch.Tensor, row_size: int) -> Column:
    """LIST<INT8> column whose blob is a view of int32[nb, row_size/4]."""
    nb = words.shape[0]
    offsets = (torch.arange(nb + 1, dtype=torch.int32, device=words.device)
               * row_size)
    return _blob_rows_column(words.reshape(-1).view(torch.uint8), offsets)


def _blob_rows_column(blob: torch.Tensor, offsets: torch.Tensor) -> Column:
    """LIST<INT8> column over a uint8 blob and int32[nb+1] row offsets."""
    child = Column(dt.INT8, int(blob.shape[0]), data=blob.view(torch.int8))
    return Column.list_of(child, offsets)


@func_range()
def convert_to_rows(table: Table,
                    max_batch_bytes: int = MAX_BATCH_BYTES) -> List[Column]:
    """Columnar -> JCUDF rows (row_conversion.cu:1990).

    Returns one LIST<INT8> column per batch of at most ``max_batch_bytes``;
    batch k holds rows [bounds[k], bounds[k+1]) in table order, the
    boundaries of the JAX package's rule."""
    info = compute_column_information([c.dtype for c in table.columns])
    n = table.num_rows
    # peak ~ input + the padded string matrices + the bucket-padded blob
    # and its index arrays: the JAX package's estimate, unchanged
    # (reservation bracketing; see memory/reservation.py)
    blob_est = n * info.size_per_row + sum(
        c.data.numel() for c in table.columns
        if c.dtype.id is TypeId.STRING)
    est = 2 * table.device_nbytes() + (2 + 8) * pad_width(blob_est, 1 << 16)
    with device_reservation(est) as took:
        return release_barrier(_convert_to_rows(table, info, n,
                                                max_batch_bytes), took)


def _convert_to_rows(table: Table, info: ColumnInfo, n: int,
                     max_batch_bytes: int) -> List[Column]:
    if info.variable_width_column_starts:
        return _convert_to_rows_strings(table, info, max_batch_bytes)
    row_size = _round_up(info.size_per_row, JCUDF_ROW_ALIGNMENT)
    words = _build_fixed_words(table, info, row_size)
    bounds = _uniform_boundaries(n, row_size, max_batch_bytes)
    return [_rows_column(words[b0:b1], row_size)
            for b0, b1 in zip(bounds[:-1], bounds[1:])]


def _row_sizes(lanes) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64[n] JCUDF row sizes, int64[n+1] row starts) of a table
    with the string lanes ``lanes`` (of ``_string_lanes``)."""
    off, length = lanes[-1]
    ends = off.to(torch.int64) + length  # spr + the row's string bytes
    row_sizes = (ends + JCUDF_ROW_ALIGNMENT - 1) \
        // JCUDF_ROW_ALIGNMENT * JCUDF_ROW_ALIGNMENT
    cum = torch.zeros(row_sizes.shape[0] + 1, dtype=torch.int64,
                      device=row_sizes.device)
    torch.cumsum(row_sizes, 0, out=cum[1:])
    return row_sizes, cum


def _convert_to_rows_strings(table: Table, info: ColumnInfo,
                             max_batch_bytes: int) -> List[Column]:
    """convert_to_rows of a table with STRING columns (the JAX package's
    variable-width path)."""
    n = table.num_rows
    dev = table.device
    if n == 0:
        return [_blob_rows_column(
            torch.zeros(0, dtype=torch.uint8, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))]
    spr = info.size_per_row
    strings = [c for c in table if c.dtype.id is TypeId.STRING]
    lanes = _string_lanes(table, info)
    row_sizes, cum = _row_sizes(lanes)
    fixed_words = _build_fixed_words(table, info, _round_up(spr, 8), lanes)
    # the one sizing read: total bytes, longest row, longest strings
    head = torch.cat([cum[-1:], row_sizes.max().reshape(1)]
                     + [length.max().to(torch.int64).reshape(1)
                        for _, length in lanes]).tolist()
    total_all, max_row, max_lens = head[0], head[1], head[2:]
    # padding each string column to its global max must stay near the
    # rows' bytes; else pad per batch and cut batches before jumbo rows
    global_ok = (sum(n * pad_width(ml) for ml in max_lens)
                 <= _ROWMAT_MAX_BLOWUP * total_all + _MAT_BYTES_FLOOR)
    if total_all <= max_batch_bytes and global_ok:
        bounds, starts = [0, n], [0, total_all]
        max_rows = [max_row]
    elif global_ok:
        bounds, starts = _device_boundaries(cum, n, total_all, max_row,
                                            max_batch_bytes)
        max_rows = [max_row] * (len(bounds) - 1)
    else:
        sizes = row_sizes.cpu().numpy()  # the JAX package's read too
        bounds = _batch_boundaries(sizes, max_batch_bytes,
                                   pad_blowup=_ROWMAT_MAX_BLOWUP)
        starts = [0] + np.cumsum([int(sizes[b0:b1].sum()) for b0, b1 in
                                  zip(bounds[:-1], bounds[1:])]).tolist()
        max_rows = [int(sizes[b0:b1].max()) for b0, b1 in
                    zip(bounds[:-1], bounds[1:])]
    padded = ([padded_bytes(c, max_len=ml) for c, ml in
               zip(strings, max_lens)] if global_ok else None)
    out = []
    for k, (b0, b1) in enumerate(zip(bounds[:-1], bounds[1:])):
        total = starts[k + 1] - starts[k]
        if total >= 1 << 31:
            raise ValueError(f"a row of {total} bytes exceeds the int32 "
                             f"offsets of a LIST<INT8> batch")
        roffs = (cum[b0:b1 + 1] - starts[k]).to(torch.int32)
        if padded is not None:
            mats = [mat[b0:b1] for mat, _ in padded]
        else:  # batch-local widths
            mats = []
            for c in strings:
                ho = c.host_offsets()
                ml = int((ho[b0 + 1:b1 + 1] - ho[b0:b1]).max())
                mats.append(densify_offsets(c.data, c.offsets[b0:b1 + 1],
                                            pad_width(ml))[0])
        batch_lanes = [(off[b0:b1], length[b0:b1]) for off, length in lanes]
        row_pad = _round_up(max_rows[k], 16)
        if (row_pad <= _ROWMAT_MAX_ROW_PAD
                and (b1 - b0) * row_pad <= _ROWMAT_MAX_BLOWUP * total):
            blob = _assemble_rowmat(fixed_words[b0:b1], mats, batch_lanes,
                                    roffs, total, row_pad, spr)
        else:
            blob = _assemble_bytes(fixed_words[b0:b1], mats, batch_lanes,
                                   roffs, total, spr)
        out.append(_blob_rows_column(blob, roffs))
    return out


def _assemble_rowmat(fixed_words: torch.Tensor, mats, lanes,
                     roffs: torch.Tensor, total: int, row_pad: int,
                     spr: int) -> torch.Tensor:
    """The JCUDF bytes of a batch: a ``uint8[nb, row_pad]`` matrix of its
    rows (the fixed region, then each row's strings at their offsets),
    flattened tight at 8-byte words (rows are 8-byte aligned) by one
    gather of total/8 words (the JAX package's _assemble_blob_rowmat)."""
    nb = fixed_words.shape[0]
    dev = fixed_words.device
    rowmat = torch.zeros((nb, row_pad), dtype=torch.uint8, device=dev)
    rowmat[:, :spr] = fixed_words.view(torch.uint8)[:, :spr]
    if len(mats) == 1:
        # one string column starts at spr; its padded bytes are zero past
        # each string, so the window is a copy (measured against
        # _place_strings on the card: PERF.md)
        w = min(mats[0].shape[1], row_pad - spr)
        rowmat[:, spr:spr + w] = mats[0][:, :w]
    else:
        _place_strings(rowmat, mats, lanes, spr)
    per_row = row_pad // 8
    words = rowmat.view(torch.int64).reshape(-1)  # [nb * row_pad / 8]
    word_offs = roffs // 8
    row = row_of_position(word_offs, total // 8)
    itype = torch.int64 if nb * per_row >= 1 << 31 else torch.int32
    src = (row.to(itype) * per_row - word_offs.index_select(0, row).to(itype)
           + torch.arange(total // 8, dtype=itype, device=dev))
    return words.index_select(0, src).view(torch.uint8)


def _place_strings(rowmat: torch.Tensor, mats, lanes, spr: int) -> None:
    """Write each row's strings into ``rowmat[:, spr:]`` at their
    offsets, by a masked gather from each padded matrix, in row chunks."""
    nb, row_pad = rowmat.shape
    width = row_pad - spr
    at = torch.arange(width, dtype=torch.int32, device=rowmat.device)
    step = max(1, _BYTES_CHUNK // width)
    for r0 in range(0, nb, step):
        win = rowmat[r0:r0 + step, spr:]
        for mat, (off, length) in zip(mats, lanes):
            j = at - (off[r0:r0 + step, None] - spr)
            inside = (j >= 0) & (j < length[r0:r0 + step, None])
            got = mat[r0:r0 + step].gather(
                1, j.clamp(0, mat.shape[1] - 1).to(torch.int64))
            win.copy_(torch.where(inside, got, win))


def _assemble_bytes(fixed_words: torch.Tensor, mats, lanes,
                    roffs: torch.Tensor, total: int,
                    spr: int) -> torch.Tensor:
    """The JCUDF bytes of a skewed batch by a gather of every output byte
    (the JAX package's _assemble_blob), in chunks of _BYTES_CHUNK bytes:
    memory follows the batch's bytes, not its padded rows."""
    dev = fixed_words.device
    fixed = fixed_words.view(torch.uint8)
    fw = fixed.shape[1]
    fixed = fixed.reshape(-1)
    ends = roffs[1:].to(torch.int64)
    starts = roffs.to(torch.int64)
    blob = torch.empty(total, dtype=torch.uint8, device=dev)
    for k0 in range(0, total, _BYTES_CHUNK):
        k = torch.arange(k0, min(total, k0 + _BYTES_CHUNK), device=dev)
        row = torch.searchsorted(ends, k, right=True)
        rel = k - starts.index_select(0, row)
        byte = torch.where(rel < spr, fixed.index_select(
            0, row * fw + rel.clamp(max=spr - 1)), 0).to(torch.uint8)
        for mat, (off, length) in zip(mats, lanes):
            L = mat.shape[1]
            j = rel - off.index_select(0, row)
            inside = (j >= 0) & (j < length.index_select(0, row))
            got = mat.reshape(-1).index_select(0, row * L + j.clamp(0, L - 1))
            byte = torch.where(inside, got, byte)
        blob[k0:k0 + k.shape[0]] = byte
    return blob


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
    if d.id is TypeId.DECIMAL128:
        return Column(d, n, data=_dense(words[:, word0:word0 + 4]),
                      validity=validity)
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
    a view of the blob; other offsets take a gather from each row start
    (rows with strings always do: row starts are 8-byte aligned)."""
    n = rows.size
    row_size = _round_up(info.size_per_row, JCUDF_ROW_ALIGNMENT)
    blob = rows.children[0].data
    offsets = rows.offsets.to(torch.int64)
    dev = blob.device
    if not info.variable_width_column_starts:
        uniform = torch.arange(n + 1, dtype=torch.int64,
                               device=dev) * row_size
        if blob.numel() == n * row_size and torch.equal(offsets, uniform):
            return blob.view(torch.int32).view(n, row_size // 4)
    nwords = (info.size_per_row + 3) // 4
    blob_words = blob[:blob.numel() // 4 * 4].view(torch.int32)
    wpos = (offsets[:-1] // 4)[:, None] + torch.arange(nwords, device=dev)
    return blob_words[wpos.clamp(0, max(blob_words.numel() - 1, 0))]


def _extract_string_bytes(blob: torch.Tensor, row_starts: torch.Tensor,
                          off_in_row: torch.Tensor, out_offsets: torch.Tensor,
                          total: int) -> torch.Tensor:
    """One string column's characters out of a batch's JCUDF bytes: a
    gather of every output byte k from its row's start + the slot's
    offset + k's place in the string (the JAX package's
    _extract_string_bytes). int32 positions: a batch is under 2^31
    bytes."""
    base = row_starts + off_in_row - out_offsets[:-1]  # int32 per row
    row = row_of_position(out_offsets, total)
    src = base.index_select(0, row)
    del row
    src += torch.arange(total, dtype=torch.int32, device=blob.device)
    return blob.index_select(0, src)


@func_range()
def convert_from_rows(rows: Column, dtypes: Sequence[DType]) -> Table:
    """JCUDF rows -> columnar (row_conversion.cu:2145). ``rows`` is a
    LIST<INT8> column as convert_to_rows returns. A column with no null
    row comes back with validity None, as in the JAX package. One host
    read for the whole table: the columns' any-null flags and the string
    columns' byte totals."""
    if rows.dtype.id is not TypeId.LIST:
        raise ValueError("expected a LIST<INT8> row column")
    with device_reservation(2 * rows.device_nbytes()) as took:
        return release_barrier(_convert_from_rows(rows, dtypes), took)


def _convert_from_rows(rows: Column, dtypes: Sequence[DType]) -> Table:
    info = compute_column_information(dtypes)
    n = rows.size
    words = _row_words(rows, info)
    valid = _extract_validity_words(words, info, len(dtypes))
    reads = [(~valid).any(dim=0).to(torch.int64)]
    str_offsets = {}
    for c, d in enumerate(dtypes):
        if d.id is TypeId.STRING:
            out = torch.zeros(n + 1, dtype=torch.int32, device=words.device)
            torch.cumsum(words[:, info.column_starts[c] // 4 + 1], 0,
                         dtype=torch.int32, out=out[1:])
            str_offsets[c] = out
            reads.append(out[-1:].to(torch.int64))
    head = torch.cat(reads).tolist()  # the one host sync
    any_null = head[:len(dtypes)]
    totals = iter(head[len(dtypes):])
    blob = rows.children[0].data.view(torch.uint8)
    cols = []
    for c, d in enumerate(dtypes):
        o = info.column_starts[c]
        vmask = _dense(valid[:, c]) if any_null[c] else None
        if d.id is TypeId.STRING:
            total = next(totals)
            data = (_extract_string_bytes(blob, rows.offsets[:-1],
                                          words[:, o // 4], str_offsets[c],
                                          total) if total else
                    torch.zeros(0, dtype=torch.uint8, device=blob.device))
            cols.append(Column(d, n, data=data, validity=vmask,
                               offsets=str_offsets[c]))
        else:
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
