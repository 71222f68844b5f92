"""Multi-key table sort and row gather (the JAX package's ops/sort.py).

Every key column becomes one or more int64 *monotone lanes* — signed
int64 order over a lane is the key's Spark order — and the lanes are
sorted from the least significant to the most significant with stable
sorts. That is the permutation the JAX package's stable lexsort gives:
rows ordered by their keys, ties in row order. Descending flips a lane
with ``~``; a null lane above a column's value lanes places its nulls.
A STRING key gives one lane per 8 bytes of its zero-padded bytes
(columnar/strings.padded_bytes), big-endian: the order of the padded
bytes, the JAX package's (its lanes hold 4 bytes each). A string that ends
in NUL bytes ties with its prefix and keeps its input order, as there.
A DECIMAL128 key gives two lanes, its high 64 bits (signed) and its low
64 bits (unsigned). A DICT32 key sorts by its entries' ranks (one int32
gather in place of the byte lanes), a FOR key by its codes (one reference: code order is value
order); an RLE key is decoded to rows first, as is an RLE or FOR column
that a gather reorders (a permutation keeps neither runs nor packing).
A LIST or STRUCT is no sort key (its type id is in no lane table: the
JAX package's ``KeyError``); a gather carries one, a LIST through its
rows' element ranges (``_segment_positions``), a STRUCT field by field.

``sort_lanes`` and ``select_topk_core`` are plan cores (plan/registry.py):
the fused plan engine composes them, so the eager and fused paths order
rows through the same lanes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..columnar import encodings as enc
from ..columnar.column import Column, Table
from ..columnar.dtype import TypeId
from ..columnar.strings import padded_bytes, row_of_position
from ..memory.reservation import device_reservation, release_barrier
from ..plan.registry import plan_core
from ..utils.tracing import func_range
from .hashing import _f32_bits, _f64_bits

_SIGN64 = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def _monotone_unsigned(col: Column) -> List[torch.Tensor]:
    """int64 lane(s) for one key column, most significant first, whose
    signed order is the order of the JAX package's unsigned lane: signed
    values as they are, unsigned values zero-extended (UINT64 with its
    sign bit flipped), floats through the IEEE total-order transform after
    NaN canonicalization and -0.0 folding. Null rows may hold anything
    (the null lane masks them)."""
    tid = col.dtype.id
    data = col.data
    if tid is TypeId.STRING:
        mat, _ = padded_bytes(col)  # L is a multiple of 8
        return [w ^ _SIGN64 for w in _big_endian_words(mat)]
    if tid is TypeId.FLOAT64:
        bits = _f64_bits(data, normalize_zero=True)
        ukey = torch.where(bits < 0, ~bits, bits | _SIGN64)
        return [ukey ^ _SIGN64]
    if tid is TypeId.FLOAT32:
        bits = _f32_bits(data, normalize_zero=True).to(torch.int64)
        ukey = torch.where(bits < 0, ~bits, bits | (1 << 31))
        return [ukey & 0xFFFFFFFF]
    if tid is TypeId.DICT32:
        # the once-per-dictionary rank permutation; raw codes carry no order
        ranks = col.children[1].data
        nd = int(ranks.shape[0])
        if nd == 0:  # an empty dictionary: every row is null
            return [torch.zeros(col.size, dtype=torch.int64,
                                device=data.device)]
        return [ranks.index_select(0, data.to(torch.int64).clamp(
            0, nd - 1)).to(torch.int64)]
    if tid in (TypeId.FOR32, TypeId.FOR64):
        return [enc.for_codes(col)]
    if tid is TypeId.DECIMAL128:
        from .int128 import words
        w = words(data)  # [n, 2]: low, high
        return [w[:, 1].contiguous(), w[:, 0] ^ _SIGN64]
    if tid is TypeId.UINT64:
        return [data ^ _SIGN64]
    if tid is TypeId.UINT32:
        return [data.to(torch.int64) & 0xFFFFFFFF]
    if tid is TypeId.UINT16:
        return [data.to(torch.int64) & 0xFFFF]
    col.dtype.require_stored()
    # signed integers, decimals, timestamps; BOOL8/UINT8 are stored uint8
    return [data.to(torch.int64)]


def _big_endian_words(mat: torch.Tensor) -> List[torch.Tensor]:
    """The int64 words of each 8 bytes of ``uint8[n, L]`` rows read
    big-endian, as contiguous columns, first bytes first: their unsigned
    order is the order of the bytes."""
    n, L = mat.shape
    x = mat.view(torch.int64)  # little-endian words, [n, L / 8]
    m8, m16 = 0x00FF00FF00FF00FF, 0x0000FFFF0000FFFF
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    x = ((x & m16) << 16) | ((x >> 16) & m16)
    x = (x << 32) | ((x >> 32) & 0xFFFFFFFF)
    return [x[:, c].contiguous() for c in range(L // 8)]


@plan_core("sort_lanes")
def sort_lanes(keys: Sequence[Column],
               ascending: Optional[Sequence[bool]] = None,
               nulls_first: Optional[Sequence[bool]] = None
               ) -> List[torch.Tensor]:
    """Monotone lanes of a key set, least significant FIRST (the primary
    key's lanes come last)."""
    if ascending is None:
        ascending = [True] * len(keys)
    if nulls_first is None:
        nulls_first = list(ascending)
    lanes: List[torch.Tensor] = []
    for col, asc, nf in reversed(list(zip(keys, ascending, nulls_first))):
        if enc.is_rle(col):
            col = enc.decoded_rows(col)  # a per-row null lane is needed
        value_lanes = _monotone_unsigned(col)
        if not asc:
            value_lanes = [~v for v in value_lanes]
        lanes.extend(reversed(value_lanes))
        if col.validity is not None:
            lanes.append(torch.where(col.validity, 1 if nf else 0,
                                     0 if nf else 1).to(torch.int64))
    return lanes


def sort_order(keys: Sequence[Column],
               ascending: Optional[Sequence[bool]] = None,
               nulls_first: Optional[Sequence[bool]] = None
               ) -> torch.Tensor:
    """Stable int64 order indices sorting by ``keys[0]`` then the rest.
    Defaults follow Spark SQL: ascending, NULLS FIRST."""
    return lexsort(sort_lanes(keys, ascending, nulls_first), keys[0].size,
                   keys[0].device)


def lexsort(lanes: Sequence[torch.Tensor], n: int,
            device: torch.device) -> torch.Tensor:
    """int64 permutation ordering rows by ``lanes`` (least significant
    first, as ``sort_lanes`` returns them): one stable sort per lane, ties
    in row order."""
    order = torch.arange(n, dtype=torch.int64, device=device)
    for lane in lanes:
        order = order.index_select(
            0, torch.sort(lane.index_select(0, order), stable=True).indices)
    return order


def gather(col: Column, idx: torch.Tensor) -> Column:
    """Rows ``idx`` (int64, in range) of a column. DICT32 gathers its codes
    and keeps sharing its dictionary; RLE and FOR decode here (the declared
    boundary every eager compaction and fused output trim goes through).
    A LIST gathers its child through the rows' element ranges, a STRUCT
    each field; a parent's validity is gathered as it is (a null STRUCT
    row keeps its fields' bits, as in the JAX package)."""
    if enc.is_encoded(col):
        return gather(enc.decoded_rows(col), idx)
    validity = (None if col.validity is None
                else col.validity.index_select(0, idx))
    m = int(idx.shape[0])
    if col.dtype.id is TypeId.STRING:
        pos, offsets = _segment_positions(col.offsets, idx, "STRING")
        data = col.data.index_select(0, pos)
        return Column(col.dtype, m, data=data, validity=validity,
                      offsets=offsets)
    if col.dtype.id is TypeId.LIST:
        pos, offsets = _segment_positions(col.offsets, idx, "LIST")
        child = gather(col.children[0], pos.to(torch.int64))
        return Column(col.dtype, m, validity=validity, offsets=offsets,
                      children=(child,))
    if col.dtype.id is TypeId.STRUCT:
        return Column(col.dtype, m, validity=validity,
                      children=tuple(gather(c, idx) for c in col.children))
    col.dtype.require_stored()
    if col.dtype.id is TypeId.DECIMAL128:
        from .int128 import take_rows
        data = take_rows(col.data, idx)
    else:
        data = col.data.index_select(0, idx)
    return Column(col.dtype, m, data=data, validity=validity,
                  children=col.children)


def _segment_positions(offsets: torch.Tensor, idx: torch.Tensor,
                       what: str):
    """(int32 source positions, int32 offsets) of rows ``idx`` of a
    STRING or LIST column: every output element's position in the flat
    source (the JAX package's ``_segment_element_indices``). The output
    size is the one host sync; an output past int32 offsets raises, as a
    concatenation does."""
    starts = offsets[:-1].index_select(0, idx)
    lens = offsets[1:].index_select(0, idx) - starts
    ends = torch.cumsum(lens, 0, dtype=torch.int64)
    total = int(ends[-1]) if ends.numel() else 0
    if total >= 1 << 31:
        raise ValueError(f"gathered {what} column exceeds int32 offsets")
    out = torch.zeros(idx.shape[0] + 1, dtype=torch.int32,
                      device=offsets.device)
    out[1:] = ends
    if total == 0:
        return torch.zeros(0, dtype=torch.int32, device=offsets.device), out
    row = row_of_position(out, total)
    pos = (starts.index_select(0, row) - out.index_select(0, row)
           + torch.arange(total, dtype=torch.int32, device=offsets.device))
    return pos, out


@plan_core("select_topk")
def select_topk_core(lanes: Sequence[torch.Tensor], live: torch.Tensor,
                     k: int) -> torch.Tensor:
    """int64 indices of the first ``k`` live rows in ``lanes`` order: k
    rounds, each a minimum down the lanes from the most significant, then
    the lowest row index among the rows that tie on every lane — the order
    of a stable sort, so the top k equal a sort followed by a slice.

    ``live``: bool[n]. Rounds past the live count return index 0, which
    the caller masks off with its own live count."""
    n = live.shape[0]
    if k == 0:
        return torch.zeros(0, dtype=torch.int64, device=live.device)
    rowids = torch.arange(n, dtype=torch.int64, device=live.device)
    alive = live
    picks = []
    for _ in range(k):
        cand = alive
        for lane in reversed(lanes):
            m = torch.where(cand, lane, _I64_MAX).min()
            cand = cand & (lane == m)
        # argmax takes no bool; on ties it returns the first index
        w = torch.argmax(cand.to(torch.uint8))
        picks.append(w)
        alive = alive & (rowids != w)
    return torch.stack(picks)


@func_range()
def sort_table(table: Table, key_indices: Sequence[int],
               ascending: Optional[Sequence[bool]] = None,
               nulls_first: Optional[Sequence[bool]] = None) -> Table:
    # peak working set ~ input + gathered output (reservation bracketing,
    # reference contract: SparkResourceAdaptorJni.cpp:1731 do_allocate)
    with device_reservation(2 * table.device_nbytes()) as took:
        keys = [table.columns[i] for i in key_indices]
        order = sort_order(keys, ascending, nulls_first)
        out = Table(tuple(gather(c, order) for c in table.columns))
        return release_barrier(out, took)
