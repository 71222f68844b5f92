"""Gather, concatenate, slice and filter of tables of fixed-width, STRING,
encoded and nested columns (the JAX package's columnar/table_ops.py).
Every op runs on the device of its input. A gather keeps DICT32 codes on
their dictionary and decodes RLE/FOR (ops/sort.gather); a concat keeps
RLE and aligned FOR columns encoded and puts DICT32 columns on one
dictionary. A LIST concatenates its children and shifts its offsets, a
STRUCT concatenates field by field."""

from __future__ import annotations

from typing import Sequence

import torch

from .column import Column, Table
from .dtype import TypeId


def _index(idx, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(idx, device=device).to(torch.int64)


def gather_column(col: Column, idx, out_of_bounds_null: bool = False
                  ) -> Column:
    """Rows ``idx`` of ``col``. With ``out_of_bounds_null`` (cudf's
    out_of_bounds_policy::NULLIFY), an index outside [0, n) gives a null
    row — the contract outer-join gather maps rely on."""
    from ..ops.sort import gather
    idx = _index(idx, col.device)
    if not out_of_bounds_null:
        return gather(col, idx)
    out = gather(col, idx.clamp(0, max(col.size - 1, 0)))
    miss = (idx < 0) | (idx >= col.size)
    return out.with_validity(out.valid_mask() & ~miss)


def gather_table(table: Table, idx, out_of_bounds_null: bool = False
                 ) -> Table:
    idx = _index(idx, table.device)
    return Table(tuple(gather_column(c, idx, out_of_bounds_null)
                       for c in table.columns))


def _concat_validity(cols: Sequence[Column]):
    if all(c.validity is None for c in cols):
        return None
    return torch.cat([c.valid_mask() for c in cols])


def _concat_offsets(cols: Sequence[Column], what: str) -> torch.Tensor:
    """The offsets of STRING or LIST columns one after the other: each
    column's shifted by the last offsets of the columns before it (one
    host read of those last offsets, as the JAX package reads them).
    Raises where the total passes int32 offsets."""
    ends = torch.stack([c.offsets[-1].to(torch.int64)
                        for c in cols]).tolist()
    bases = [0]
    for e in ends[:-1]:
        bases.append(bases[-1] + e)
    if bases[-1] + ends[-1] >= 1 << 31:
        raise ValueError(f"concatenated {what} column exceeds int32 "
                         f"offsets")
    return torch.cat([torch.zeros_like(cols[0].offsets[:1])] + [
        c.offsets[1:] + b for c, b in zip(cols, bases)])


def concat_columns(cols: Sequence[Column]) -> Column:
    """Equal-type columns, one after the other (a STRING or LIST column's
    offsets by ``_concat_offsets``)."""
    cols = list(cols)
    if not cols:
        raise ValueError("concat of zero columns")
    if any(c.dtype.is_encoded for c in cols):
        # RLE always concatenates run-wise, FOR where width, reference and
        # byte alignment allow; anything else decodes here
        from . import encodings as enc
        if (all(enc.is_rle(c) for c in cols)
                and len({enc.rle_values(c).dtype for c in cols}) == 1):
            return enc.concat_rle(cols)
        if all(enc.is_for(c) for c in cols):
            packed = enc.concat_for(cols)
            if packed is not None:
                return packed
        return concat_columns([enc.materialize(c) if enc.is_encoded(c)
                               else c for c in cols])
    d = cols[0].dtype
    for c in cols[1:]:
        if c.dtype != d:
            raise TypeError(f"concat dtype mismatch: {c.dtype} vs {d}")
    n = sum(c.size for c in cols)
    validity = _concat_validity(cols)
    if d.id is TypeId.STRING:
        return Column(d, n, data=torch.cat([c.data for c in cols]),
                      validity=validity,
                      offsets=_concat_offsets(cols, "STRING"))
    if d.id is TypeId.LIST:
        offsets = _concat_offsets(cols, "LIST")
        child = concat_columns([c.children[0] for c in cols])
        return Column(d, n, validity=validity, offsets=offsets,
                      children=(child,))
    if d.id is TypeId.STRUCT:
        return Column(d, n, validity=validity, children=tuple(
            concat_columns([c.children[i] for c in cols])
            for i in range(len(cols[0].children))))
    if d.id is TypeId.DICT32:
        # co-dictionary columns keep sharing their dictionary; others are
        # re-encoded onto the union of their entries first
        from .dictionary import dict_column, merge_dictionaries
        cols = merge_dictionaries(cols)
        return dict_column(torch.cat([c.data for c in cols]),
                           cols[0].children[0], validity,
                           ranks=cols[0].children[1])
    d.require_stored()
    return Column(d, n, data=torch.cat([c.data for c in cols]),
                  validity=validity)


def concat_tables(tables: Sequence[Table]) -> Table:
    """Equal-schema tables, one after the other."""
    tables = list(tables)
    if not tables:
        raise ValueError("concat of zero tables")
    return Table(tuple(concat_columns([t.columns[i] for t in tables])
                       for i in range(tables[0].num_columns)))


def slice_table(table: Table, start: int, end: int) -> Table:
    """Row slice [start, end) of every column (a gather, as in the JAX
    package, so a validity mask stays a mask)."""
    return gather_table(table, torch.arange(start, end,
                                            device=table.device))


def mask_indices_core(mask: torch.Tensor, size: int) -> torch.Tensor:
    """int32 indices of the True rows of ``mask`` in row order, given their
    count ``size``. No host sync: each True row scatters its index to its
    rank among the True rows; the False rows all land in one spare slot."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask, rank, size)
    out = torch.zeros(size + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(mask.shape[0], device=mask.device))
    return out[:size].to(torch.int32)


def filter_table(table: Table, mask) -> Table:
    """Rows where ``mask`` (bool[n]) is True — cudf::apply_boolean_mask.
    Raises on a length mismatch."""
    mask = torch.as_tensor(mask, device=table.device).to(torch.bool)
    if mask.shape[0] != table.num_rows:
        raise ValueError(f"boolean mask length {mask.shape[0]} != table "
                         f"rows {table.num_rows}")
    return gather_table(table, torch.nonzero(mask).reshape(-1))
