"""Gather, slice and filter of fixed-width tables (the JAX package's
columnar/table_ops.py). Every op runs on the device of its input."""

from __future__ import annotations

import torch

from .column import Column, Table


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
