"""Histograms and interpolated percentiles (Spark's ``percentile``
aggregate; the JAX package's ops/histogram.py).

Reference capability: histogram.cu — ``create_histogram_if_valid``
(:282) checks (value, frequency) pairs and packs them into
``LIST<STRUCT<value, freq INT64>>``; ``percentile_from_histogram`` (:428)
interpolates percentiles over each row's sorted histogram.

Both run as torch ops on the column's device. A percentile densifies each
histogram row to ``L`` lanes (``L`` the longest row's length, bucketed as
``strings.pad_width`` buckets it, so the lanes are the JAX package's),
values as float64 padded with +inf and frequencies padded with 0; sorts
each row (a stable sort: NaNs last, -0.0 and 0.0 kept in row order, as
``jnp.argsort`` orders them); takes prefix sums of the frequencies; and
finds the items at the floor and the ceiling of ``p x (total - 1)`` by a
search of those sums. The interpolation ``v_lo + (v_hi - v_lo) x (pos -
lo)`` is one ``addcmul``: a fused multiply-add on the CPU, as XLA:CPU
contracts the JAX package's expression.

Spark semantics (Percentile.getPercentile): position = p x (total - 1);
the items at floor and ceil of the position (0-based, expanded by
frequency) are interpolated linearly. An empty histogram gives a null.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..columnar import dtype as dt
from ..columnar.column import Column
from ..columnar.strings import pad_width


def create_histogram_if_valid(values: Column, frequencies: Column,
                              output_as_lists: bool) -> Column:
    """(value, frequency) rows -> ``LIST<STRUCT<value, freq INT64>>``:
    one list a row (``output_as_lists``: empty for a dropped row) or one
    list of every kept row. A row with a null value, a null frequency or
    a frequency <= 0 adds no entry; a negative frequency raises."""
    if values.size != frequencies.size:
        raise ValueError("values/frequencies must have the same row count")
    freqs = frequencies.data.to(torch.int64)
    keep = freqs > 0
    fvalid = frequencies.validity
    if fvalid is not None:
        keep &= fvalid
    if bool(((freqs < 0) if fvalid is None else (fvalid & (freqs < 0))
             ).any()):
        raise ValueError("frequencies must be non-negative")
    if values.validity is not None:
        keep &= values.validity
    rows = torch.nonzero(keep).reshape(-1)
    k = int(rows.shape[0])
    dev = freqs.device
    if output_as_lists:
        offsets = torch.zeros(values.size + 1, dtype=torch.int32, device=dev)
        torch.cumsum(keep, 0, dtype=torch.int32, out=offsets[1:])
    else:
        offsets = torch.tensor([0, k], dtype=torch.int32, device=dev)
    child = Column.struct_of([
        Column(values.dtype, k, data=values.data.index_select(0, rows)),
        Column(dt.INT64, k, data=freqs.index_select(0, rows)),
    ])
    return Column.list_of(child, offsets)


def _as_f64(col: Column) -> torch.Tensor:
    """A value column's values as float64, unsigned types from their
    unsigned bits (the port stores them signed)."""
    tid = col.dtype.id
    if tid in (dt.TypeId.UINT16, dt.TypeId.UINT32):
        mask = 0xFFFF if tid is dt.TypeId.UINT16 else 0xFFFFFFFF
        return (col.data.to(torch.int64) & mask).to(torch.float64)
    if tid is dt.TypeId.UINT64:
        x = col.data
        half = ((x >> 1) & 0x7FFFFFFFFFFFFFFF) | (x & 1)  # round to odd
        return torch.where(x < 0, half.to(torch.float64) * 2,
                           x.to(torch.float64))
    return col.data.to(torch.float64)


def _percentile_core(vals: torch.Tensor, freqs: torch.Tensor,
                     pcts: torch.Tensor):
    """vals f64[n, L] (+inf pads), freqs i64[n, L] (0 pads), pcts f64[m]
    -> (f64[n, m], bool[n] has data)."""
    vals, order = torch.sort(vals, dim=1, stable=True)
    cum = torch.cumsum(freqs.gather(1, order), 1)
    total = cum[:, -1]
    has_data = total > 0
    pos = pcts[None, :] * (total[:, None] - 1).to(torch.float64)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    last = vals.shape[1] - 1

    def item_at(idx):
        # the first lane whose running count passes idx: the count of
        # lanes at or below it (cum never decreases along a row)
        cnt = torch.searchsorted(cum, idx.to(torch.int64), right=True)
        return vals.gather(1, cnt.clamp_(0, last))

    v_lo = item_at(lo)
    v_hi = item_at(hi)
    return torch.addcmul(v_lo, v_hi - v_lo, pos - lo), has_data


def percentile_from_histogram(histograms: Column,
                              percentages: Sequence[float],
                              output_as_list: bool) -> Column:
    """Interpolated percentiles of each histogram row: a LIST<FLOAT64> row
    of one entry per percentage (``output_as_list``), else a FLOAT64
    column of the first percentage. An empty or null histogram gives a
    null row."""
    assert histograms.dtype.id is dt.TypeId.LIST
    struct = histograms.children[0]
    values_child, freqs_child = struct.children[0], struct.children[1]
    n = histograms.size
    offsets = histograms.offsets.to(torch.int64)
    dev = offsets.device
    lens = offsets[1:] - offsets[:-1]
    L = pad_width(int(lens.max()) if n else 1)
    if values_child.size == 0:
        vals = torch.full((n, L), float("inf"), dtype=torch.float64,
                          device=dev)
        freqs = torch.zeros((n, L), dtype=torch.int64, device=dev)
    else:
        idx = offsets[:-1, None] + torch.arange(L, device=dev)[None, :]
        in_range = idx < offsets[1:, None]
        idx = idx.clamp_(0, values_child.size - 1)
        vals = torch.where(in_range, _as_f64(values_child)[idx],
                           float("inf"))
        freqs = torch.where(in_range, freqs_child.data.to(torch.int64)[idx],
                            0)
    pcts = torch.tensor([float(p) for p in percentages],
                        dtype=torch.float64, device=dev)
    out, has_data = _percentile_core(vals, freqs, pcts)
    if histograms.validity is not None:
        has_data = has_data & histograms.validity
    m = len(percentages)
    if output_as_list:
        loffs = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        torch.cumsum(has_data.to(torch.int32) * m, 0, dtype=torch.int32,
                     out=loffs[1:])
        flat = out[has_data].reshape(-1)
        child = Column(dt.FLOAT64, int(flat.shape[0]), data=flat)
        return Column.list_of(child, loffs, validity=has_data)
    return Column(dt.FLOAT64, n, data=out[:, 0].contiguous(),
                  validity=has_data)
