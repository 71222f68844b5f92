"""Equi joins producing gather maps (the JAX package's ops/join.py).

A sort-probe join, as in the JAX package:

  1. xxhash64 row hash of the key columns (kernel B2);
  2. stable sort of the right side's hashes;
  3. per left row, the run of equal right hashes by binary search;
  4. expansion of the candidate pairs and an exact key compare that kills
     hash collisions (floats over normalized bits: NaNs equal, -0.0 == 0.0;
     STRING keys over their zero-padded bytes and lengths; DECIMAL128
     keys over their limb rows), in chunks of
     pairs whose gathered key bytes stay under ``_VERIFY_MAX_BYTES``.

The u64 hashes are held as int64 bits; XOR-ing the sign bit makes signed
order the unsigned order, so torch's stable sort and searchsorted give the
JAX package's order, ties in row order. Null keys never match (Spark's
default; ``nulls_equal`` gives the null-safe ``<=>``). Keys hash at their
own widths, as the JAX package's op does: an INT32 key does not meet an
INT64 key (the plan engine widens such pairs at its join boundary,
plan/interpreter.py). A DICT32 key pair joins as two INT32 code columns
on one dictionary (``align_codes``): the join never touches the strings. Masks push a filter
into the inner join without compacting either side. The left outer, semi
and anti joins are built on the inner join's maps, as in the JAX package.

The JAX package sizes its expansion speculatively to save a host sync on
the TPU; here the candidate total is read once and the expansion is exact.
Each phase runs under a device reservation (memory/reservation.py) with
the JAX package's estimates: the candidate phase reserves twice the key
bytes, the expansion that plus the bucketed pair count times the per-pair
transient bytes. The JAX package's third bracket covers its speculative
expansion, which this join does not run.

The fused plan engine's cores (plan/registry.py) do not hash:
``join_build_sorted_core`` + ``join_probe_sorted_core`` (a sorted unique
build and a binary-search probe) and ``join_probe_direct_core`` (a dense
build key is its own address). They keep the probe side's lane count and
flag a build they cannot serve (duplicate live keys, a key that is not
dense after all) in the plan's overflow bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..columnar.column import Column, Table
from ..columnar.dtype import TypeId
from ..columnar.strings import padded_bytes
from ..memory.reservation import (device_reservation, release_barrier,
                                  reservations_active)
from ..plan.registry import plan_core
from ..utils.shapes import bucket_size
from ..utils.tracing import func_range
from .hashing import _s64, spark_key_values, xxhash64
from .sort import lexsort

_SIGN64 = -(1 << 63)

# poison bases for hashes that must never meet (the JAX package's values)
_NULL_L = _s64(0x0BAD0BAD0BAD0BAD)
_NULL_R = _s64(0x1BAD1BAD1BAD1BAD)
_MASK_L = _s64(0x2BAD2BAD2BAD2BAD)
_MASK_R = _s64(0x3BAD3BAD3BAD3BAD)


def _row_hash(cols: Sequence[Column]) -> torch.Tensor:
    """int64 bits of the u64 xxhash64 row hash."""
    return xxhash64(Table(tuple(cols))).data


def _any_null(cols: Sequence[Column]) -> torch.Tensor:
    out = torch.zeros(cols[0].size, dtype=torch.bool, device=cols[0].device)
    for c in cols:
        if c.validity is not None:
            out = out | ~c.validity
    return out


def _col_equal(lc: Column, l_idx: torch.Tensor, rc: Column,
               r_idx: torch.Tensor, nulls_equal: bool) -> torch.Tensor:
    """Equality of candidate row pairs on one key column."""
    lv = lc.valid_mask()[l_idx]
    rv = rc.valid_mask()[r_idx]
    if lc.dtype.id is TypeId.STRING:
        lmat, llen = padded_bytes(lc)
        rmat, rlen = padded_bytes(rc)
        # equal lengths fit both widths, so the narrower width decides
        w = min(lmat.shape[1], rmat.shape[1]) // 8
        lw = lmat.view(torch.int64)[:, :w]
        rw = rmat.view(torch.int64)[:, :w]
        vals = ((lw.index_select(0, l_idx) == rw.index_select(0, r_idx))
                .all(dim=1) & (llen[l_idx] == rlen[r_idx]))
    elif lc.dtype.id is TypeId.DECIMAL128:  # both words of the limbs
        from .int128 import take_words
        a, b = take_words(lc.data, l_idx), take_words(rc.data, r_idx)
        vals = (a[0] == b[0]) & (a[1] == b[1])
    else:
        vals = spark_key_values(lc)[l_idx] == spark_key_values(rc)[r_idx]
    eq = lv & rv & vals
    if nulls_equal:
        eq = eq | (~lv & ~rv)
    return eq


# gathered key bytes one verify chunk may hold (the JAX package caps its
# speculative expansion at the same byte count)
_VERIFY_MAX_BYTES = 1 << 30


def _verify_width(col: Column) -> int:
    """Bytes ``_col_equal`` gathers per candidate pair for one key column:
    the padded row of a STRING key, one element otherwise."""
    if col.dtype.id is TypeId.STRING:
        return int(padded_bytes(col)[0].shape[1]) if col.size else 1
    return col.dtype.itemsize


def _align_dict_key_pairs(left_keys, right_keys):
    """DICT32 key pairs as INT32 code columns comparable by value: codes of
    one dictionary pass through, the right side of two dictionaries is
    re-mapped into the left one (absent entries -> -1, no left code)."""
    if not any(c.dtype.id is TypeId.DICT32 for c in left_keys):
        return left_keys, right_keys
    from ..columnar.dictionary import align_codes
    lout, rout = [], []
    for lc, rc in zip(left_keys, right_keys):
        if lc.dtype.id is TypeId.DICT32 and rc.dtype.id is TypeId.DICT32:
            lc, rc = align_codes(lc, rc)
        lout.append(lc)
        rout.append(rc)
    return lout, rout


def _check_mask(mask, keys, side: str) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    mask = torch.as_tensor(mask, device=keys[0].device).to(torch.bool)
    if mask.shape != (keys[0].size,):
        raise ValueError(f"boolean {side}_mask shape {tuple(mask.shape)} != "
                         f"key rows ({keys[0].size},)")
    return mask


def _candidate_counts(left_keys, right_keys, nulls_equal,
                      left_mask=None, right_mask=None):
    """Phase 1: row hashes and the run of equal right hashes per left row.
    Null-key and masked-out rows get per-row poison hashes, so they give
    (almost) no candidates; the verify phase enforces both exactly."""
    hl = _row_hash(left_keys)
    hr = _row_hash(right_keys)
    nl, nr = hl.shape[0], hr.shape[0]
    dev = hl.device
    il = torch.arange(nl, dtype=torch.int64, device=dev)
    ir = torch.arange(nr, dtype=torch.int64, device=dev)
    if not nulls_equal:
        hl = torch.where(_any_null(left_keys), _NULL_L ^ il, hl)
        hr = torch.where(_any_null(right_keys), _NULL_R ^ (ir ^ _SIGN64), hr)
    if left_mask is not None:
        hl = torch.where(left_mask, hl, _MASK_L ^ il)
    if right_mask is not None:
        hr = torch.where(right_mask, hr, _MASK_R ^ (ir + (1 << 62)))
    hr_sorted, order = torch.sort(hr ^ _SIGN64, stable=True)
    hl = hl ^ _SIGN64
    lo = torch.searchsorted(hr_sorted, hl, side="left")
    hi = torch.searchsorted(hr_sorted, hl, side="right")
    return order, lo, hi - lo


def _expand_and_verify(left_keys, right_keys, nulls_equal, order, lo, cnt,
                       total, left_mask=None, right_mask=None):
    """Phase 2: every candidate pair (left rows in order, each with its
    right candidates in sorted-hash order), kept where the keys are
    exactly equal and both rows pass their masks. ``total``: the
    candidate-pair count, ``cnt.sum()``."""
    dev = cnt.device
    nl = cnt.shape[0]
    l_idx = torch.repeat_interleave(
        torch.arange(nl, dtype=torch.int64, device=dev), cnt,
        output_size=total)
    start = torch.cumsum(cnt, 0) - cnt
    within = torch.arange(total, dtype=torch.int64, device=dev) - start[l_idx]
    r_idx = order[lo[l_idx] + within]
    keep = torch.ones(total, dtype=torch.bool, device=dev)
    if left_mask is not None:
        keep = keep & left_mask[l_idx]
    if right_mask is not None:
        keep = keep & right_mask[r_idx]
    width = sum(_verify_width(lc) + _verify_width(rc)
                for lc, rc in zip(left_keys, right_keys))
    step = max(1, _VERIFY_MAX_BYTES // width)
    for p0 in range(0, total, step):
        li, ri = l_idx[p0:p0 + step], r_idx[p0:p0 + step]
        for lc, rc in zip(left_keys, right_keys):
            keep[p0:p0 + step] &= _col_equal(lc, li, rc, ri, nulls_equal)
    return l_idx[keep], r_idx[keep]


@func_range()
def inner_join(left_keys: Sequence[Column], right_keys: Sequence[Column],
               nulls_equal: bool = False, left_mask=None, right_mask=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather maps (left_indices, right_indices), int64 on the keys'
    device, of the matching row pairs. ``left_mask``/``right_mask``
    (bool[n]) push a filter into the join: the same pairs as pre-filtering
    that side, with indices into the ORIGINAL tables."""
    left_keys, right_keys = _align_dict_key_pairs(list(left_keys),
                                                  list(right_keys))
    for lc, rc in zip(left_keys, right_keys):
        if (lc.dtype.id is TypeId.STRING) != (rc.dtype.id is TypeId.STRING):
            raise TypeError(f"join key types differ: {lc.dtype} and "
                            f"{rc.dtype}")
    for c in (*left_keys, *right_keys):
        if c.dtype.is_nested:
            # the JAX package's join hashes its keys with xxhash64 first,
            # which refuses a nested column
            raise TypeError("xxhash64 does not support nested types")
        if c.dtype.id is not TypeId.STRING:
            c.dtype.require_stored()
    left_mask = _check_mask(left_mask, left_keys, "left")
    right_mask = _check_mask(right_mask, right_keys, "right")
    in_bytes = sum(c.device_nbytes() for c in (*left_keys, *right_keys))
    # per-pair transient bytes of the expansion/verify/compaction chain
    # (the JAX package's estimate): 48 B of index lanes, a byte per mask
    # gathered, and the key bytes _col_equal gathers per candidate. Only
    # a governed thread needs it (a STRING key's width costs a read).
    per_pair = 0
    if reservations_active():
        per_pair = 48 + (left_mask is not None) + (right_mask is not None)
        per_pair += sum(_verify_width(lc) + _verify_width(rc)
                        for lc, rc in zip(left_keys, right_keys))
    with device_reservation(2 * in_bytes) as took:
        order, lo, cnt = release_barrier(_candidate_counts(
            left_keys, right_keys, nulls_equal, left_mask, right_mask), took)
    total = int(cnt.sum())  # host sync: the candidate-pair count
    # reserve at the BUCKETED pair count, as the JAX package does
    with device_reservation(2 * in_bytes
                            + bucket_size(total) * per_pair) as took:
        return release_barrier(_expand_and_verify(
            left_keys, right_keys, nulls_equal, order, lo, cnt, total,
            left_mask, right_mask), took)


def _matched(l_idx: torch.Tensor, n_left: int) -> torch.Tensor:
    """bool[n_left]: the left rows present in an inner-join gather map."""
    m = torch.zeros(n_left, dtype=torch.bool, device=l_idx.device)
    m[l_idx] = True
    return m


def left_join(left_keys: Sequence[Column], right_keys: Sequence[Column],
              nulls_equal: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left outer join: the inner join's maps, then every unmatched left
    row (ascending) with right index -1."""
    l_idx, r_idx = inner_join(left_keys, right_keys, nulls_equal)
    miss = torch.nonzero(~_matched(l_idx, left_keys[0].size)).reshape(-1)
    return (torch.cat([l_idx, miss]),
            torch.cat([r_idx, torch.full_like(miss, -1)]))


def full_join(left_keys: Sequence[Column], right_keys: Sequence[Column],
              nulls_equal: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full outer join; unmatched rows get -1 on the other side: the
    inner join's maps, then every unmatched left row (ascending) with
    right index -1, then every unmatched right row (ascending) with left
    index -1."""
    l_idx, r_idx = inner_join(left_keys, right_keys, nulls_equal)
    lmiss = torch.nonzero(~_matched(l_idx, left_keys[0].size)).reshape(-1)
    rmiss = torch.nonzero(~_matched(r_idx, right_keys[0].size)).reshape(-1)
    return (torch.cat([l_idx, lmiss, torch.full_like(rmiss, -1)]),
            torch.cat([r_idx, torch.full_like(lmiss, -1), rmiss]))


def left_semi_join(left_keys: Sequence[Column],
                   right_keys: Sequence[Column],
                   nulls_equal: bool = False) -> torch.Tensor:
    """Ascending indices of the left rows with at least one match."""
    l_idx, _ = inner_join(left_keys, right_keys, nulls_equal)
    return torch.nonzero(_matched(l_idx, left_keys[0].size)).reshape(-1)


def left_anti_join(left_keys: Sequence[Column],
                   right_keys: Sequence[Column],
                   nulls_equal: bool = False) -> torch.Tensor:
    """Ascending indices of the left rows with no match (a null key never
    matches, so its row is kept)."""
    l_idx, _ = inner_join(left_keys, right_keys, nulls_equal)
    return torch.nonzero(~_matched(l_idx, left_keys[0].size)).reshape(-1)


# ---------------------------------------------------------------------------
# fused-plan join cores: single int64 key lanes, unique builds, no hashing
# ---------------------------------------------------------------------------

@plan_core("join_build_sorted")
def join_build_sorted_core(build_keys: torch.Tensor,
                           build_live: Optional[torch.Tensor]):
    """Sorted build over int64 key values.

    ``build_live``: optional bool[n] — the rows that may match (validity,
    carried filter mask). Dead rows sort after live rows within each key
    run, so the probe's leftmost hit lands on a live row where one exists.

    Returns ``(order, sorted_keys, sorted_live, dup)``; ``dup`` (bool
    0-dim) is set when a key occurs on more than one LIVE row (the fused
    join would have to expand rows: overflow)."""
    rn = build_keys.shape[0]
    if build_live is None:
        build_live = torch.ones(rn, dtype=torch.bool,
                                device=build_keys.device)
    dead = (~build_live).to(torch.int64)
    order = lexsort([dead, build_keys], rn, build_keys.device)
    sk = build_keys.index_select(0, order)
    sl = build_live.index_select(0, order)
    dup = ((sk[1:] == sk[:-1]) & sl[1:] & sl[:-1]).any()
    return order, sk, sl, dup


@plan_core("join_probe_sorted")
def join_probe_sorted_core(order: torch.Tensor, sorted_keys: torch.Tensor,
                           sorted_live: torch.Tensor,
                           probe_keys: torch.Tensor):
    """Binary-search probe of a sorted unique build.

    Returns ``(r_idx i64[n], found bool[n])``: the build row each probe
    lane matched (an in-range garbage row where not found) and the match
    mask. Callers AND in the probe keys' validity."""
    rn = sorted_keys.shape[0]
    if rn == 0:  # nothing to match, nothing to gather from
        z = torch.zeros_like(probe_keys)
        return z, z.to(torch.bool)
    pos = torch.searchsorted(sorted_keys, probe_keys)
    posc = pos.clamp(max=rn - 1)
    found = ((pos < rn) & (sorted_keys.index_select(0, posc) == probe_keys)
             & sorted_live.index_select(0, posc))
    return order.index_select(0, posc), found


@plan_core("join_probe_direct")
def join_probe_direct_core(build_keys: torch.Tensor,
                           build_live: Optional[torch.Tensor], lo: int,
                           probe_keys: torch.Tensor):
    """Direct-addressed probe of a build key the planner believes is
    ``arange(n) + lo``: the build table is the hash table, the probe one
    subtract and gather. ``bad`` re-checks the density claim on the device
    (overflow semantics: lying stats cost an eager replay, never a wrong
    row); a dense key is unique, so no duplicate check is needed.

    Returns ``(r_idx i64[n], found bool[n], bad bool 0-dim)``."""
    rn = build_keys.shape[0]
    if rn == 0:
        z = torch.zeros_like(probe_keys)
        return z, z.to(torch.bool), torch.zeros((), dtype=torch.bool,
                                                device=z.device)
    bad = ~(build_keys == torch.arange(rn, dtype=build_keys.dtype,
                                       device=build_keys.device) + lo).all()
    idx = probe_keys - lo
    found = (idx >= 0) & (idx < rn)
    r_idx = idx.clamp(0, rn - 1)
    if build_live is not None:
        found = found & build_live.index_select(0, r_idx)
    return r_idx, found, bad
