"""Dictionary-encoded string columns (DICT32), the JAX package's
columnar/dictionary.py.

A DICT32 column is a Column whose ``data`` is the int32 code array
(validity rides the codes) and whose ``children`` carry the shared,
immutable dictionary:

    children[0]  "values": a STRING Column of the unique dictionary entries
    children[1]  "ranks":  INT32, ranks.data[i] = byte-lexicographic rank
                 of entry i, so ``ranks[codes]`` is an order-preserving
                 sort lane that never touches string bytes

Both children are shared by reference across every column built on the
same dictionary (a Parquet dictionary page). Entries are unique, so code
equality is string equality: filters, groupbys and joins run on the int32
codes. ``materialize`` is the one place string bytes are gathered, at an
output boundary. Host readbacks of a dictionary (its entries, ranks,
fingerprint, literal index) are memoized on the shared values column.
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dtype as dt
from .column import Column, resolve_device
from .dtype import TypeId
from .strings import gather_spans


def is_dict(col: Column) -> bool:
    return col.dtype.id is TypeId.DICT32


def dict_values(col: Column) -> Column:
    """The shared STRING dictionary of a DICT32 column."""
    return col.children[0]


def dict_ranks(col: Column) -> Column:
    """The per-entry byte-lexicographic rank lane of a DICT32 column."""
    return col.children[1]


# ---------------------------------------------------------------------------
# dictionary construction
# ---------------------------------------------------------------------------

def _host_chars(values: Column) -> np.ndarray:
    """Host copy of a dictionary's characters, memoized on the shared
    values column (seeded by ``values_from_host``)."""
    cached = getattr(values, "_host_chars", None)
    if cached is None:
        cached = values.data.cpu().numpy()
        cached.flags.writeable = False
        values._host_chars = cached
    return cached


def _entries(values: Column) -> Tuple[bytes, ...]:
    """Host tuple of the entries' bytes, memoized on the shared values
    column."""
    cached = getattr(values, "_dict_entries", None)
    if cached is not None:
        return cached
    offs = values.host_offsets()
    blob = _host_chars(values).tobytes() if values.size else b""
    out = tuple(blob[int(offs[i]):int(offs[i + 1])]
                for i in range(values.size))
    values._dict_entries = out
    return out


def _ranks_for(values: Column) -> Column:
    """INT32 rank column of a dictionary: ranks[i] = position of entry i in
    byte-lexicographic order (entries are unique: no ties)."""
    nd = values.size
    order = sorted(range(nd), key=_entries(values).__getitem__)
    ranks = np.empty(nd, dtype=np.int32)
    ranks[order] = np.arange(nd, dtype=np.int32)
    return Column(dt.INT32, nd,
                  data=torch.from_numpy(ranks).to(values.device))


def values_from_entries(entries: Sequence[bytes], device="cuda") -> Column:
    """STRING values column of the entries' bytes, on ``device`` (how a
    Parquet dictionary page hands its entries over)."""
    dev = resolve_device(device)
    offsets = np.zeros(len(entries) + 1, dtype=np.int32)
    np.cumsum([len(e) for e in entries], out=offsets[1:])
    blob = b"".join(entries)
    data = (np.frombuffer(blob, dtype=np.uint8).copy() if blob
            else np.zeros((0,), dtype=np.uint8))
    values = Column(dt.STRING, len(entries),
                    data=torch.from_numpy(data).to(dev),
                    offsets=torch.from_numpy(offsets).to(dev))
    values._dict_entries = tuple(bytes(e) for e in entries)
    return values


def values_from_host(chars: np.ndarray, offsets: np.ndarray,
                     device="cuda") -> Column:
    """STRING values column of a dictionary page's flat characters and
    int32 offsets, on ``device``. The host arrays become its host mirrors
    (frozen: the caller hands them over), so its entries and fingerprint
    cost no device readback."""
    dev = resolve_device(device)
    values = Column(dt.STRING, int(offsets.shape[0]) - 1,
                    data=torch.from_numpy(chars).to(dev),
                    offsets=torch.from_numpy(offsets).to(dev))
    chars.flags.writeable = False
    offsets.flags.writeable = False
    values._host_chars = chars
    values._host_offsets = offsets
    return values


def dict_column(codes: torch.Tensor, values: Column,
                validity: Optional[torch.Tensor] = None,
                ranks: Optional[Column] = None) -> Column:
    """A DICT32 column. ``ranks`` is computed once per dictionary (memoized
    on the shared values column) when not given."""
    if ranks is None:
        ranks = getattr(values, "_dict_ranks", None)
        if ranks is None:
            ranks = _ranks_for(values)
            values._dict_ranks = ranks
    codes = torch.as_tensor(codes, device=values.device).to(torch.int32)
    return Column(dt.DICT32, int(codes.shape[0]), data=codes,
                  validity=validity, children=(values, ranks))


def encode_strings(col: Column) -> Column:
    """Re-encode a STRING column as DICT32: a host ``np.unique`` over
    (padded bytes, length), so "a" and "a\\x00" stay distinct (a test and
    bench entry point; encoded columns come from dictionary pages)."""
    assert col.dtype.id is TypeId.STRING
    dev = col.device
    n = col.size
    offs = col.host_offsets().astype(np.int64)
    data = col.data.cpu().numpy()
    lengths = offs[1:] - offs[:-1]
    if n == 0 or int(offs[-1]) == 0:
        # all-empty (or all-null) input: one entry suffices
        values = values_from_entries([b""] if n else [], dev)
        codes = torch.zeros(n, dtype=torch.int32, device=dev)
        return dict_column(codes, values, col.validity)
    L = max(1, int(lengths.max()))
    mat = np.zeros((n, L), dtype=np.uint8)
    row_of = np.repeat(np.arange(n), lengths)
    col_in = np.arange(int(offs[-1])) - np.repeat(offs[:-1], lengths)
    mat[row_of, col_in] = data[int(offs[0]):int(offs[-1])]
    combo = np.concatenate(
        [mat, lengths.astype("<i4").view(np.uint8).reshape(n, 4)], axis=1)
    v = np.ascontiguousarray(combo).view(
        np.dtype((np.void, combo.shape[1])))[:, 0]
    _, first, inverse = np.unique(v, return_index=True, return_inverse=True)
    entries = [mat[i, :lengths[i]].tobytes() for i in first]
    values = values_from_entries(entries, dev)
    codes = torch.from_numpy(inverse.reshape(-1).astype(np.int32)).to(dev)
    return dict_column(codes, values, col.validity)


# ---------------------------------------------------------------------------
# output boundary
# ---------------------------------------------------------------------------

def materialize(col: Column) -> Column:
    """STRING column of a DICT32 column's strings (a null row takes no
    bytes): the one place encoded strings touch their bytes."""
    assert is_dict(col)
    values = dict_values(col)
    n, nd = col.size, values.size
    dev = col.device
    if n == 0 or nd == 0:
        return Column(dt.STRING, n,
                      data=torch.zeros(0, dtype=torch.uint8, device=dev),
                      validity=col.validity,
                      offsets=torch.zeros(n + 1, dtype=torch.int32,
                                          device=dev))
    offs = values.offsets.to(torch.int64)
    codes = col.data.to(torch.int64).clamp(0, nd - 1)
    starts = offs[:-1].index_select(0, codes)
    lens = offs[1:].index_select(0, codes) - starts
    return gather_spans(values.data, starts, lens, col.validity)


def materialize_table(table):
    """Every DICT32 column of a Table materialized (output boundary)."""
    from .column import Table
    return Table(tuple(materialize(c) if is_dict(c) else c for c in table))


# ---------------------------------------------------------------------------
# identity / lookup
# ---------------------------------------------------------------------------

def dictionary_fingerprint(col: Column) -> int:
    """crc32 of the dictionary's offsets and bytes (memoized on the shared
    values column): part of the fused program cache key, and the test of
    ``same_dictionary``."""
    values = dict_values(col) if is_dict(col) else col
    cached = getattr(values, "_dict_fp", None)
    if cached is None:
        h = zlib.crc32(values.host_offsets().astype(np.int64).tobytes())
        if values.size:
            data = _host_chars(values)
            if data.size:
                h = zlib.crc32(data.tobytes(), h)
        cached = (h ^ values.size) & 0xFFFFFFFF
        values._dict_fp = cached
    return cached


def same_dictionary(a: Column, b: Column) -> bool:
    va, vb = dict_values(a), dict_values(b)
    return va is vb or dictionary_fingerprint(a) == dictionary_fingerprint(b)


def _index(values: Column) -> dict:
    index = getattr(values, "_dict_index", None)
    if index is None:
        index = {e: i for i, e in enumerate(_entries(values))}
        values._dict_index = index
    return index


def lookup_code(col: Column, value) -> int:
    """Code of a string literal in a DICT32 column's dictionary, or -1 when
    absent (no code equals -1: the encoded always-false)."""
    needle = value.encode("utf-8") if isinstance(value, str) else bytes(value)
    return _index(dict_values(col)).get(needle, -1)


# ---------------------------------------------------------------------------
# cross-dictionary alignment (joins, concat)
# ---------------------------------------------------------------------------

def code_remap_table(left: Column, right: Column) -> Optional[np.ndarray]:
    """Host int32 remap of a DICT32 join-key pair: remap[right code] = the
    left code of the same entry, or -1 where the left dictionary lacks it.
    None for co-dictionary pairs (codes already comparable)."""
    if same_dictionary(left, right):
        return None
    index = _index(dict_values(left))
    return np.array([index.get(e, -1) for e in _entries(dict_values(right))],
                    dtype=np.int32)


def _remapped(codes: torch.Tensor, remap: np.ndarray, nd: int
              ) -> torch.Tensor:
    if not nd:
        return torch.full_like(codes, -1)
    table = torch.from_numpy(remap).to(codes.device)
    return table.index_select(0, codes.to(torch.int64).clamp(0, nd - 1))


def align_codes(left: Column, right: Column) -> Tuple[Column, Column]:
    """Plain INT32 code columns of a DICT32 join-key pair, comparable by
    value: co-dictionary codes pass through; otherwise the right codes are
    re-mapped into the left dictionary (absent entries -> -1)."""
    lcol = Column(dt.INT32, left.size, data=left.data,
                  validity=left.validity)
    remap = code_remap_table(left, right)
    rdata = (right.data if remap is None
             else _remapped(right.data, remap, dict_values(right).size))
    return lcol, Column(dt.INT32, right.size, data=rdata,
                        validity=right.validity)


def merge_dictionaries(cols: Sequence[Column]) -> List[Column]:
    """DICT32 columns re-encoded onto ONE dictionary (the union of entries
    in first-seen order) so they concatenate code-wise; co-dictionary
    inputs come back as they are."""
    first = dict_values(cols[0])
    if all(dict_values(c) is first or same_dictionary(c, cols[0])
           for c in cols[1:]):
        return list(cols)
    entries: List[bytes] = []
    index = {}
    for c in cols:
        for e in _entries(dict_values(c)):
            if e not in index:
                index[e] = len(entries)
                entries.append(e)
    values = values_from_entries(entries, cols[0].device)
    values._dict_index = dict(index)
    out = []
    for c in cols:
        ents = _entries(dict_values(c))
        remap = np.array([index[e] for e in ents], dtype=np.int32)
        codes = (_remapped(c.data, remap, len(ents)) if ents
                 else torch.zeros(c.size, dtype=torch.int32,
                                  device=c.device))
        out.append(dict_column(codes, values, c.validity))
    return out
