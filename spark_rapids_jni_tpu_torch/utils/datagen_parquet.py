"""A Parquet writer for the tests and ``chip_smoke.py``: numpy columns
written the way Spark's parquet-mr writes them, with parquet-mr's
defaults (the card's machine has no pyarrow). Not part of the read path
and not exported from ``parquet/``.

What it writes:

- PAR1 framing and a thrift-compact ``FileMetaData``; every leaf is
  OPTIONAL, so each v1 data page starts with its definition levels (a
  u32 length and the RLE/bit-packed hybrid, width 1);
- row groups of ``ROW_GROUP_BYTES`` (``parquet.block.size``, 128 MiB),
  cut at a page boundary from the encoded bytes per row of a sample of
  the group's first rows (parquet-mr checks its buffered size as it
  goes); data pages of ``PAGE_ROWS`` rows (``parquet.page.row.count.
  limit``) or ``PAGE_BYTES`` of values (``parquet.page.size``), whichever
  comes first;
- dictionary encoding as parquet-mr's v1 writer does it
  (``FallbackValuesWriter`` over a dictionary writer): entries in the
  order first seen in the chunk, index pages of the hybrid at the width
  of the dictionary's size so far, and a PLAIN dictionary page written
  ahead of the data pages. The dictionary is dropped when its first page
  does not compress (index bytes + dictionary bytes >= the plain bytes),
  and the writer falls back to PLAIN mid-chunk, from the page where the
  dictionary passes ``DICT_PAGE_BYTES`` (``parquet.dictionary.page.
  size``), keeping the dictionary page for the pages before. The v1
  writer labels both page kinds PLAIN_DICTIONARY (the bytes are those of
  RLE_DICTIONARY data pages and a PLAIN dictionary page). Booleans are
  never dictionary-encoded;
- the hybrid encoder is parquet-mr's ``RunLengthBitPackingHybridEncoder``:
  an RLE run where 8 values starting at a group boundary repeat, else
  groups of 8 bit-packed, at most 63 groups a run, the last group padded
  with zeros;
- INT32/INT64 chunk ``Statistics`` (min/max of the non-null values, both
  the legacy and the v2 fields, and the null count) and a CRC32 on every
  page (``parquet.page.write-checksum.enabled``);
- a DECIMAL column (``decimal=(precision, scale)``, int64 unscaled
  values) as Spark writes a decimal of precision above 18 with
  ``spark.sql.parquet.writeLegacyFormat``, and as pyarrow writes
  ``decimal128``: FIXED_LEN_BYTE_ARRAY of the least bytes that hold the
  precision (6 for decimal(12, 2)), big-endian two's complement, the
  DECIMAL converted type with its precision and scale; PLAIN pages only
  (parquet-mr's v1 writer has no dictionary for FIXED_LEN_BYTE_ARRAY);
  statistics the v2 min/max (signed order) and the null count.

- nested columns as parquet-mr writes Spark's arrays and structs: a
  ``ListField`` as ``optional group x (LIST) { repeated group list {
  optional <element> element; } }`` (the element a primitive or a
  ``StructField``: LIST<STRUCT> is a group element), a ``StructField`` as
  an optional group. Each leaf's rows are shredded into entries (the
  Dremel record shredding: an entry per element, a null or an empty
  list), and its v1 data pages carry repetition levels, then definition
  levels up to the leaf's ``max_def``, both u32-length-prefixed in the
  hybrid encoding at the widths of the maximum levels; a page ends only
  where a row ends (repetition level 0 next). The leaf's stored values
  are encoded as a flat column's are, with the entries in place of rows.

One cut against Spark's defaults: pages are UNCOMPRESSED (Spark's codec
is snappy).

A STRING column may be handed over as dictionary codes plus entries
(``string_codes``): its dictionary pages then hold the entries the chunk
uses in the order given, so a DICT32 read returns the given codes when
every chunk uses every entry (``columnar/dictionary.encode_strings``'
order, for one). Such a dictionary must stay under the fallback size.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

ROW_GROUP_BYTES = 128 << 20
PAGE_ROWS = 20_000
PAGE_BYTES = 1 << 20
DICT_PAGE_BYTES = 1 << 20

# parquet enums
_BOOLEAN, _INT32, _INT64, _FLOAT, _DOUBLE, _BYTE_ARRAY, _FLBA = (0, 1, 2, 4,
                                                                5, 6, 7)
_PLAIN, _PLAIN_DICTIONARY, _RLE, _BIT_PACKED = 0, 2, 3, 4
_OPTIONAL, _REPEATED = 1, 2
_CT_LIST = 3
_DATA_PAGE, _DICTIONARY_PAGE = 0, 2
# converted types
UTF8, DECIMAL, DATE = 0, 5, 6

_PHYSICAL = {np.dtype(np.int32): _INT32, np.dtype(np.int64): _INT64,
             np.dtype(np.float32): _FLOAT, np.dtype(np.float64): _DOUBLE,
             np.dtype(np.bool_): _BOOLEAN}


@dataclass
class ParquetColumn:
    """One column to write. Fixed-width: ``values`` (int32, int64,
    float32, float64 or bool, one per row). STRING: ``chars`` (uint8) and
    int64 ``offsets`` (rows + 1), or ``codes`` (int per row) into
    ``entries`` (bytes). ``valid`` (bool per row, True = valid) or None.
    ``converted``: the schema's ConvertedType (UTF8, DATE). DECIMAL:
    ``decimal`` = (precision, scale) and int64 unscaled ``values``."""

    name: str
    values: Optional[np.ndarray] = None
    valid: Optional[np.ndarray] = None
    chars: Optional[np.ndarray] = None
    offsets: Optional[np.ndarray] = None
    codes: Optional[np.ndarray] = None
    entries: Optional[Sequence[bytes]] = None
    converted: Optional[int] = None
    decimal: Optional[Tuple[int, int]] = None

    @property
    def physical(self) -> int:
        if self.values is None:
            return _BYTE_ARRAY
        if self.decimal is not None:
            return _FLBA
        return _PHYSICAL[self.values.dtype]

    @property
    def type_length(self) -> int:
        """FIXED_LEN_BYTE_ARRAY bytes: parquet-mr's minBytesForPrecision."""
        k = 1
        while 2 ** (8 * k - 1) < 10 ** self.decimal[0]:
            k += 1
        return k

    @property
    def rows(self) -> int:
        if self.values is not None:
            return self.values.shape[0]
        if self.codes is not None:
            return self.codes.shape[0]
        return self.offsets.shape[0] - 1


def string_column(name: str, strings: Sequence[Optional[bytes]]
                  ) -> ParquetColumn:
    """A STRING column of Python bytes/str (None = null)."""
    parts = [b"" if s is None else (s.encode() if isinstance(s, str) else s)
             for s in strings]
    offsets = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=offsets[1:])
    valid = np.array([s is not None for s in strings], bool)
    return ParquetColumn(name, chars=np.frombuffer(b"".join(parts),
                                                   np.uint8),
                         offsets=offsets,
                         valid=None if valid.all() else valid,
                         converted=UTF8)


@dataclass
class StructField:
    """An optional STRUCT column: equal-length ``fields`` (ParquetColumn,
    StructField or ListField), ``valid`` (bool per row) or None."""

    name: str
    fields: Sequence[object]
    valid: Optional[np.ndarray] = None

    @property
    def rows(self) -> int:
        return self.fields[0].rows


@dataclass
class ListField:
    """An optional LIST column: row i is ``element`` rows
    [offsets[i], offsets[i + 1]) (int64 offsets, rows + 1), ``valid``
    (bool per row) or None. The element (its name is not used: parquet-mr
    names it ``element``) is a ParquetColumn or a StructField."""

    name: str
    offsets: np.ndarray
    element: object
    valid: Optional[np.ndarray] = None

    @property
    def rows(self) -> int:
        return self.offsets.shape[0] - 1


def string_codes(name: str, codes: np.ndarray, entries: Sequence[bytes],
                 valid: Optional[np.ndarray] = None) -> ParquetColumn:
    """A STRING column given as each row's code into ``entries``."""
    return ParquetColumn(name, codes=np.asarray(codes), entries=list(entries),
                         valid=valid, converted=UTF8)


# ---------------------------------------------------------------------------
# thrift compact protocol
# ---------------------------------------------------------------------------

class _Thrift:
    """The subset of the compact protocol FileMetaData and PageHeader
    need: i32/i64 (zigzag varints), binary, bool, struct, list."""

    def __init__(self):
        self.buf = bytearray()
        self._last = [0]

    def _varint(self, v: int) -> None:
        while v >= 0x80:
            self.buf.append((v & 0x7F) | 0x80)
            v >>= 7
        self.buf.append(v)

    def _field(self, fid: int, ftype: int) -> None:
        delta = fid - self._last[-1]
        if 0 < delta <= 15:
            self.buf.append((delta << 4) | ftype)
        else:
            self.buf.append(ftype)
            self._varint(((fid << 1) ^ (fid >> 15)) & 0xFFFF)
        self._last[-1] = fid

    def i32(self, fid: int, v: int) -> "_Thrift":
        self._field(fid, 5)
        self._varint(((v << 1) ^ (v >> 31)) & 0xFFFFFFFF)
        return self

    def i64(self, fid: int, v: int) -> "_Thrift":
        self._field(fid, 6)
        self._varint(((v << 1) ^ (v >> 63)) & 0xFFFFFFFFFFFFFFFF)
        return self

    def binary(self, fid: int, b: bytes) -> "_Thrift":
        self._field(fid, 8)
        self._varint(len(b))
        self.buf += b
        return self

    def boolean(self, fid: int, v: bool) -> "_Thrift":
        self._field(fid, 1 if v else 2)
        return self

    def begin(self, fid: Optional[int] = None) -> "_Thrift":
        """A struct: a field of the current struct, or (fid None) a list
        element."""
        if fid is not None:
            self._field(fid, 12)
        self._last.append(0)
        return self

    def end(self) -> "_Thrift":
        self.buf.append(0)
        self._last.pop()
        return self

    def list(self, fid: int, elem: int, size: int) -> "_Thrift":
        self._field(fid, 9)
        if size < 15:
            self.buf.append((size << 4) | elem)
        else:
            self.buf.append(0xF0 | elem)
            self._varint(size)
        return self


# ---------------------------------------------------------------------------
# RLE / bit-packed hybrid (parquet-mr's RunLengthBitPackingHybridEncoder)
# ---------------------------------------------------------------------------

def _uvarint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _bitpack(vals: np.ndarray, width: int) -> bytes:
    """LSB-first bit-packing of ``vals`` (a multiple of 8 of them): each
    group of 8 values is ``width`` bytes, assembled in 64-bit words."""
    if width == 0 or vals.size == 0:
        return b""
    g = vals.astype(np.uint64).reshape(-1, 8)
    nwords = (8 * width + 63) // 64
    words = np.zeros((g.shape[0], nwords), np.uint64)
    for j in range(8):
        o = j * width
        w, sh = divmod(o, 64)
        words[:, w] |= g[:, j] << np.uint64(sh)
        if sh + width > 64:
            words[:, w + 1] |= g[:, j] >> np.uint64(64 - sh)
    return words.view(np.uint8)[:, :width].tobytes()


def hybrid_pages(v: np.ndarray, ends: Sequence[int],
                 widths: Sequence[int]) -> List[bytes]:
    """The hybrid encoding of each page of ``v`` (page p is
    [ends[p-1], ends[p]), its ints in [0, 2**widths[p])) as parquet-mr's
    encoder writes it, restarted at every page: from position s, 8 equal
    values make an RLE run to the end of their repeat, else 8 values are
    bit-packed and s advances by 8; a bit-packed run holds at most 63
    groups; a page's last group is padded with zeros. Vectorized over the
    pages but for the repeats of 8 or more, which are few."""
    v = np.asarray(v)
    n = v.shape[0]
    ends = np.asarray(ends, np.int64)
    begins = np.concatenate([[0], ends[:-1]])
    if n == 0:
        return [b""] * len(ends)
    brk = np.zeros(n, bool)
    np.not_equal(v[1:], v[:-1], out=brk[1:])
    brk[begins[begins < n]] = True  # the encoder restarts at each page
    starts = np.flatnonzero(brk)
    cuts = starts[1:] if starts.size and starts[0] == 0 else starts
    run_end = np.concatenate([cuts, [n]])
    long = run_end - starts >= 8  # only a repeat of 8 can make an RLE run
    # segments (page, start, end, rle): bit-packed [start, end) holds
    # whole groups (its end may pass the page's end: the padding)
    segs = []  # (page, start, end, rle)

    def close(p: int, s: int) -> None:  # bit-pack the rest of page p
        e = int(ends[p])
        if s < e:
            segs.append((p, s, s + ((e - s + 7) // 8) * 8, False))

    page_of = np.searchsorted(begins, starts[long], side="right") - 1
    p_cur, s = 0, 0
    for p, a, b in zip(page_of.tolist(), starts[long].tolist(),
                       run_end[long].tolist()):
        while p_cur < p:
            close(p_cur, s)
            p_cur += 1
            s = int(begins[p_cur])
        g = s + ((max(a, s) - s + 7) // 8) * 8
        if g + 8 <= b:
            if g > s:
                segs.append((p, s, g, False))
            segs.append((p, g, b, True))
            s = b
    while p_cur < len(ends):
        close(p_cur, s)
        p_cur += 1
        if p_cur < len(ends):
            s = int(begins[p_cur])
    seg_page, seg_a, seg_b, seg_rle = (list(x) for x in zip(*segs)) \
        if segs else ([], [], [], [])
    seg_page = np.asarray(seg_page, np.int64)
    seg_a = np.asarray(seg_a, np.int64)
    seg_b = np.asarray(seg_b, np.int64)
    seg_rle = np.asarray(seg_rle, bool)
    widths = np.asarray(widths, np.int64)
    # every bit-packed value, padding zeros included, packed per width
    bp = ~seg_rle
    lens = seg_b[bp] - seg_a[bp]
    sizes = ends - begins
    if seg_rle.any() or (sizes[:-1] % 8).any():
        total = int(lens.sum())
        first = np.zeros(lens.size, np.int64)
        np.cumsum(lens[:-1], out=first[1:])
        pos = np.repeat(seg_a[bp] - first, lens) + np.arange(total)
        limit = np.repeat(ends[seg_page[bp]], lens)
        vals = np.where(pos < limit, v[np.minimum(pos, n - 1)], 0)
    else:  # whole pages bit-packed: only the last one pads
        vals = np.concatenate([v, np.zeros(-n % 8, v.dtype)])
    # the runs as written: a bit-packed segment splits into runs of at
    # most 63 groups, each run a varint header and its payload
    seg_w = widths[seg_page]
    groups = np.where(seg_rle, 0, (seg_b - seg_a) // 8)
    nrun = np.where(seg_rle, 1, (groups + 62) // 63)
    r_seg = np.repeat(np.arange(seg_page.size), nrun)
    r_k = np.arange(r_seg.size) - np.repeat(np.cumsum(nrun) - nrun, nrun)
    r_rle = seg_rle[r_seg]
    r_w = seg_w[r_seg]
    r_groups = np.minimum(63, groups[r_seg] - 63 * r_k)
    header = np.where(r_rle, (seg_b - seg_a)[r_seg] << 1,
                      (r_groups << 1) | 1)
    head_len = np.maximum(1, (_bitlen(header) + 6) // 7)
    pay_len = np.where(r_rle, (r_w + 7) // 8, r_groups * r_w)
    # payload sources, one buffer: each width's packed values, then each
    # RLE run's value as 4 little-endian bytes
    src_parts, src_off = [], np.zeros(r_seg.size, np.int64)
    base = 0
    bp_w = seg_w[bp]
    bp_at = np.concatenate([[0], np.cumsum(lens)])
    for w in np.unique(bp_w).tolist():
        mine = (~r_rle) & (r_w == w)
        pick = np.flatnonzero(bp_w == w)
        if pick[-1] - pick[0] + 1 == pick.size:  # one stretch of segments
            mine_vals = vals[bp_at[pick[0]]:bp_at[pick[-1] + 1]]
        else:
            mine_vals = vals[np.repeat(bp_w == w, lens)]
        src_parts.append(_bitpack(mine_vals, w))
        took = np.cumsum(np.where(mine, pay_len, 0))
        src_off[mine] = base + (took - pay_len)[mine]
        base += len(src_parts[-1])
    rle_vals = v[seg_a[r_seg[r_rle]]].astype("<u4")
    src_off[r_rle] = base + 4 * np.arange(rle_vals.size)
    src = np.frombuffer(b"".join(src_parts) + rle_vals.tobytes(), np.uint8)
    # scatter headers and payloads into one buffer, in run order
    size = head_len + pay_len
    at = np.cumsum(size) - size
    out = np.empty(int(size.sum()), np.uint8)
    shifts = 7 * np.arange(5)
    hbytes = ((header[:, None] >> shifts) & 0x7F) | np.where(
        shifts[None, :] < 7 * (head_len[:, None] - 1), 0x80, 0)
    live = np.arange(5)[None, :] < head_len[:, None]
    out[(at[:, None] + np.arange(5))[live]] = hbytes[live]
    within = np.arange(int(pay_len.sum())) - np.repeat(
        np.cumsum(pay_len) - pay_len, pay_len)
    out[np.repeat(at + head_len, pay_len) + within] = src[
        np.repeat(src_off, pay_len) + within]
    page_end = np.cumsum(np.bincount(seg_page[r_seg], weights=size,
                                     minlength=len(ends)).astype(np.int64))
    return [out[e - sz:e].tobytes() for e, sz in zip(
        page_end.tolist(), np.diff(np.concatenate([[0], page_end])).tolist())]


def _bitlen(x: np.ndarray) -> np.ndarray:
    """Bit length of each non-negative int64."""
    out = np.zeros(x.shape, np.int64)
    y = x.copy()
    while True:
        nz = y > 0
        if not nz.any():
            return out
        out += nz
        y >>= 1


def hybrid_encode(v: np.ndarray, width: int) -> bytes:
    """The hybrid encoding of one page (see ``hybrid_pages``)."""
    return hybrid_pages(v, [len(v)], [width])[0]


# ---------------------------------------------------------------------------
# column chunks
# ---------------------------------------------------------------------------

def _plain_fixed(vals: np.ndarray) -> bytes:
    if vals.dtype == np.bool_:
        return np.packbits(vals, bitorder="little").tobytes()
    return vals.astype(vals.dtype.newbyteorder("<"), copy=False).tobytes()


def _plain_flba(vals: np.ndarray, width: int) -> bytes:
    """int64 values as ``width``-byte big-endian two's complement."""
    be = vals.astype(">i8").view(np.uint8).reshape(-1, 8)
    return be[:, 8 - width:].tobytes()


def _plain_strings(lens: np.ndarray, chars: np.ndarray,
                   starts: np.ndarray) -> bytes:
    """PLAIN BYTE_ARRAY: a u32 length before each value."""
    out = bytearray()
    pack = struct.Struct("<I").pack
    for ln, st in zip(lens.tolist(), starts.tolist()):
        out += pack(ln)
        out += chars[st:st + ln].tobytes()
    return bytes(out)


class _Stored:
    """The non-null values of one column chunk, in row order, with
    accessors the encoders need."""

    def __init__(self, col: ParquetColumn, lo: int, hi: int):
        self.col = col
        valid = None if col.valid is None else col.valid[lo:hi]
        self.valid = valid
        rows = slice(lo, hi) if valid is None else np.flatnonzero(valid) + lo
        # chunk row of each stored value
        self.rows = (np.arange(hi - lo) if valid is None
                     else rows - lo)
        if col.physical != _BYTE_ARRAY:
            self.values = col.values[rows]
        elif col.codes is not None:
            self.codes = col.codes[rows].astype(np.int64)
            lens = np.array([len(e) for e in col.entries], np.int64)
            self.lens = lens[self.codes]
        else:
            idx = np.arange(lo, hi) if valid is None else rows
            self.starts = col.offsets[idx]
            self.lens = col.offsets[idx + 1] - self.starts

    def plain_bytes(self) -> np.ndarray:
        """Plain-encoded size of each stored value (parquet-mr's raw size
        accounting)."""
        if self.col.physical == _BYTE_ARRAY:
            return 4 + self.lens
        if self.col.physical == _BOOLEAN:
            return np.full(self.rows.shape[0], 1 / 8)
        if self.col.physical == _FLBA:
            return np.full(self.rows.shape[0], self.col.type_length)
        return np.full(self.rows.shape[0], self.col.values.itemsize)

    def plain(self, i: int, j: int) -> bytes:
        if self.col.physical == _FLBA:
            return _plain_flba(self.values[i:j], self.col.type_length)
        if self.col.physical != _BYTE_ARRAY:
            return _plain_fixed(self.values[i:j])
        if self.col.codes is not None:
            ents = self.col.entries
            pack = struct.Struct("<I").pack
            return b"".join(pack(len(ents[c])) + ents[c]
                            for c in self.codes[i:j].tolist())
        return _plain_strings(self.lens[i:j], self.col.chars,
                              self.starts[i:j])

    def dictionary(self, upto: int):
        """Dictionary of the first ``upto`` stored values: (ids, entries in
        id order, plain bytes of each entry, first stored position of
        each entry). Entries in parquet-mr's first-seen order (keyed by
        bit pattern, so a NaN keeps its payload), or for handed codes the
        entries the whole chunk uses, in the order given."""
        col = self.col
        if col.physical == _BYTE_ARRAY and col.codes is not None:
            used = np.flatnonzero(np.bincount(self.codes,
                                              minlength=len(col.entries)))
            remap = np.full(len(col.entries), -1, np.int64)
            remap[used] = np.arange(used.size)
            ents = [col.entries[c] for c in used.tolist()]
            ids = remap[self.codes[:upto]]
            first = np.full(len(ents), upto, np.int64)
            np.minimum.at(first, ids, np.arange(upto))
            return (ids, ents, np.array([4 + len(e) for e in ents],
                                        np.int64), first)
        if col.physical == _BYTE_ARRAY:
            keys = np.array([col.chars[s:s + n].tobytes() for s, n in
                             zip(self.starts[:upto].tolist(),
                                 self.lens[:upto].tolist())], dtype=object)
            uniq, inv = np.unique(keys, return_inverse=True)
            codes = inv.reshape(-1)
        else:
            vals = self.values[:upto]
            keys = vals.view(np.dtype(f"u{vals.itemsize}"))
            lo = int(keys.min()) if upto else 0
            span = int(keys.max()) - lo + 1 if upto else 1
            if span <= max(1 << 16, 4 * upto):
                codes = (keys - keys.dtype.type(lo)).astype(np.int64)
                uniq = None
            else:
                uniq, inv = np.unique(keys, return_inverse=True)
                codes = inv.reshape(-1)
                span = uniq.size
        first = np.full(span if uniq is None else len(uniq), upto, np.int64)
        np.minimum.at(first, codes, np.arange(upto))
        order = np.flatnonzero(first < upto)
        order = order[np.argsort(first[order], kind="stable")]
        rank = np.empty(first.size, np.int64)
        rank[order] = np.arange(order.size)
        ids = rank[codes]
        if col.physical == _BYTE_ARRAY:
            ents = [uniq[k] for k in order.tolist()]
            return (ids, ents, np.array([4 + len(e) for e in ents],
                                        np.int64), first[order])
        pos = first[order]
        ents = vals[pos]
        return ids, ents, np.full(ents.size, ents.itemsize, np.int64), pos


def _page_ends(rows: int, value_rows: np.ndarray, value_bytes: np.ndarray,
               start: int, page_rows: int,
               snap: Optional[np.ndarray] = None) -> List[int]:
    """Row ends of the pages from row ``start``: a page closes at
    ``page_rows`` rows or once its values reach ``PAGE_BYTES``, moved on
    to the next end in ``snap`` (where a nested column's row ends; sorted,
    last ``rows``) when given."""
    def at(e: int) -> int:
        return e if snap is None else int(snap[np.searchsorted(snap, e)])

    if value_bytes is None:  # no value can reach the byte cap
        ends = []
        for e in list(range(start + page_rows, rows, page_rows)) + [rows]:
            e = at(e)
            if not ends or e > ends[-1]:
                ends.append(e)
        return ends
    ends = []
    cum = np.concatenate([[0], np.cumsum(value_bytes)])
    r = start
    while r < rows:
        e = min(rows, r + page_rows)
        i0, i1 = np.searchsorted(value_rows, [r, e])
        # the value that brings the page to the cap closes it
        k = np.searchsorted(cum, cum[i0] + PAGE_BYTES, side="left")
        if k <= i1:
            e = min(e, int(value_rows[k - 1]) + 1)
        e = at(e)
        ends.append(e)
        r = e
    return ends


def _page(ptype: int, payload: bytes, num_values: int, encoding: int,
          rep_encoding: int = _BIT_PACKED) -> bytes:
    t = _Thrift()
    t.i32(1, ptype).i32(2, len(payload)).i32(3, len(payload))
    crc = zlib.crc32(payload)
    t.i32(4, crc - (1 << 32) if crc >= 1 << 31 else crc)
    if ptype == _DATA_PAGE:
        t.begin(5).i32(1, num_values).i32(2, encoding).i32(3, _RLE) \
            .i32(4, rep_encoding).end()
    else:
        t.begin(7).i32(1, num_values).i32(2, encoding).boolean(3, False)\
            .end()
    t.buf.append(0)
    return bytes(t.buf) + payload


def _def_levels(valid: Optional[np.ndarray], begin: int,
                ends: Sequence[int]) -> List[bytes]:
    """The v1 definition levels (u32 length + hybrid, width 1) of each
    page [ends[p-1], ends[p]) from chunk row ``begin``."""
    begins = [begin] + list(ends[:-1])
    if valid is None:
        bodies = [_uvarint((e - b) << 1) + b"\x01" if e - b >= 8
                  else hybrid_encode(np.ones(e - b, np.uint8), 1)
                  for b, e in zip(begins, ends)]  # one RLE run of 1s
    else:
        bodies = hybrid_pages(valid[begin:ends[-1]].view(np.uint8),
                              np.asarray(ends) - begin, [1] * len(ends))
    return [struct.pack("<I", len(x)) + x for x in bodies]


def _nested_levels(levels, lo: int, begin: int,
                   ends: Sequence[int]) -> List[bytes]:
    """The v1 repetition levels (none where ``max_rep`` is 0), then
    definition levels (each a u32 length + the hybrid at the width of its
    maximum) of each page [ends[p-1], ends[p])
    from chunk entry ``begin``; ``levels`` = (defs, reps, max_def,
    max_rep) of the whole column, the chunk from entry ``lo``."""
    defs, reps, max_def, max_rep = levels
    seg = slice(lo + begin, lo + ends[-1])
    rel = np.asarray(ends) - begin
    pack = struct.Struct("<I").pack
    out = [pack(len(d)) + d for d in
           hybrid_pages(defs[seg], rel, [_width(max_def)] * len(ends))]
    if max_rep == 0:  # a leaf under no LIST has no repetition levels
        return out
    return [pack(len(r)) + r + d for r, d in zip(
        hybrid_pages(reps[seg], rel, [_width(max_rep)] * len(ends)), out)]


def _width(max_id: int) -> int:
    return int(max_id).bit_length()


def _dict_pages(st: "_Stored", rows: int, page_rows: int,
                dict_bytes_cap: int, snap: Optional[np.ndarray] = None):
    """parquet-mr's dictionary decision for one chunk: (index-page
    bodies, their row ends, the entries of the dictionary page), or None
    when the dictionary is dropped at the first page. Pages from the one
    where the dictionary passes the cap on fall back to PLAIN."""
    col, vrows = st.col, st.rows
    raw = st.plain_bytes()
    ends = _page_ends(rows, vrows, None, 0, page_rows, snap)
    handed = col.codes is not None
    # the first page decides; the whole chunk's dictionary is computed
    # only when it is kept (first-seen ids of a prefix do not change)
    for upto in (int(np.searchsorted(vrows, ends[0])), vrows.size):
        ids, ents, ebytes, first = st.dictionary(upto)
        # dictionary bytes after each stored value (parquet-mr checks the
        # cap after every write)
        seen = first < upto
        grown = np.zeros(upto, np.int64)
        np.add.at(grown, first[seen], ebytes[seen])
        dict_size = np.cumsum(grown)
        over = np.flatnonzero(dict_size > dict_bytes_cap)
        fall_row = int(vrows[over[0]]) if over.size else rows
        if handed and fall_row < rows:
            raise ValueError(f"{col.name}: a handed dictionary must stay "
                             f"under {dict_bytes_cap} bytes")
        stops = np.searchsorted(vrows, ends)
        k = int(np.searchsorted(ends, fall_row, side="right"))
        k = min(k, int(np.searchsorted(stops, upto, side="right")))
        if k == 0:
            return None
        stops = stops[:k]
        if handed:
            widths = [_width(len(ents) - 1)] * k
        else:
            cummax = np.maximum.accumulate(ids[:stops[-1]]) \
                if stops[-1] else np.zeros(1, np.int64)
            widths = [_width(cummax[i - 1]) if i else 0
                      for i in stops.tolist()]
        bodies = hybrid_pages(ids[:stops[-1]], stops, widths)
        bodies = [bytes([w]) + x for w, x in zip(widths, bodies)]
        i1 = int(stops[0])
        used = (int(ebytes.sum()) if handed
                else int(dict_size[i1 - 1]) if i1 else 0)
        if len(bodies[0]) + used >= float(raw[:i1].sum()):
            return None  # the first page does not compress
    if fall_row < rows:
        # the dictionary page holds what was seen up to the fallback
        ents = ents[:int((first <= over[0]).sum())]
    return bodies, ends[:k], ents


def _encode_chunk(col: ParquetColumn, lo: int, hi: int, page_rows: int,
                  dict_bytes_cap: int, levels=None):
    """(dictionary page or None, data pages, the encodings used, the
    stored values) of rows [lo, hi) of ``col``. A nested leaf passes its
    entries as ``col`` (valid = def == max_def) and ``levels`` = (defs,
    reps, max_def, max_rep) over all its entries: [lo, hi) are entries
    then, and a page ends where a row does."""
    st = _Stored(col, lo, hi)
    rows = hi - lo
    vrows = st.rows
    snap = None
    # a leaf under a LIST writes its repetition levels in the hybrid (RLE)
    rep_enc = _RLE if levels is not None and levels[3] else _BIT_PACKED
    if levels is None:
        def level_pages(begin, ends):
            return _def_levels(st.valid, begin, ends)
    else:
        snap = np.append(np.flatnonzero(levels[1][lo:hi] == 0)[1:], rows)

        def level_pages(begin, ends):
            return _nested_levels(levels, lo, begin, ends)
    pages = []
    encodings = {_RLE, _BIT_PACKED}
    dict_page = None
    plain_from = 0  # chunk row where PLAIN pages start
    got = None
    if col.physical not in (_BOOLEAN, _FLBA) and vrows.size:
        got = _dict_pages(st, rows, page_rows, dict_bytes_cap, snap)
    if got is not None:
        bodies, ends, ents = got
        for lv, body, b, e in zip(level_pages(0, ends), bodies,
                                  [0] + ends[:-1], ends):
            pages.append(_page(_DATA_PAGE, lv + body, e - b,
                               _PLAIN_DICTIONARY, rep_enc))
        plain_from = ends[-1]
        if col.physical == _BYTE_ARRAY:
            dpay = b"".join(struct.pack("<I", len(x)) + x for x in ents)
        else:
            dpay = _plain_fixed(np.asarray(ents))
        dict_page = _page(_DICTIONARY_PAGE, dpay, len(ents),
                          _PLAIN_DICTIONARY)
        encodings.add(_PLAIN_DICTIONARY)
    if plain_from < rows:
        encodings.add(_PLAIN)
        raw = st.plain_bytes()
        # a fixed-width page reaches the byte cap only past page_rows
        capped = None if col.physical != _BYTE_ARRAY and \
            float(raw[0] if raw.size else 0) * page_rows < PAGE_BYTES \
            else raw
        ends = _page_ends(rows, vrows, capped, plain_from, page_rows, snap)
        begins = [plain_from] + ends[:-1]
        stops = np.searchsorted(vrows, [plain_from] + ends)
        for i, (lv, b, e) in enumerate(zip(level_pages(plain_from, ends),
                                           begins, ends)):
            pages.append(_page(_DATA_PAGE,
                               lv + st.plain(int(stops[i]),
                                             int(stops[i + 1])),
                               e - b, _PLAIN, rep_enc))
    return dict_page, pages, encodings, st


def _stats(t: _Thrift, col: ParquetColumn, st: _Stored, nulls: int) -> None:
    t.begin(12)
    ints = col.physical in (_INT32, _INT64, _FLBA) and st.values.size
    if ints:
        lo_v, hi_v = st.values.min(keepdims=True), st.values.max(
            keepdims=True)
        if col.physical == _FLBA:
            lo = _plain_flba(lo_v, col.type_length)
            hi = _plain_flba(hi_v, col.type_length)
        else:
            fmt = "<i" if col.physical == _INT32 else "<q"
            lo, hi = struct.pack(fmt, int(lo_v[0])), struct.pack(
                fmt, int(hi_v[0]))
            t.binary(1, hi).binary(2, lo)
    t.i64(3, nulls)
    if ints:
        t.binary(5, hi).binary(6, lo)
    t.end()


@dataclass
class _Leaf:
    """One leaf column chunk source: its schema path, the column it
    encodes (a nested leaf's entries), and for a nested leaf its levels
    (defs, reps, max_def, max_rep) and each row's first entry
    (``row_entry``, rows + 1)."""

    path: List[str]
    col: ParquetColumn
    levels: Optional[tuple] = None
    row_entry: Optional[np.ndarray] = None

    def span(self, lo: int, hi: int) -> Tuple[int, int]:
        """The entries of rows [lo, hi)."""
        if self.row_entry is None:
            return lo, hi
        return int(self.row_entry[lo]), int(self.row_entry[hi])

    def encode(self, lo: int, hi: int, page_rows: int, cap: int):
        a, b = self.span(lo, hi)
        return _encode_chunk(self.col, a, b, page_rows, cap, self.levels)


def _entry_column(col: ParquetColumn, src: np.ndarray,
                  stored: np.ndarray) -> ParquetColumn:
    """A leaf's values laid out over its entries: entry k holds value
    ``src[k]`` where ``stored[k]``, else nothing (a null entry)."""
    rows = np.where(stored, src, 0)
    if col.physical != _BYTE_ARRAY:
        return ParquetColumn(col.name, values=col.values[rows],
                             valid=stored, converted=col.converted,
                             decimal=col.decimal)
    if col.codes is not None:
        return ParquetColumn(col.name, codes=col.codes[rows],
                             entries=col.entries, valid=stored,
                             converted=col.converted)
    lens = np.where(stored, col.offsets[rows + 1] - col.offsets[rows], 0)
    offsets = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    first = np.repeat(col.offsets[rows] - offsets[:-1], lens)
    chars = col.chars[first + np.arange(int(offsets[-1]))]
    return ParquetColumn(col.name, chars=chars, offsets=offsets,
                         valid=stored, converted=col.converted)


def _shred(node, src, d, r, max_def, max_rep, path, out) -> None:
    """Record shredding of ``node`` (every field OPTIONAL, as Spark writes
    them): ``src`` each entry's row of the node (-1: no value reaches it),
    ``d``/``r`` its definition and repetition levels so far."""
    max_def += 1
    have = src >= 0
    if node.valid is not None:
        have &= node.valid[np.maximum(src, 0)]
    d = np.where(have, max_def, d)
    src = np.where(have, src, -1)
    if isinstance(node, ParquetColumn):
        stored = d == max_def
        entries = np.append(np.flatnonzero(r == 0), r.size)
        out.append(_Leaf(path + [node.name],
                         _entry_column(node, src, stored),
                         (d.astype(np.int32), r.astype(np.int32), max_def,
                          max_rep), entries))
    elif isinstance(node, StructField):
        for f in node.fields:
            _shred(f, src, d, r, max_def, max_rep, path + [node.name], out)
    else:  # ListField: its repeated group "list", one entry per element
        offs = np.asarray(node.offsets, np.int64)
        lens = np.where(have, offs[1:][np.maximum(src, 0)]
                        - offs[:-1][np.maximum(src, 0)], 0)
        each = np.maximum(lens, 1)
        at = np.repeat(np.arange(src.size), each)
        k = np.arange(at.size) - np.repeat(np.cumsum(each) - each, each)
        elem = lens[at] > 0
        nsrc = np.where(elem, offs[:-1][np.maximum(src, 0)][at] + k, -1)
        nd = np.where(elem, max_def + 1, d[at])
        nr = np.where(k == 0, r[at], max_rep + 1)
        element = node.element
        named = (replace(element, name="element")
                 if isinstance(element, ParquetColumn)
                 else StructField("element", element.fields, element.valid))
        _shred(named, nsrc, nd, nr, max_def + 1, max_rep + 1,
               path + [node.name, "list"], out)


def _leaves(columns) -> List[_Leaf]:
    out: List[_Leaf] = []
    for c in columns:
        if isinstance(c, ParquetColumn):
            out.append(_Leaf([c.name], c))
            continue
        n = c.rows
        _shred(c, np.arange(n), np.zeros(n, np.int64),
               np.zeros(n, np.int64), 0, 0, [], out)
    return out


def _schema_node(t: _Thrift, c) -> int:
    """Schema elements of ``c`` depth first; returns how many."""
    if isinstance(c, ParquetColumn):
        t.begin().i32(1, c.physical)
        if c.physical == _FLBA:
            t.i32(2, c.type_length)
        t.i32(3, _OPTIONAL)
        t.binary(4, c.name.encode())
        if c.decimal is not None:
            t.i32(6, DECIMAL).i32(7, c.decimal[1]).i32(8, c.decimal[0])
        elif c.converted is not None:
            t.i32(6, c.converted)
        t.end()
        return 1
    if isinstance(c, StructField):
        t.begin().i32(3, _OPTIONAL).binary(4, c.name.encode()) \
            .i32(5, len(c.fields)).end()
        return 1 + sum(_schema_node(t, f) for f in c.fields)
    t.begin().i32(3, _OPTIONAL).binary(4, c.name.encode()).i32(5, 1) \
        .i32(6, _CT_LIST).end()
    t.begin().i32(3, _REPEATED).binary(4, b"list").i32(5, 1).end()
    element = c.element
    named = (replace(element, name="element")
             if isinstance(element, ParquetColumn)
             else StructField("element", element.fields, element.valid))
    return 2 + _schema_node(t, named)


def _count_nodes(c) -> int:
    if isinstance(c, ParquetColumn):
        return 1
    if isinstance(c, StructField):
        return 1 + sum(_count_nodes(f) for f in c.fields)
    return 2 + _count_nodes(c.element)


def _schema(t: _Thrift, columns) -> None:
    t.list(2, 12, 1 + sum(_count_nodes(c) for c in columns))
    t.begin().binary(4, b"spark_schema").i32(5, len(columns)).end()
    for c in columns:
        _schema_node(t, c)


def _group_rows(leaves: Sequence[_Leaf], start: int, rows: int,
                page_rows: int, dict_bytes_cap: int) -> int:
    """Rows of the row group from ``start``: the group's encoded bytes
    per row, read off an encoding of its first pages, against
    ``target``; whole pages, at least one."""
    sample = min(rows - start, 4 * page_rows)
    size = 0
    for leaf in leaves:
        d, pages, _, _ = leaf.encode(start, start + sample, page_rows,
                                     dict_bytes_cap)
        size += sum(len(p) for p in pages) + (len(d) if d else 0)
    per_row = max(size / sample, 1e-9)
    fit = int(ROW_GROUP_BYTES / per_row) // page_rows * page_rows
    return min(rows - start, max(page_rows, fit))


def write_parquet(path: str, columns: Sequence[object],
                  page_rows: int = PAGE_ROWS,
                  dict_page_bytes: int = DICT_PAGE_BYTES,
                  row_group_rows: Optional[int] = None) -> dict:
    """Write ``columns`` (ParquetColumn, StructField or ListField, equal
    row counts) to ``path``. Row groups hold ``row_group_rows`` rows when
    given, else ~``ROW_GROUP_BYTES``; the tests shrink ``page_rows`` and
    ``dict_page_bytes`` (a nested leaf's pages count entries).
    Returns {"row_groups": [rows...], "bytes": file size, "encodings":
    {leaf path: [encoding names of its chunks]}}."""
    rows = columns[0].rows
    if any(c.rows != rows for c in columns):
        raise ValueError("columns must share a row count")
    leaves = _leaves(columns)
    bounds = []
    start = 0
    while start < rows or not bounds:
        n = (min(row_group_rows, rows - start) if row_group_rows
             else _group_rows(leaves, start, rows, page_rows,
                              dict_page_bytes)
             if rows else 0)
        bounds.append((start, n))
        start += n
    # every (row group, leaf) chunk encodes in parallel (numpy and zlib
    # release the GIL)
    with ThreadPoolExecutor(max_workers=8) as pool:
        encoded = list(pool.map(
            lambda job: job[1].encode(job[0][0], job[0][0] + job[0][1],
                                      page_rows, dict_page_bytes),
            [(b, leaf) for b in bounds for leaf in leaves]))
    body = bytearray(b"PAR1")
    groups = []
    used = {".".join(leaf.path): [] for leaf in leaves}
    names = {_PLAIN: "PLAIN", _PLAIN_DICTIONARY: "PLAIN_DICTIONARY"}
    for gi, (start, n) in enumerate(bounds):
        chunks = []
        for li, leaf in enumerate(leaves):
            d, pages, enc, st = encoded[gi * len(leaves) + li]
            a, b = leaf.span(start, start + n)
            chunk_off = len(body)
            dict_off = None
            if d is not None:
                dict_off = len(body)
                body += d
            data_off = len(body)
            for p in pages:
                body += p
            used[".".join(leaf.path)].append(
                sorted(names[e] for e in enc if e in names))
            chunks.append((leaf, chunk_off, dict_off, data_off,
                           len(body) - chunk_off, enc, st,
                           (b - a) - st.rows.size, b - a))
        groups.append((start, n, chunks))
    t = _Thrift()
    t.i32(1, 1)
    _schema(t, columns)
    t.i64(3, rows)
    t.list(4, 12, len(groups))
    for _, n, chunks in groups:
        t.begin()
        t.list(1, 12, len(chunks))
        total = 0
        for leaf, off, dict_off, data_off, size, enc, st, nulls, nv \
                in chunks:
            c = leaf.col
            total += size
            t.begin().i64(2, off)
            t.begin(3).i32(1, c.physical)
            t.list(2, 5, len(enc))
            for e in sorted(enc):
                t._varint(((e << 1) ^ (e >> 31)) & 0xFFFFFFFF)
            t.list(3, 8, len(leaf.path))
            for part in leaf.path:
                t._varint(len(part.encode()))
                t.buf += part.encode()
            t.i32(4, 0).i64(5, nv).i64(6, size).i64(7, size)
            t.i64(9, data_off)
            if dict_off is not None:
                t.i64(11, dict_off)
            _stats(t, c, st, nulls)
            t.end()  # ColumnMetaData
            t.end()  # ColumnChunk
        t.i64(2, total).i64(3, n)
        t.end()
    t.binary(6, b"spark_rapids_jni_tpu_torch datagen_parquet "
                b"(parquet-mr 1.x v1 writer defaults, uncompressed)")
    t.buf.append(0)
    body += t.buf
    body += struct.pack("<I", len(t.buf)) + b"PAR1"
    with open(path, "wb") as f:
        f.write(body)
    return {"row_groups": [n for _, n, _ in groups], "bytes": len(body),
            "encodings": used}
