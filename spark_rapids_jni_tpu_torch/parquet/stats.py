"""Column-chunk statistics from the parquet footer (min/max pruning); the
JAX package's parquet/stats.py.

The native footer parser (thrift_compact.hpp) surfaces schema and chunk
ranges but not the optional ``Statistics`` struct; this module parses the
SAME footer bytes the reader already holds (``ParquetReader._footer``) a
second time, pulling only ``FileMetaData.row_groups[*].columns[*]
.meta_data.statistics`` — a few hundred bytes of run metadata, never row
data.

Deliberately defensive: statistics drive row-group PRUNING, where a wrong
answer silently drops rows. Any structural anomaly — truncated varint,
nested depth, bad list header, min > max, unexpected value width — makes
the parser return nothing for that chunk (or the whole footer), and the
reader treats missing stats as "cannot prune". Corrupt stats therefore
cost performance, never correctness.

Thrift compact protocol subset (the only containers FileMetaData needs):
field header ``(delta << 4) | type`` with long-form id escape, zigzag
varints for i16/i32/i64, varint-length binary, ``(size << 4) | elem``
list headers.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

# compact-protocol type ids
_T_STOP, _T_TRUE, _T_FALSE, _T_BYTE = 0, 1, 2, 3
_T_I16, _T_I32, _T_I64, _T_DOUBLE = 4, 5, 6, 7
_T_BINARY, _T_LIST, _T_SET, _T_MAP, _T_STRUCT = 8, 9, 10, 11, 12

# parquet physical types with a sortable fixed little-endian plain encoding
_PT_INT32, _PT_INT64 = 1, 2

_MAX_DEPTH = 32


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ValueError("eof")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            raise ValueError("eof")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                return out
            shift += 7
            if shift > 63:
                raise ValueError("varint overflow")

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)


def _skip(c: _Cursor, ftype: int, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("depth")
    if ftype in (_T_TRUE, _T_FALSE):
        return
    if ftype in (_T_BYTE,):
        c.byte()
        return
    if ftype in (_T_I16, _T_I32, _T_I64):
        c.varint()
        return
    if ftype == _T_DOUBLE:
        c.take(8)
        return
    if ftype == _T_BINARY:
        c.take(c.varint())
        return
    if ftype in (_T_LIST, _T_SET):
        size, elem = _list_header(c)
        for _ in range(size):
            _skip(c, elem, depth + 1)
        return
    if ftype == _T_MAP:
        size = c.varint()
        if size:
            kv = c.byte()
            for _ in range(size):
                _skip(c, kv >> 4, depth + 1)
                _skip(c, kv & 0x0F, depth + 1)
        return
    if ftype == _T_STRUCT:
        _skip_struct(c, depth + 1)
        return
    raise ValueError(f"bad type {ftype}")


def _list_header(c: _Cursor) -> Tuple[int, int]:
    h = c.byte()
    size, elem = h >> 4, h & 0x0F
    if size == 15:
        size = c.varint()
    if size < 0 or size > 1 << 24:
        raise ValueError("bad list size")
    return size, elem


def _fields(c: _Cursor, depth: int):
    """Yield (field_id, type) for one struct, consuming values via the
    caller (caller must read or _skip each yielded field's value)."""
    if depth > _MAX_DEPTH:
        raise ValueError("depth")
    fid = 0
    while True:
        h = c.byte()
        if h == _T_STOP:
            return
        delta, ftype = h >> 4, h & 0x0F
        if ftype in (0,):
            raise ValueError("bad field type")
        if delta:
            fid += delta
        else:
            fid = c.zigzag()
        yield fid, ftype


def _skip_struct(c: _Cursor, depth: int) -> None:
    for _fid, ftype in _fields(c, depth):
        _skip(c, ftype, depth)


def _parse_statistics(c: _Cursor, depth: int) -> dict:
    """Statistics struct -> raw fields. Prefers min_value/max_value (5/6,
    well-ordered by spec) and keeps legacy min/max (1/2) separately —
    the caller decides whether the physical type makes legacy safe."""
    out: dict = {}
    for fid, ftype in _fields(c, depth):
        if fid in (1, 2, 5, 6) and ftype == _T_BINARY:
            out[{1: "max_legacy", 2: "min_legacy",
                 5: "max_value", 6: "min_value"}[fid]] = c.take(c.varint())
        elif fid == 3 and ftype in (_T_I16, _T_I32, _T_I64):
            out["null_count"] = c.zigzag()
        else:
            _skip(c, ftype, depth)
    return out


def _parse_column_meta(c: _Cursor, depth: int) -> dict:
    out: dict = {}
    for fid, ftype in _fields(c, depth):
        if fid == 1 and ftype in (_T_I16, _T_I32, _T_I64):
            out["type"] = c.zigzag()
        elif fid == 12 and ftype == _T_STRUCT:
            out["statistics"] = _parse_statistics(c, depth + 1)
        else:
            _skip(c, ftype, depth)
    return out


def _parse_column_chunk(c: _Cursor, depth: int) -> dict:
    out: dict = {}
    for fid, ftype in _fields(c, depth):
        if fid == 3 and ftype == _T_STRUCT:
            out = _parse_column_meta(c, depth + 1)
        else:
            _skip(c, ftype, depth)
    return out


def _parse_row_group(c: _Cursor, depth: int) -> list:
    cols: list = []
    for fid, ftype in _fields(c, depth):
        if fid == 1 and ftype == _T_LIST:
            size, elem = _list_header(c)
            if elem != _T_STRUCT:
                raise ValueError("row group columns not structs")
            cols = [_parse_column_chunk(c, depth + 1) for _ in range(size)]
        else:
            _skip(c, ftype, depth)
    return cols


def _decode_int(raw: bytes, physical: int) -> Optional[int]:
    """Plain-encoded statistics value -> python int, or None when the
    byte width doesn't match the physical type (corrupt/foreign stats)."""
    if physical == _PT_INT32:
        if len(raw) != 4:
            return None
        return struct.unpack("<i", raw)[0]
    if physical == _PT_INT64:
        if len(raw) != 8:
            return None
        return struct.unpack("<q", raw)[0]
    return None


def chunk_int_ranges(footer: bytes) -> Dict[Tuple[int, int], Tuple[int, int]]:
    """Parse ``footer`` (raw FileMetaData bytes, PAR1 framing already
    stripped) into ``{(row_group, leaf_index): (min, max)}`` for INT32/
    INT64 chunks that carry usable statistics. Chunks appear in schema
    leaf order within each row group (parquet spec), so the list position
    IS the reader's leaf index.

    Signed little-endian ints order identically under the legacy and the
    v2 (min_value/max_value) definitions, so either field set qualifies —
    v2 preferred when both exist. Anything anomalous (parse error
    anywhere, width mismatch, min > max) yields no entry for that chunk,
    or an empty dict when the footer itself doesn't parse: absent stats
    never prune."""
    try:
        c = _Cursor(footer)
        groups: list = []
        for fid, ftype in _fields(c, 0):
            if fid == 4 and ftype == _T_LIST:
                size, elem = _list_header(c)
                if elem != _T_STRUCT:
                    raise ValueError("row_groups not structs")
                groups = [_parse_row_group(c, 1) for _ in range(size)]
            else:
                _skip(c, ftype, 0)
    except (ValueError, IndexError, struct.error):
        return {}
    out: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for g, cols in enumerate(groups):
        for leaf, meta in enumerate(cols):
            phys = meta.get("type")
            st = meta.get("statistics")
            if st is None or phys not in (_PT_INT32, _PT_INT64):
                continue
            lo_raw = st.get("min_value", st.get("min_legacy"))
            hi_raw = st.get("max_value", st.get("max_legacy"))
            if lo_raw is None or hi_raw is None:
                continue
            lo = _decode_int(lo_raw, phys)
            hi = _decode_int(hi_raw, phys)
            if lo is None or hi is None or lo > hi:
                continue  # corrupt stats: never prune on them
            out[(g, leaf)] = (lo, hi)
    return out
