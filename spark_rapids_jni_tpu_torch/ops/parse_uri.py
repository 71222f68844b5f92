"""Spark ``parse_url``: PROTOCOL, HOST and QUERY (with a query key) of a
STRING column (the JAX package's ops/parse_uri.py).

Reference capability: parse_uri.cu, a per-row RFC-3986-style validation
with a VALID/INVALID/FATAL trichotomy: FATAL (an illegal character
anywhere) nulls every part of the row; INVALID (a host that is neither
IPv6, IPv4 nor a domain name) nulls only that part. The expected
behaviour is pinned to java.net.URI.

Three implementations of one contract:

  * the Python oracle below (``_parse_one``, the ``py_*`` entries), kept
    for differential tests; its character classes are this package's own
    copy of the JAX package's tables;
  * the host tier: native/parse_uri.cpp built with g++ at first use
    (``_parse_uri_native.py``), run in process or, when
    ``sandbox.active("parse_uri")``, in a sandbox worker, always under
    ``guarded_dispatch("parse_uri", ...)``;
  * the device tier (``parse_uri_device.py``): torch ops over the padded
    byte matrix on the column's device, for PROTOCOL, HOST and QUERY.

``parse_uri.tier`` picks the tier (utils/backend.py): under ``auto`` a
CUDA column takes the device tier and a CPU column the host tier. A query
with a key (literal or column) runs on the host tier on either, as in the
JAX package. Each call counts its rows in ``backend.string_routes``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar.column import Column
from ..columnar.strings import pack_byte_rows
from ..utils.backend import string_routes, tier_is_device
from ..utils.tracing import func_range

# ---------------------------------------------------------------------------
# character classes (ASCII); bytes >= 0x80 are handled by the UTF-8 rules
# ---------------------------------------------------------------------------

_ALPHA = set(range(ord("a"), ord("z") + 1)) | set(range(ord("A"), ord("Z") + 1))
_DIGIT = set(range(ord("0"), ord("9") + 1))
_ALNUM = _ALPHA | _DIGIT
_HEX = _DIGIT | set(b"abcdefABCDEF")

def _cls(extra: bytes, ranges=()):
    s = set(_ALPHA) | set(extra)
    for lo, hi, exclude in ranges:
        s |= {c for c in range(lo, hi + 1) if c not in exclude}
    return s

# query: alphanum _-!."$&-;=?-] (no backslash) ~ + escapes
_QUERY_OK = _cls(b'!"$=_~', [(ord("&"), ord(";"), set()),
                             (ord("?"), ord("]"), {ord("\\")})])
# authority: !$&-; (no /) = @-_ (no ^ no backslash) ~
_AUTH_OK = _cls(b"!$=~", [(ord("&"), ord(";"), {ord("/")}),
                          (ord("@"), ord("_"), {ord("^"), ord("\\")})])
# path: !$&-;= @-Z _ ~
_PATH_OK = _cls(b"!$=_~", [(ord("&"), ord(";"), set()),
                           (ord("@"), ord("Z"), set())])
# opaque & fragment: !$&-;= ?-] (no backslash) _ ~
_OPAQUE_OK = _cls(b"!$=_~", [(ord("&"), ord(";"), set()),
                             (ord("?"), ord("]"), {ord("\\")})])
_FRAGMENT_OK = _OPAQUE_OK

# unicode whitespace/control code points rejected inside any chunk
_BAD_UNICODE = set(range(0x80, 0xA1)) | {0x1680, 0x2028, 0x202F, 0x205F,
                                         0x3000} | set(range(0x2000, 0x200B))


def _validate_chunk(b: bytes, allowed: set, allow_raw_percent=False) -> bool:
    """Byte-wise chunk validation: ASCII must be in ``allowed``, '%' must
    introduce two hex digits (unless ``allow_raw_percent``, the IPv6 zone-id
    escape hatch), multibyte sequences must be valid UTF-8 and not a unicode
    space/control (reference skip_and_validate_special, parse_uri.cu:92-151).
    """
    i, n = 0, len(b)
    while i < n:
        c = b[i]
        if c == ord("%") and not allow_raw_percent:
            if i + 2 >= n or b[i + 1] not in _HEX or b[i + 2] not in _HEX:
                return False
            i += 3
            continue
        if c >= 0x80:
            # decode one UTF-8 char
            if c >= 0xF0:
                width = 4
            elif c >= 0xE0:
                width = 3
            elif c >= 0xC0:
                width = 2
            else:
                return False  # stray continuation byte
            if i + width > n:
                return False
            try:
                ch = b[i:i + width].decode("utf-8")
            except UnicodeDecodeError:
                return False
            if ord(ch) in _BAD_UNICODE:
                return False
            i += width
            continue
        if c not in allowed and not (allow_raw_percent and c == ord("%")):
            return False
        i += 1
    return True


def _validate_scheme(b: bytes) -> bool:
    if not b or b[0] not in _ALPHA:
        return False
    return all(c in _ALNUM or c in b"+-." for c in b[1:])


def _validate_ipv6(b: bytes) -> bool:
    """Bracketed IPv6 incl. optional '%zone' and trailing IPv4 (reference
    validate_ipv6, parse_uri.cu:165-266)."""
    if len(b) < 2:
        return False
    double_colon = False
    colons = periods = percents = 0
    open_br = close_br = 0
    group_val = 0
    group_chars = 0
    group_has_hex = False
    prev = 0
    for c in b:
        if c == ord("["):
            open_br += 1
            if open_br > 1:
                return False
        elif c == ord("]"):
            close_br += 1
            if close_br > 1:
                return False
            if periods > 0 and (group_has_hex or group_val > 255):
                return False
        elif c == ord(":"):
            colons += 1
            if prev == ord(":"):
                if double_colon:
                    return False
                double_colon = True
            group_val, group_chars, group_has_hex = 0, 0, False
            if colons > 8 or (colons == 8 and not double_colon):
                return False
            if periods > 0 or percents > 0:
                return False
        elif c == ord("."):
            periods += 1
            if percents > 0 or periods > 3 or group_has_hex or group_val > 255:
                return False
            if colons != 6 and not double_colon:
                return False
            if colons >= 8:
                return False
            group_val, group_chars, group_has_hex = 0, 0, False
        elif c == ord("%"):
            percents += 1
            if percents > 1:
                return False
            if periods > 0 and (group_has_hex or group_val > 255):
                return False
            group_val, group_chars, group_has_hex = 0, 0, False
        else:
            if percents == 0:  # inside the zone-id anything goes
                if group_chars > 3:
                    return False
                group_chars += 1
                group_val *= 10
                if ord("a") <= c <= ord("f") or ord("A") <= c <= ord("F"):
                    group_val += 10 + (c | 0x20) - ord("a")
                    group_has_hex = True
                elif c in _DIGIT:
                    group_val += c - ord("0")
                else:
                    return False
        prev = c
    return True


def _validate_ipv4(b: bytes) -> bool:
    octet = chars = dots = 0
    for i, c in enumerate(b):
        if c not in _DIGIT and (i == 0 or c != ord(".")):
            return False
        if c == ord("."):
            if chars == 0:
                return False
            octet, chars = 0, 0
            dots += 1
            continue
        chars += 1
        octet = octet * 10 + (c - ord("0"))
        if octet > 255:
            return False
    return chars > 0 and dots == 3


def _validate_domain(b: bytes) -> bool:
    """alphanum/-/. labels; '-' not at edges or around '.'; final label must
    not start with a digit (reference validate_domain_name,
    parse_uri.cu:306-346)."""
    last_dash = last_dot = False
    numeric_start = False
    chars_in_label = 0
    for i, c in enumerate(b):
        if c not in _ALNUM and c not in b"-.":
            return False
        numeric_start = last_dot and c in _DIGIT
        if c == ord("-"):
            if last_dot or i == 0 or i == len(b) - 1:
                return False
            last_dash, last_dot = True, False
        elif c == ord("."):
            if last_dash or last_dot or chars_in_label == 0:
                return False
            last_dot, last_dash = True, False
            chars_in_label = 0
        else:
            last_dot = last_dash = False
            chars_in_label += 1
    return not numeric_start


_FATAL, _INVALID, _VALID = 0, 1, 2


def _validate_host(b: bytes) -> int:
    """VALID/INVALID/FATAL trichotomy (reference validate_host,
    parse_uri.cu:347-404): malformed brackets are fatal; a host that is
    neither a domain nor IPv4 is merely invalid (host->null, URI survives)."""
    if not b:
        return _INVALID
    if b[0] == ord("["):
        if b[-1] != ord("]") or not _validate_ipv6(b):
            return _FATAL
        return _VALID
    if ord("[") in b or ord("]") in b:
        return _FATAL
    last_dot = b.rfind(b".")
    looks_ipv4 = (last_dot >= 0 and last_dot != len(b) - 1
                  and b[last_dot + 1] in _DIGIT)
    if not looks_ipv4:
        if _validate_domain(b):
            return _VALID
    elif _validate_ipv4(b):
        return _VALID
    return _INVALID


class _Parts:
    __slots__ = ("fatal", "scheme", "host", "query")

    def __init__(self):
        self.fatal = False
        self.scheme: Optional[bytes] = None
        self.host: Optional[bytes] = None
        self.query: Optional[bytes] = None


def _parse_one(b: bytes) -> _Parts:
    """Single-row parse following the reference's validate_uri flow
    (parse_uri.cu:536-746), which is behavior-pinned to java.net.URI."""
    p = _Parts()
    orig_start = 0

    # fragment split first: everything after '#'
    hash_pos = b.find(b"#")
    if hash_pos >= 0:
        if not _validate_chunk(b[hash_pos + 1:], _FRAGMENT_OK):
            p.fatal = True
            return p
        b = b[:hash_pos]

    colon = b.find(b":")
    slash = b.find(b"/")
    if colon >= 0 and (slash < 0 or colon < slash):
        scheme = b[:colon]
        if not _validate_scheme(scheme):
            p.fatal = True
            return p
        p.scheme = scheme
        b = b[colon + 1:]
        orig_start = colon + 1

    if not b:
        # nothing after the scheme (or empty input) -> invalid row
        p.fatal = True
        p.scheme = None
        return p

    hierarchical = b[:1] == b"/" or orig_start == 0
    if not hierarchical:
        if not _validate_chunk(b, _OPAQUE_OK):
            p.fatal = True
            p.scheme = None
        return p

    question = b.find(b"?")
    if question >= 0:
        query = b[question + 1:]
        if not _validate_chunk(query, _QUERY_OK):
            p.fatal = True
            p.scheme = None
            return p
        p.query = query
        b = b[:question]

    path = b
    if b[:2] == b"//":
        rest = b[2:]
        next_slash = rest.find(b"/")
        authority = rest if next_slash < 0 else rest[:next_slash]
        path = b"" if next_slash < 0 else rest[next_slash:]

        if authority:
            ipv6ish = len(authority) > 2 and authority[0] == ord("[")
            if not _validate_chunk(authority, _AUTH_OK,
                                   allow_raw_percent=ipv6ish):
                p.fatal = True
                p.scheme = None
                p.query = None
                return p
            # split userinfo@host:port (reference authority scan :683-720)
            amp = authority.find(b"@")
            if amp >= 0:
                userinfo = authority[:amp]
                if b"[" in userinfo or b"]" in userinfo:
                    p.fatal = True
                    p.scheme = None
                    p.query = None
                    return p
            hostport = authority[amp + 1:] if amp >= 0 else authority
            close_br = hostport.rfind(b"]")
            last_colon = hostport.rfind(b":")
            # reference: port split only when the colon isn't the first char
            # (":host" keeps the colon in the host and later invalidates it);
            # port contents are deliberately not validated (validate_port
            # accepts anything, parse_uri.cu:441-450 — "according to
            # spark...shrug").
            if last_colon > 0 and last_colon > close_br:
                host = hostport[:last_colon]
            else:
                host = hostport
            v = _validate_host(host)
            if v == _FATAL:
                p.fatal = True
                p.scheme = None
                p.query = None
                return p
            if v == _VALID:
                p.host = host

    if not _validate_chunk(path, _PATH_OK):
        p.fatal = True
        p.scheme = None
        p.host = None
        p.query = None
    return p


def _row_bytes(col: Column) -> List[Optional[bytes]]:
    if col.dtype.id is not dt.TypeId.STRING:
        raise TypeError(f"parse_url of a {col.dtype.id.value} column")
    data = col.data.cpu().numpy().tobytes()
    offs = col.host_offsets()
    valid = col.valid_mask().cpu().numpy()
    return [data[offs[i]:offs[i + 1]] if valid[i] else None
            for i in range(col.size)]


def _emit(parts: List[Optional[bytes]], device) -> Column:
    validity = np.array([p is not None for p in parts], dtype=bool)
    return pack_byte_rows([p if p is not None else b"" for p in parts],
                          validity, device=device)


# ---------------------------------------------------------------------------
# the host tier (native/parse_uri.cpp): the same algorithms in row-parallel
# C++; the Python oracle above is what it is tested against
# ---------------------------------------------------------------------------

_PART_PROTOCOL, _PART_HOST, _PART_QUERY = 0, 1, 2


def _native_parse_buffers(nat, data, offs, valid, n, part, key_data,
                          key_offs, key_valid, key_broadcast):
    """Buffers in, buffers out: the sandbox worker (a native crash
    classifies as a CRASH fault) or the in-process ctypes call. Free of
    guards: the one ``guarded_dispatch("parse_uri", ...)`` in
    ``_native_parse`` wraps both paths, and this core has no effects, so
    a retry may re-run it."""
    from ..faultinj import _sandbox_targets, sandbox
    if sandbox.active("parse_uri"):
        return sandbox.sandbox_call(
            "parse_uri", sandbox.file_target("parse_uri_target"),
            nat.so_path(), data, offs, valid, n, part, key_data, key_offs,
            key_valid, key_broadcast)
    return _sandbox_targets.parse_uri_buffers(
        nat.load(), data, offs, valid, n, part, key_data, key_offs,
        key_valid, key_broadcast)


def _host_u8(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else np.ascontiguousarray(
        t.cpu().numpy().astype(np.uint8))


def _native_parse(col: Column, part: int, key_col: Optional[Column] = None,
                  key_literal: Optional[bytes] = None) -> Column:
    from ..faultinj.guard import guarded_dispatch
    from . import _parse_uri_native as nat

    if col.dtype.id is not dt.TypeId.STRING:
        raise TypeError(f"parse_url of a {col.dtype.id.value} column")
    data = np.ascontiguousarray(col.data.cpu().numpy())
    offs = np.ascontiguousarray(col.host_offsets(), dtype=np.int64)
    valid = _host_u8(col.validity)

    key_data = key_offs = key_valid = None
    key_broadcast = 0
    if key_literal is not None:
        key_data = np.frombuffer(key_literal, dtype=np.uint8).copy() \
            if key_literal else np.zeros(1, dtype=np.uint8)
        key_offs = np.array([0, len(key_literal)], dtype=np.int64)
        key_broadcast = 1
    elif key_col is not None:
        key_data = np.ascontiguousarray(key_col.data.cpu().numpy())
        if key_data.size == 0:
            key_data = np.zeros(1, dtype=np.uint8)
        key_offs = np.ascontiguousarray(key_col.host_offsets(),
                                        dtype=np.int64)
        key_valid = _host_u8(key_col.validity)

    n = col.size
    blob, offsets, validity = guarded_dispatch(
        "parse_uri", _native_parse_buffers, nat, data, offs, valid, n,
        part, key_data, key_offs, key_valid, key_broadcast)
    dev = col.device
    vmask = None if bool(validity.all()) else torch.from_numpy(
        validity).to(dev)
    return Column(dt.STRING, n, data=torch.from_numpy(blob).to(dev),
                  validity=vmask,
                  offsets=torch.from_numpy(offsets.astype(np.int32)).to(dev))


def _parse(col: Column, part: str) -> Column:
    """The tier dispatch: the device tier keeps the parse on the column's
    device (no copy of the strings to the host); the native tier runs
    where the bytes are host-resident. ``parse_uri.tier`` forces either
    (the tests run both)."""
    if tier_is_device("parse_uri.tier", col.device):
        from .parse_uri_device import parse_uri_device
        string_routes.inc("parse_uri_device", col.size)
        return parse_uri_device(col, part)
    string_routes.inc("parse_uri_host_by_config", col.size)
    return _native_parse(col, _PARTS[part])


_PARTS = {"PROTOCOL": _PART_PROTOCOL, "HOST": _PART_HOST,
          "QUERY": _PART_QUERY}


@func_range()
def parse_uri_to_protocol(col: Column) -> Column:
    """Spark ``parse_url(url, 'PROTOCOL')``."""
    return _parse(col, "PROTOCOL")


@func_range()
def parse_uri_to_host(col: Column) -> Column:
    """Spark ``parse_url(url, 'HOST')``."""
    return _parse(col, "HOST")


@func_range()
def parse_uri_to_query(col: Column) -> Column:
    """Spark ``parse_url(url, 'QUERY')``."""
    return _parse(col, "QUERY")


@func_range()
def parse_uri_to_query_with_literal(col: Column, key: str) -> Column:
    """Spark ``parse_url(url, 'QUERY', key)`` with a literal key: the
    host tier on either device."""
    string_routes.inc("parse_uri_host_key", col.size)
    return _native_parse(col, _PART_QUERY, key_literal=key.encode())


@func_range()
def parse_uri_to_query_with_column(col: Column, keys: Column) -> Column:
    """``parse_url(url, 'QUERY', keys)`` with a key per row: the host
    tier."""
    if keys.size != col.size:
        raise ValueError("keys column must match the url column's row count")
    string_routes.inc("parse_uri_host_key", col.size)
    return _native_parse(col, _PART_QUERY, key_col=keys)


# ---- the Python oracle's entries (differential tests) ----------------------

def py_parse_uri_to_protocol(col: Column) -> Column:
    return _emit([None if b is None else _parse_one(b).scheme
                  for b in _row_bytes(col)], col.device)


def py_parse_uri_to_host(col: Column) -> Column:
    return _emit([None if b is None else _parse_one(b).host
                  for b in _row_bytes(col)], col.device)


def py_parse_uri_to_query(col: Column) -> Column:
    return _emit([None if b is None else _parse_one(b).query
                  for b in _row_bytes(col)], col.device)


def _find_query_part(query: bytes, key: bytes) -> Optional[bytes]:
    """Value of ``key=...`` among '&'-separated params (reference
    find_query_part, parse_uri.cu:495-533)."""
    for pair in query.split(b"&"):
        eq = pair.find(b"=")
        if eq >= 0 and pair[:eq] == key:
            return pair[eq + 1:]
    return None


def py_parse_uri_to_query_with_literal(col: Column, key: str) -> Column:
    kb = key.encode()
    out = []
    for b in _row_bytes(col):
        q = None if b is None else _parse_one(b).query
        out.append(None if q is None else _find_query_part(q, kb))
    return _emit(out, col.device)


def py_parse_uri_to_query_with_column(col: Column, keys: Column) -> Column:
    kb = _row_bytes(keys)
    out = []
    for b, k in zip(_row_bytes(col), kb):
        q = None if b is None or k is None else _parse_one(b).query
        out.append(None if q is None else _find_query_part(q, k))
    return _emit(out, col.device)
