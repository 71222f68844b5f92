"""Device tier of ``parse_url``: PROTOCOL, HOST and QUERY as vectorized
byte scans (the JAX package's ops/parse_uri_device.py).

The string column densifies to its padded ``uint8[n, W]`` byte matrix
(columnar/strings.padded_bytes) and every per-row decision becomes a
torch op across rows, on the column's device:

- **Span splitting** (fragment, scheme, query, authority, path, opaque)
  is index arithmetic: the first/last match of a character in a window,
  by the running count of its matches (``strings.Marks``).
- **Chunk validation** (the per-class character rules and the ``%XX``
  escapes, reference parse_uri.cu:92-151) classifies every position of
  every chunk span at once; only the escape counter is sequential, so the
  W-step loop carries that one register and records, per position,
  whether it consumes an escape byte or starts an escape. The verdicts
  are then whole-matrix reductions. Same rules as the JAX package's
  one-pass DFA (``_chunks_ok``), whose every update is a function of the
  position's byte, its class and that counter.
- **UTF-8 structure** (strict decode and the unicode whitespace/control
  rejections) is shifted-window algebra over the matrix.
- **Host classification** (the IPv6 / IPv4 / domain trichotomy,
  parse_uri.cu:165-404) is the JAX package's fused W-step loop with
  ``[n]``-wide registers over the whole column, stepped over the columns
  where some row's host span lies (every update is gated on the position
  being in the span, so the other columns change nothing).

Both loops run through ``strings.column_scan``: on a CUDA device a step
is one replay of a CUDA graph of its ops.

The planes are built in row chunks of ``CHUNK_ELEMENTS`` matrix elements
(each row's result depends only on its own bytes), so the peak does not
grow with the column. The character classes come from this package's
oracle (ops/parse_uri.py). The extracted span becomes a STRING column by
one flat-byte gather (``strings.gather_spans``).

The JAX package's ``bucket_padded_data`` shadow (the source padded to a
bucketed byte total, so that its TPU programs compile once per bucket)
is not ported: torch compiles nothing per shape. The per-column span memo
is kept (``_uri_spans``): the parts of one URL column share one parse.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar.column import Column
from ..columnar.strings import (Marks, byte_at, column, column_scan,
                                first_index, gather_spans, last_index,
                                padded_bytes, put_column, row_chunks)
from ..utils.tracing import func_range
from . import parse_uri as _oracle

# matrix elements of one row chunk: its int32 planes stay at 1 GB
CHUNK_ELEMENTS = 1 << 28

_CLS_NONE, _CLS_FRAGMENT, _CLS_QUERY, _CLS_AUTH, _CLS_PATH, _CLS_OPAQUE, \
    _CLS_SCHEME = range(7)


def _build_tables():
    cls = np.zeros((7, 256), dtype=bool)
    for cid, allowed in ((_CLS_FRAGMENT, _oracle._FRAGMENT_OK),
                         (_CLS_QUERY, _oracle._QUERY_OK),
                         (_CLS_AUTH, _oracle._AUTH_OK),
                         (_CLS_PATH, _oracle._PATH_OK),
                         (_CLS_OPAQUE, _oracle._OPAQUE_OK)):
        cls[cid, list(allowed)] = True
    cls[_CLS_SCHEME, list(_oracle._ALNUM | set(b"+-."))] = True
    hexd = np.zeros(256, dtype=bool)
    hexd[list(_oracle._HEX)] = True
    digit = np.zeros(256, dtype=bool)
    digit[list(_oracle._DIGIT)] = True
    alpha = np.zeros(256, dtype=bool)
    alpha[list(_oracle._ALPHA)] = True
    alnum = alpha | digit
    # escapes and the non-ASCII exemption apply to every chunk class but
    # the scheme (ASCII alnum+-. only, '%' illegal)
    esc_ok = np.array([False, True, True, True, True, True, False])
    return {"cls": cls.reshape(-1), "hex": hexd, "digit": digit,
            "alpha": alpha, "alnum": alnum, "esc": esc_ok}


_TABLES = _build_tables()
_on_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}


def _tab(device) -> Dict[str, torch.Tensor]:
    """The class tables as bool tensors on ``device`` (made once)."""
    t = _on_device.get(device)
    if t is None:
        t = {k: torch.from_numpy(v).to(device) for k, v in _TABLES.items()}
        _on_device[device] = t
    return t


# ---------------------------------------------------------------------------
# UTF-8 structural validation (shifted-window algebra)
# ---------------------------------------------------------------------------

def _utf8_ok(mat: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    """Strict UTF-8 and the unicode space/control rejection over ``span``
    positions (bool ``[n, W]``): the oracle's bytes.decode +
    ``_BAD_UNICODE`` (``_validate_chunk``). ASCII bytes pass; their class
    is the chunk check's business."""
    n, W = mat.shape
    z = torch.zeros((n, 1), dtype=mat.dtype, device=mat.device)

    def sh(a, k):  # shift right along the byte axis by k (zeros in)
        return torch.cat([torch.zeros_like(a[:, :k]), a[:, :-k]], dim=1)

    m = torch.where(span, mat, 0).to(torch.uint8)
    cont = (m >= 0x80) & (m < 0xC0)
    lead2 = (m >= 0xC2) & (m < 0xE0)
    lead3 = (m >= 0xE0) & (m < 0xF0)
    lead4 = (m >= 0xF0) & (m < 0xF5)
    bad_byte = (m == 0xC0) | (m == 0xC1) | (m >= 0xF5)
    needed = (sh(lead2, 1) | sh(lead3, 1) | sh(lead3, 2)
              | sh(lead4, 1) | sh(lead4, 2) | sh(lead4, 3)) \
        if W >= 4 else torch.zeros_like(cont)
    # continuations exactly where required; a lead whose continuation
    # falls outside the span sees cont=0 there and fails here
    structure_ok = ~(needed ^ cont).any(dim=1)

    nxt = torch.cat([m[:, 1:], z], dim=1)
    nxt2 = torch.cat([m[:, 2:], z, z], dim=1)
    # overlong / surrogate / out-of-range second-byte constraints
    pair_bad = (((m == 0xE0) & (nxt < 0xA0))
                | ((m == 0xED) & (nxt >= 0xA0))
                | ((m == 0xF0) & (nxt < 0x90))
                | ((m == 0xF4) & (nxt > 0x8F)))
    # rejected code points (oracle _BAD_UNICODE): U+0080-00A0, U+1680,
    # U+2000-200A, U+2028, U+202F, U+205F, U+3000
    bad_cp = (((m == 0xC2) & (nxt >= 0x80) & (nxt <= 0xA0))
              | ((m == 0xE1) & (nxt == 0x9A) & (nxt2 == 0x80))
              | ((m == 0xE2) & (nxt == 0x80) & (nxt2 >= 0x80)
                 & (nxt2 <= 0x8A))
              | ((m == 0xE2) & (nxt == 0x80) & (nxt2 == 0xA8))
              | ((m == 0xE2) & (nxt == 0x80) & (nxt2 == 0xAF))
              | ((m == 0xE2) & (nxt == 0x81) & (nxt2 == 0x9F))
              | ((m == 0xE3) & (nxt == 0x80) & (nxt2 == 0x80)))
    clean = ~(bad_byte | pair_bad | bad_cp).any(dim=1)
    return structure_ok & clean


# ---------------------------------------------------------------------------
# chunk validation (all classes, one pass)
# ---------------------------------------------------------------------------

def _chunks_ok(mat, class_sel, end_at, raw_pct, steps: int) -> torch.Tensor:
    """Every chunk span's character rules at once (the JAX package's
    ``_chunks_ok``).

    class_sel ``[n, W]`` uint8: the chunk class of each position (0 =
    unchecked); end_at ``[n, W]`` int32: the owning span's end (a '%'
    needs two more bytes inside it); raw_pct ``[n, W]`` bool: a raw '%'
    is legal here (an IPv6 zone id). ``steps``: the columns that can hold
    a checked position (the longest row).

    The only sequential state is the escape counter (bytes of a ``%XX``
    still to consume). The loop carries it over the columns and marks
    each position as consuming an escape byte or starting an escape;
    each position's verdict is then a function of its byte, its class and
    those marks, as in the JAX step function."""
    n, W = mat.shape
    tab = _tab(mat.device)
    cs = class_sel.to(torch.int64)
    ci = mat.to(torch.int64)
    active = class_sel > 0
    esc_cls = tab["esc"][cs]
    pct = mat == ord("%")
    # where an unconsumed active position starts an escape
    may_start = active & pct & esc_cls & ~raw_pct
    act_t = active.t().contiguous()
    start_t = may_start.t().contiguous()
    consuming_t = torch.zeros((W, n), dtype=torch.bool, device=mat.device)
    starts_t = torch.zeros((W, n), dtype=torch.bool, device=mat.device)

    def step(regs, j):
        (skip,) = regs
        consuming = column(act_t, j) & (skip > 0)
        es = column(start_t, j) & ~consuming
        put_column(consuming_t, j, consuming)
        put_column(starts_t, j, es)
        return (torch.where(consuming, skip - 1, es.to(torch.int32) * 2),)

    column_scan(step, (torch.zeros(n, dtype=torch.int32,
                                   device=mat.device),), 0, steps)
    consuming = consuming_t.t()
    esc_start = starts_t.t()
    pos = torch.arange(W, dtype=torch.int32, device=mat.device)
    # consumed escape bytes are hex digits
    bad = consuming & ~tab["hex"][ci]
    # a '%' introduces two in-span bytes (oracle: i + 2 >= n fails)
    bad |= esc_start & ~(pos + 2 < end_at)
    # a plain position: a class member, or non-ASCII (UTF-8 checked
    # apart) where the class allows it, or a raw '%'
    plain = active & ~consuming & ~esc_start
    in_cls = tab["cls"][cs * 256 + ci]
    bad |= plain & ~(in_cls | ((mat >= 0x80) & esc_cls)
                     | (pct & raw_pct & esc_cls))
    return ~bad.any(dim=1)


# ---------------------------------------------------------------------------
# host classification (the oracle's per-character semantics, [n]-wide)
# ---------------------------------------------------------------------------

def _host_checks(mat, lo, hi) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The oracle's three host classifiers (_validate_ipv6, _validate_ipv4,
    _validate_domain) fused into one loop over the columns of the host
    spans, register for register with the JAX package's ``_host_checks``
    (including _validate_domain's last-character 'numeric_start').
    Returns (v6ok, v4ok, domok)."""
    n, W = mat.shape
    dev = mat.device
    tab = _tab(dev)
    i32 = torch.int32
    zi = torch.zeros(n, dtype=i32, device=dev)
    zb = torch.zeros(n, dtype=torch.bool, device=dev)
    regs = ((hi - lo) >= 2, zb, zi, zi, zi, zi, zi, zi, zi, zb, zi,
            ~zb, zi, zi, zi, ~zb, zb, zb, zb, zi)
    live = hi > lo
    j0 = j1 = 0
    if bool(live.any()):
        j0 = int(torch.where(live, lo, W).min())
        j1 = int(torch.where(live, hi, 0).max())
    mat_t = mat[:, j0:j1].t().contiguous()
    out = column_scan(lambda r, j: _host_step(
        r, column(mat_t, j - j0), j, lo, hi, tab), regs, j0, j1)
    v6ok = out[0]
    v4ok = out[11] & (out[13] > 0) & (out[14] == 3)
    domok = out[15] & ~out[18]
    return v6ok, v4ok, domok


def _host_step(regs, cb, j, lo, hi, tab):
    """One column of the host classifiers (the JAX package's step)."""
    (ok6, dc, colons, periods, pcts, obr, cbr, gval, gchars, ghex, prev,
     ok4, octet, chars4, dots4, okd, ldash, ldot, nstart, charsd) = regs
    c = cb.to(torch.int32)
    cl = cb.long()
    act = (lo <= j) & (hi > j)
    is_dig = tab["digit"][cl]
    is_dot = c == ord(".")

    # ---- ipv6 ----
    is_ob = c == ord("[")
    is_cb = c == ord("]")
    is_co = c == ord(":")
    is_pct = c == ord("%")
    other = ~(is_ob | is_cb | is_co | is_dot | is_pct)
    prev_co = prev == ord(":")
    ok6 = ok6 & (~(act & is_ob) | (obr + 1 <= 1))
    ok6 = ok6 & (~(act & is_cb) | ((cbr + 1 <= 1)
                                   & ~((periods > 0)
                                       & (ghex | (gval > 255)))))
    nco = colons + 1
    co_bad = (prev_co & dc) | (nco > 8) \
        | ((nco == 8) & ~(dc | prev_co)) | (periods > 0) | (pcts > 0)
    ok6 = ok6 & (~(act & is_co) | ~co_bad)
    dot_bad = (pcts > 0) | (periods + 1 > 3) | ghex | (gval > 255) \
        | ((colons != 6) & ~dc) | (colons >= 8)
    ok6 = ok6 & (~(act & is_dot) | ~dot_bad)
    pct_bad = (pcts + 1 > 1) | ((periods > 0) & (ghex | (gval > 255)))
    ok6 = ok6 & (~(act & is_pct) | ~pct_bad)
    is_hexl = ((c >= ord("a")) & (c <= ord("f"))) \
        | ((c >= ord("A")) & (c <= ord("F")))
    grp = act & other & (pcts == 0)  # inside a zone id anything goes
    ok6 = ok6 & (~grp | ((gchars <= 3) & (is_hexl | is_dig)))
    add = torch.where(is_hexl, 10 + (c | 0x20) - ord("a"), c - ord("0"))
    gval_n = torch.clamp(gval * 10 + add, max=1 << 20)  # only >255 matters
    reset = act & (is_co | is_dot | is_pct)
    gval = torch.where(grp, gval_n, torch.where(reset, 0, gval))
    gchars = torch.where(grp, gchars + 1, torch.where(reset, 0, gchars))
    ghex = torch.where(grp, ghex | is_hexl, ghex & ~reset)
    dc = dc | (act & is_co & prev_co)
    colons = colons + (act & is_co)
    periods = periods + (act & is_dot)
    pcts = pcts + (act & is_pct)
    obr = obr + (act & is_ob)
    cbr = cbr + (act & is_cb)
    prev = torch.where(act, c, prev)

    # ---- ipv4 ----
    v4_dot = is_dot & (lo < j)  # a leading '.' is a bad character
    ok4 = ok4 & (~act | is_dig | v4_dot)
    ok4 = ok4 & (~(act & v4_dot) | (chars4 > 0))
    octet_n = torch.clamp(octet * 10 + (c - ord("0")), max=1 << 20)
    ok4 = ok4 & (~(act & is_dig) | (octet_n <= 255))
    octet = torch.where(act & is_dig, octet_n,
                        torch.where(act & v4_dot, 0, octet))
    chars4 = torch.where(act & is_dig, chars4 + 1,
                         torch.where(act & v4_dot, 0, chars4))
    dots4 = dots4 + (act & v4_dot)

    # ---- domain ----
    is_dash = c == ord("-")
    okd = okd & (~act | tab["alnum"][cl] | is_dash | is_dot)
    nstart = torch.where(act, ldot & is_dig, nstart)
    dash_bad = ldot | (lo == j) | (hi - 1 == j)
    okd = okd & (~(act & is_dash) | ~dash_bad)
    ddot_bad = ldash | ldot | (charsd == 0)
    okd = okd & (~(act & is_dot) | ~ddot_bad)
    plain = act & ~is_dash & ~is_dot
    ldash = torch.where(act, is_dash, ldash)
    ldot = torch.where(act, is_dot, ldot)
    charsd = torch.where(plain, charsd + 1, torch.where(act, 0, charsd))
    return (ok6, dc, colons, periods, pcts, obr, cbr, gval, gchars, ghex,
            prev, ok4, octet, chars4, dots4, okd, ldash, ldot, nstart,
            charsd)


# ---------------------------------------------------------------------------
# the core: spans and verdicts for every row of a chunk
# ---------------------------------------------------------------------------

def _parse_core(mat: torch.Tensor, lens: torch.Tensor, steps: int):
    """Per-row spans and partial verdicts of one row chunk (a dict of
    ``[n]`` tensors); ``_finish`` completes them with the host
    classifiers."""
    n, W = mat.shape
    dev = mat.device
    tab = _tab(dev)
    pos = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    lens = lens.to(torch.int32)
    zero = torch.zeros(n, dtype=torch.int32, device=dev)

    def eq(ch):
        return mat == ord(ch)

    # -- fragment split -----------------------------------------------------
    hash_pos, has_hash = first_index(eq("#"), zero, lens)
    end0 = torch.where(has_hash, hash_pos, lens)         # b = b[:hash]
    frag_s, frag_e = hash_pos + 1, lens

    # -- scheme split -------------------------------------------------------
    colons, slashes = Marks(eq(":")), Marks(eq("/"))
    colon, has_colon = colons.first(zero, end0)
    slash, has_slash = slashes.first(zero, end0)
    has_scheme = has_colon & (~has_slash | (colon < slash))
    scheme_s = zero
    scheme_e = torch.where(has_scheme, colon, zero)
    b_start = torch.where(has_scheme, colon + 1, zero)
    scheme_ok = ~has_scheme | (
        (scheme_e > 0) & tab["alpha"][byte_at(mat, scheme_s).long()])
    # (the scheme's other characters go through the chunk check's table)

    empty_b = b_start >= end0
    first_b = byte_at(mat, b_start)
    hierarchical = (first_b == ord("/")) | ~has_scheme

    # -- query split (hierarchical only) ------------------------------------
    question, has_q = first_index(eq("?"), b_start, end0)
    has_query = hierarchical & has_q
    query_s, query_e = question + 1, end0
    b2_end = torch.where(has_query, question, end0)

    # -- authority / path ---------------------------------------------------
    second_b = byte_at(mat, b_start + 1)
    has_marker = hierarchical & (b2_end - b_start >= 2) \
        & (first_b == ord("/")) & (second_b == ord("/"))
    rest_start = b_start + 2
    next_slash, has_ns = slashes.first(rest_start, b2_end)
    auth_s = rest_start
    auth_e = torch.where(has_ns, next_slash, b2_end)
    has_auth = has_marker & (auth_e > auth_s)
    path_s = torch.where(has_marker,
                         torch.where(has_ns, next_slash, b2_end), b_start)
    path_e = b2_end

    # -- userinfo / host:port ----------------------------------------------
    brackets = Marks(eq("[") | eq("]"))
    amp, has_amp = first_index(eq("@"), auth_s, auth_e)
    ui_end = torch.where(has_amp, amp, auth_s)
    ui_bracket, _ = brackets.first(auth_s, ui_end)
    userinfo_bad = has_auth & has_amp & (ui_bracket < ui_end)
    hp_s = torch.where(has_amp, amp + 1, auth_s)
    close_br, _ = last_index(eq("]"), hp_s, auth_e)
    last_colon, has_lc = colons.last(hp_s, auth_e)
    # a port splits off only where the colon is past the first character
    # and beyond any ']' (its contents are not validated: oracle)
    split = has_lc & (last_colon > hp_s) & (last_colon > close_br)
    host_s = hp_s
    host_e = torch.where(split, last_colon, auth_e)

    # -- chunk validation (disjoint spans, one pass) ------------------------
    def span_mask(s, e, cond):
        return (pos >= s[:, None]) & (pos < e[:, None]) \
            & cond[:, None] & (pos < lens[:, None])

    opaque_row = ~hierarchical & ~empty_b
    sel = torch.zeros((n, W), dtype=torch.uint8, device=dev)
    end_at = torch.zeros((n, W), dtype=torch.int32, device=dev)
    for s, e, cond, cid in (
            (frag_s, frag_e, has_hash, _CLS_FRAGMENT),
            (scheme_s, scheme_e, has_scheme, _CLS_SCHEME),
            (query_s, query_e, has_query, _CLS_QUERY),
            (auth_s, auth_e, has_auth, _CLS_AUTH),
            (path_s, path_e, hierarchical & ~empty_b, _CLS_PATH),
            (b_start, end0, opaque_row, _CLS_OPAQUE)):
        msk = span_mask(s, e, cond)
        sel.masked_fill_(msk, cid)
        end_at = torch.where(msk, e[:, None], end_at)
    ipv6ish = has_auth & (auth_e - auth_s > 2) \
        & (byte_at(mat, auth_s) == ord("["))
    raw_pct = span_mask(auth_s, auth_e, ipv6ish)

    dfa_ok = _chunks_ok(mat, sel, end_at, raw_pct, steps)
    del end_at, raw_pct
    utf8ok = _utf8_ok(mat, sel > 0)
    del sel

    # -- host trichotomy: everything but the classifiers, which run over
    # the whole column (``_finish``) -------------------------------------
    host_len = host_e - host_s
    _, has_brk = brackets.first(host_s, host_e)
    ldot, has_ldot = last_index(eq("."), host_s, host_e)
    looks_ipv4 = has_ldot & (ldot != host_e - 1) \
        & tab["digit"][byte_at(mat, ldot + 1).long()]
    pre_ok = dfa_ok & utf8ok & scheme_ok & ~empty_b & ~userinfo_bad
    return {"scheme_s": scheme_s, "scheme_e": scheme_e,
            "has_scheme": has_scheme, "host_s": host_s, "host_e": host_e,
            "query_s": query_s, "query_e": query_e, "has_query": has_query,
            "hierarchical": hierarchical, "has_auth": has_auth,
            "pre_ok": pre_ok, "host_len": host_len,
            "bracketed": (host_len > 0) & (byte_at(mat, host_s)
                                           == ord("[")),
            "hlast": byte_at(mat, host_e - 1), "has_brk": has_brk,
            "looks_ipv4": looks_ipv4}


def _finish(p, v6ok, v4ok, domok):
    """The verdicts: (ok, scheme_s, scheme_e, has_scheme, host_s, host_e,
    has_host, query_s, query_e, has_query); ``ok`` False = a fatal row
    (all parts null)."""
    bracketed, hlast = p["bracketed"], p["hlast"]
    host_fatal = torch.where(bracketed, (hlast != ord("]")) | ~v6ok,
                             (p["host_len"] > 0) & p["has_brk"])
    host_valid = torch.where(
        bracketed, v6ok & (hlast == ord("]")),
        (p["host_len"] > 0) & ~p["has_brk"]
        & torch.where(p["looks_ipv4"], v4ok, domok & ~p["looks_ipv4"]))
    has_auth = p["has_auth"]
    ok = p["pre_ok"] & ~(has_auth & host_fatal)
    return (ok, p["scheme_s"], p["scheme_e"], ok & p["has_scheme"],
            p["host_s"], p["host_e"],
            ok & has_auth & host_valid & p["hierarchical"],
            p["query_s"], p["query_e"], ok & p["has_query"])


def _uri_spans(col: Column):
    """The core over the whole column, a row chunk at a time, memoized on
    the column (a column is never changed in place)."""
    spans = getattr(col, "_uri_spans", None)
    if spans is not None:
        return spans
    mat, lens = padded_bytes(col)
    n, W = mat.shape
    steps = int(lens.max()) if n else 0
    parts = [_parse_core(mat[r0:r1], lens[r0:r1], steps)
             for r0, r1 in row_chunks(n, W, CHUNK_ELEMENTS)]
    p = {k: torch.cat([q[k] for q in parts]) for k in parts[0]}
    spans = _finish(p, *_host_checks(mat, p["host_s"], p["host_e"]))
    col._uri_spans = spans
    return spans


# ---------------------------------------------------------------------------
# the entry: span -> STRING column
# ---------------------------------------------------------------------------

_PARTS = {"PROTOCOL": (1, 2, 3), "HOST": (4, 5, 6), "QUERY": (7, 8, 9)}


@func_range()
def parse_uri_device(col: Column, part: str) -> Column:
    """``parse_url(url, part)`` for part PROTOCOL, HOST or QUERY on the
    column's device, bit for bit the host tier's (ops/parse_uri.py's
    oracle and native/parse_uri.cpp). Host syncs: the padded width, the
    loop bounds and the output size; the strings stay on the device."""
    if part not in _PARTS:
        raise ValueError(f"unsupported part {part!r}")
    if col.dtype.id is not dt.TypeId.STRING:
        raise TypeError(f"parse_url of a {col.dtype.id.value} column")
    dev = col.device
    if col.size == 0:
        return Column(dt.STRING, 0,
                      data=torch.zeros(0, dtype=torch.uint8, device=dev),
                      validity=torch.zeros(0, dtype=torch.bool, device=dev),
                      offsets=torch.zeros(1, dtype=torch.int32, device=dev))
    spans = _uri_spans(col)
    s, e, present = (spans[i] for i in _PARTS[part])
    if col.validity is not None:
        present = present & col.validity
    starts = col.offsets[:-1].to(torch.int64) + s
    return gather_spans(col.data, starts, e - s, present)
