"""Device tier of ``from_json``'s raw map: the top-level pair spans of
each JSON object row, found on the column's device (the JAX package's
ops/from_json_device.py).

The scan work runs as ``[n, W]`` planes over the padded byte matrix on the
device: string masks, depth, grammar validation (get_json_device's DFA)
and every top-level ``key: value`` pair, located by its depth-1 colon.
Each pair becomes a (start, length) span of the key and of the value in
the column's characters, and the output LIST<STRUCT<key, value>> is
assembled by two flat-byte gathers, on the device: the JAX package
gathered the spans to the host and assembled there in numpy; the result
is the same column.

Routes to the host tier (native ``fjm_eval``, ops/map_utils.py), each
counted in ``backend.string_routes``:

- a row holding any backslash: unescaping is the one transform spans
  cannot express (the JAX package's route);
- a row nested past the DFA's ``_DEPTH_CAP`` (30). The DFA rejects it
  while the host PDA accepts up to 64 levels; the JAX package's device
  tier returns such a row as null where its host tier returns its pairs
  (ROADMAP C). Here the host tier judges it, so both tiers agree.

The planes are built a row chunk of ``CHUNK_ELEMENTS`` elements at a
time. Host syncs: the padded width, the DFA's step count, one read of a
chunk's largest pair count, the route counts and the output sizes.
"""

from __future__ import annotations

import torch

from ..columnar import dtype as dt
from ..columnar.column import Column
from ..columnar.strings import (first_index, gather_spans, padded_bytes,
                                row_chunks, row_of_position)
from ..utils.backend import string_routes
from ..utils.tracing import func_range
from .sort import gather
from .get_json_device import (_DEPTH_CAP, _depth, _is_ws, _rev_cummin,
                              _string_masks, document_validity)

_BIG = 1 << 30

# matrix elements of one row chunk of the planes
CHUNK_ELEMENTS = 1 << 27


def _planes(mat, lens):
    """The ``[n, W]`` planes both stages read, made once a chunk."""
    real_quote, str_token, _escaped, in_len = _string_masks(mat, lens)
    del _escaped
    d, _opens, closes = _depth(mat, str_token, in_len)
    del _opens
    nonws = ~_is_ws(mat) & in_len
    dep1 = (d == 1) & ~str_token & in_len
    colon = (mat == ord(":")) & dep1
    return real_quote, in_len, d, closes, nonws, dep1, colon


def _scan_objects(mat, in_len, d, nonws, colon):
    """Per row: (an object, pair count, has a backslash, nested past the
    cap). Validation is the caller's (``document_validity``)."""
    n, W = mat.shape
    zero = torch.zeros(n, dtype=torch.int32, device=mat.device)
    first_nb, has_nb = first_index(nonws, zero,
                                   torch.full_like(zero, W))
    first_byte = torch.gather(mat, 1, first_nb.clamp(0, W - 1)
                              .to(torch.int64)[:, None])[:, 0]
    is_obj = has_nb & (first_byte == ord("{"))
    counts = colon.sum(dim=1, dtype=torch.int32)
    has_bs = ((mat == ord("\\")) & in_len).any(dim=1)
    deep = d.amax(dim=1) > _DEPTH_CAP
    return is_obj, counts, has_bs, deep


def _pair_plan(mat, row_take, P: int, real_quote, d, closes, nonws, dep1,
               colon):
    """Spans of the first P top-level pairs of each row: ``[n, P]``
    (key_start, key_len, val_start, val_len) in row coordinates, lengths 0
    for dead pairs and rows not in ``row_take``."""
    n, W = mat.shape
    dev = mat.device
    i32, i64 = torch.int32, torch.int64
    pos2d = torch.arange(W, dtype=i32, device=dev)[None, :].expand(n, W)

    # pair p's colon position, by its rank among the row's colons
    slots = torch.where(colon, torch.clamp(
        torch.cumsum(colon, dim=1, dtype=i32) - 1, max=P), P).to(i64)
    ci_grid = torch.zeros((n, P + 1), dtype=i32, device=dev) \
        .scatter_(1, slots, pos2d)[:, :P]
    live = ci_grid > 0  # a colon never sits at byte 0 of a valid object
    ci = torch.where(live, ci_grid, 1)

    def at(plane, idx, hi):
        return torch.gather(plane, 1, idx.clamp(0, hi).to(i64))

    # key span: the close quote is the last real quote before the colon,
    # the open quote the real quote ranked just before it (string-token
    # quotes pair consecutively by the parity construction)
    last_q = torch.cummax(torch.where(real_quote, pos2d, -1), dim=1).values
    kq_close = at(last_q, ci - 1, W - 1)
    qrank = torch.cumsum(real_quote, dim=1, dtype=i32) - 1
    qslots = torch.where(real_quote, qrank.clamp(max=W - 1), W).to(i64)
    qidx_by_rank = torch.zeros((n, W + 1), dtype=i32, device=dev) \
        .scatter_(1, qslots, pos2d)
    close_rank = at(qrank, kq_close, W - 1)
    kq_open = at(qidx_by_rank, close_rank - 1, W)
    key_s = kq_open + 1
    key_len = torch.clamp(kq_close - key_s, min=0)
    del last_q, qrank, qslots, qidx_by_rank

    # value span: first non-ws after the colon .. last non-ws before the
    # next depth-1 separator (',' at depth 1, or the root '}')
    val_s = at(_rev_cummin(torch.where(nonws, pos2d, _BIG)), ci + 1, W - 1)
    sep = ((mat == ord(",")) & dep1) | (closes & (d == 0))
    sep_i = at(_rev_cummin(torch.where(sep, pos2d, _BIG)), ci + 1, W - 1)
    prev_nb = torch.cummax(torch.where(nonws, pos2d, -1), dim=1).values
    val_e = at(prev_nb, sep_i - 1, W - 1) + 1
    # a string value's span is its content (quotes stripped; the row has
    # no escape, so the content is the raw bytes)
    is_strv = at(mat, val_s, W - 1) == ord('"')
    val_s = torch.where(is_strv, val_s + 1, val_s)
    val_e = torch.where(is_strv, val_e - 1, val_e)
    val_len = torch.clamp(val_e - val_s, min=0)

    take = live & row_take[:, None]
    return (key_s, torch.where(take, key_len, 0), val_s,
            torch.where(take, val_len, 0))


def _pick(src: torch.Tensor, idx: torch.Tensor, use: torch.Tensor
          ) -> torch.Tensor:
    """``src[idx]`` where ``use``, 0 elsewhere (idx may be out of range
    there; src may be empty)."""
    if src.numel() == 0:
        return torch.zeros_like(idx)
    got = src.index_select(0, idx.clamp(0, src.numel() - 1))
    return torch.where(use, got, 0)


@func_range()
def extract_raw_map_device(col: Column) -> Column:
    """from_json's raw map with the pair spans found on the device; rows
    with a backslash or nested past the cap on the host tier."""
    from .map_utils import extract_raw_map_host

    n = col.size
    if n == 0:
        return extract_raw_map_host(col)
    if col.dtype.id is not dt.TypeId.STRING:
        raise TypeError(f"from_json of a {col.dtype.id.value} column")
    dev = col.device
    i64 = torch.int64
    string_routes.inc("from_json_device", n)
    valid_doc = document_validity(col)
    base_valid = col.valid_mask()
    mat, lens = padded_bytes(col)
    W = mat.shape[1]
    row_start = col.offsets[:-1].to(i64)
    rowok, counts, has_bs, deep = [], [], [], []
    spans = []   # (key start, key len, value start, value len) of pairs
    for r0, r1 in row_chunks(n, W, CHUNK_ELEMENTS):
        m, ln = mat[r0:r1], lens[r0:r1]
        planes = _planes(m, ln)
        real_quote, in_len, d, closes, nonws, dep1, colon = planes
        is_obj, cnt, bs, dp = _scan_objects(m, in_len, d, nonws, colon)
        ok = valid_doc[r0:r1] & is_obj & base_valid[r0:r1]
        cert = ok & ~bs
        cert_cnt = torch.where(cert, cnt, 0)
        P = int(cert_cnt.max())
        if P:
            ks, kl, vs, vl = _pair_plan(m, cert, P, real_quote, d, closes,
                                        nonws, dep1, colon)
            live = torch.arange(P, device=dev)[None, :] < cert_cnt[:, None]
            base = row_start[r0:r1, None]
            spans.append(((ks + base)[live], kl[live], (vs + base)[live],
                          vl[live]))
        rowok.append(ok)
        counts.append(cert_cnt)
        has_bs.append(bs & ok)
        deep.append(dp & base_valid[r0:r1])
        del planes, real_quote, in_len, d, closes, nonws, dep1, colon
    rowok = torch.cat(rowok)
    counts = torch.cat(counts).to(i64)
    redo = torch.cat(has_bs) | torch.cat(deep)
    route = torch.stack([torch.cat(has_bs).sum(), torch.cat(deep).sum()])
    n_bs, n_deep = route.tolist()
    string_routes.inc("from_json_host_backslash", n_bs)
    string_routes.inc("from_json_host_deep", n_deep)
    if spans:
        ks, kl, vs, vl = (torch.cat(p) for p in zip(*spans))
    else:
        ks = kl = vs = vl = torch.zeros(0, dtype=i64, device=dev)

    # the host tier judges its rows: their pairs and their validity
    keys_src, vals_src = col.data, col.data
    fb_rank = fb_offs = hk = hv = None
    if n_bs or n_deep:
        rows = torch.nonzero(redo)[:, 0]
        host = extract_raw_map_host(gather(col, rows))
        hk, hv = host.children[0].children
        fb_offs = host.offsets.to(i64)
        counts[rows] = fb_offs[1:] - fb_offs[:-1]
        rowok = rowok.clone()
        rowok[rows] = host.valid_mask()
        fb_rank = torch.cumsum(redo, dim=0, dtype=i64) - 1
        keys_src = torch.cat([col.data, hk.data])
        vals_src = torch.cat([col.data, hv.data])

    list_offs = torch.zeros(n + 1, dtype=i64, device=dev)
    torch.cumsum(counts, 0, out=list_offs[1:])
    m = int(list_offs[-1])
    if m:
        row = row_of_position(list_offs, m).to(i64)
        within = torch.arange(m, device=dev) - list_offs.index_select(0, row)
        cert_offs = torch.cumsum(torch.where(redo, 0, counts), 0) \
            - torch.where(redo, 0, counts)
        from_host = redo.index_select(0, row)
        ci = cert_offs.index_select(0, row) + within
        k_start, k_len = _pick(ks, ci, ~from_host), _pick(kl, ci, ~from_host)
        v_start, v_len = _pick(vs, ci, ~from_host), _pick(vl, ci, ~from_host)
        if fb_rank is not None:
            hi = _pick(fb_offs, fb_rank.index_select(0, row), from_host) \
                + within
            nb = int(col.data.shape[0])
            ko, vo = hk.offsets.to(i64), hv.offsets.to(i64)
            k_start = torch.where(from_host, nb + _pick(ko, hi, from_host),
                                  k_start)
            k_len = torch.where(from_host, _pick(ko, hi + 1, from_host)
                                - _pick(ko, hi, from_host), k_len)
            v_start = torch.where(from_host, nb + _pick(vo, hi, from_host),
                                  v_start)
            v_len = torch.where(from_host, _pick(vo, hi + 1, from_host)
                                - _pick(vo, hi, from_host), v_len)
    else:
        k_start = k_len = v_start = v_len = torch.zeros(0, dtype=i64,
                                                        device=dev)
    keys = gather_spans(keys_src, k_start, k_len)
    vals = gather_spans(vals_src, v_start, v_len)
    return Column.list_of(Column.struct_of([keys, vals]), list_offs,
                          validity=rowok)
