"""Device tier of ``get_json_object``: scan, validate and navigate on the
column's device, normalize on the host (the JAX package's
ops/get_json_device.py).

Spark's evaluator normalizes its output (numbers re-formatted, escapes
decoded, whitespace dropped), so a span is not always the answer. The
work splits where the transfer splits:

- **Device** (torch ops over the padded ``uint8[n, W]`` byte matrix):
  string masks from backslash-run and quote-prefix parities, container
  depth from masked prefix sums, whole-document grammar validation as one
  W-step DFA (object/array context per depth in an int64 bitfield, the
  PDA's stack; depth capped at ``_DEPTH_CAP``), then per path step span
  narrowing with masked first-index scans.
- **Host**: Spark's normalization by the host PDA (native
  get_json_object.cpp) with the root path over the narrowed spans. A span
  with no whitespace, no escape and only plain integers is already
  normalized (``_span_is_canonical``) and is the result as it stands.

Routes, as in the JAX package: a path with a wildcard (or any step but
KEY/INDEX) runs on the host PDA whole; a row the device cannot certify (an
invalid document by the DFA, one nested past the cap, an escape inside a
candidate key) re-runs on the host PDA alone. Each route is counted in
``backend.string_routes``; a device step that fails raises.

The DFA runs over the whole column (its registers are ``[n]``-wide). Its
step is the JAX package's ``lax.fori_loop`` body ported as it is
(``_dfa_step``); the loop itself steps through that function's
transition table (``_dfa_table``, built once on the CPU from every
control state the grammar reaches, every byte and every depth context),
about twenty ops a byte column instead of some two hundred, and on a
CUDA device each column is one replay of a CUDA graph
(``strings.column_scan``). The ``[n, W]`` planes of navigation are built
a row chunk of ``CHUNK_ELEMENTS`` elements at a time; a plane asked many
windows (the non-whitespace, the quotes) is scanned once into running
counts (``strings.Marks``). Depths and parities are int16 (int32 past W
= 2^15), never the int64 that torch's cumsum defaults to. The JAX
package's bucket-padded shadow of the source is not ported (TPU compile
caching only).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.strings import (Marks, byte_at, column, column_scan,
                                first_index, gather_spans, padded_bytes,
                                row_chunks)
from ..utils.backend import string_routes
from ..utils.tracing import func_range
from .sort import gather

_DEPTH_CAP = 30  # per-depth object/array context in a bitfield

# matrix elements of one row chunk of the navigation planes
CHUNK_ELEMENTS = 1 << 27

# grammar DFA states
_S_VALUE = 0        # expecting a value (root or after ':' / '[' / ',')
_S_OBJ_KEY = 1      # inside object: expecting key string or '}'
_S_OBJ_COLON = 2    # after key: expecting ':'
_S_OBJ_NEXT = 3     # after value in object: expecting ',' or '}'
_S_ARR_NEXT = 4     # after value in array: expecting ',' or ']'
_S_STR = 5          # inside a string token
_S_DONE = 6         # root value complete: only whitespace allowed
_S_FAIL = 7
# number sub-states
_S_NUM_SIGN = 8     # after '-': expecting first digit
_S_NUM_INT = 9      # in integer part
_S_NUM_Z = 10       # after leading '0': only '.', 'e', or end
_S_NUM_FRAC0 = 11   # after '.': expecting digit
_S_NUM_FRAC = 12    # in fraction digits
_S_NUM_EXP0 = 13    # after 'e'/'E': expecting sign or digit
_S_NUM_EXP1 = 14    # after exponent sign: expecting digit
_S_NUM_EXP = 15     # in exponent digits
# literals: true/false/null advance byte by byte (position in a register)
_S_LIT = 16


def _byte_tables():
    ws = np.zeros(256, dtype=bool)
    ws[[0x20, 0x09, 0x0A, 0x0D]] = True
    digit = np.zeros(256, dtype=bool)
    digit[ord("0"):ord("9") + 1] = True
    hexd = digit.copy()
    hexd[ord("a"):ord("f") + 1] = True
    hexd[ord("A"):ord("F") + 1] = True
    esc = np.zeros(256, dtype=bool)
    esc[list(b'"\\/bfnrtu')] = True
    lits = np.stack([np.frombuffer(w, np.uint8).astype(np.int32)
                     for w in (b"true\0\0", b"false\0", b"null\0\0")])
    return {"ws": ws, "digit": digit, "hex": hexd, "esc": esc,
            "lits": lits.reshape(-1)}


_TABLES = _byte_tables()
_on_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}


def _tab(device) -> Dict[str, torch.Tensor]:
    t = _on_device.get(device)
    if t is None:
        t = {k: torch.from_numpy(v).to(device) for k, v in _TABLES.items()}
        t["dfa"] = tuple(torch.from_numpy(a).to(device)
                         for a in _dfa_table())
        _on_device[device] = t
    return t


def _plane_type(W: int) -> torch.dtype:
    """The integer type of positions, depths and prefix counts of a row
    of W bytes."""
    return torch.int16 if W < 1 << 15 else torch.int32


def _is_ws(mat: torch.Tensor) -> torch.Tensor:
    return (mat == 0x20) | (mat == 0x09) | (mat == 0x0A) | (mat == 0x0D)


def _and_shifted(out: torch.Tensor, a: torch.Tensor, k: int,
                 byte=None) -> None:
    """``out[:, j] &= a[:, j + k]`` (``== byte`` where one is given), False
    where j + k is past the end; in place, no shifted copy."""
    W = out.shape[1]
    if k >= W:
        out.zero_()
        return
    out[:, W - k:] = False
    src = a[:, k:] if byte is None else a[:, k:] == byte
    out[:, :W - k] &= src


def _rev_cummin(a: torch.Tensor) -> torch.Tensor:
    """Running minimum from the right along the byte axis."""
    return torch.flip(torch.cummin(torch.flip(a, [1]), dim=1).values, [1])


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def _string_masks(mat, lens):
    """(real_quote, str_token, escaped, in_len) planes.

    A '"' is real iff an even run of backslashes precedes it; str_token
    covers every byte of each string literal including both quotes."""
    n, W = mat.shape
    it = _plane_type(W)
    pos = torch.arange(W, dtype=it, device=mat.device)[None, :]
    in_len = pos < lens[:, None]
    bs = (mat == ord("\\")) & in_len
    # the run of backslashes ending just before i is i-1 - last_nb[i-1]
    # (last_nb: the last position that is no backslash); a row without a
    # backslash escapes nothing, so only rows with one are scanned
    escaped = torch.zeros_like(bs)
    rows = torch.nonzero(bs.any(dim=1))[:, 0]
    if rows.numel():
        sub = bs.index_select(0, rows)
        last_nb = torch.cummax(torch.where(~sub, pos, -1), dim=1).values
        prev_last = torch.cat([torch.full((rows.numel(), 1), -1, dtype=it,
                                          device=mat.device),
                               last_nb[:, :-1]], dim=1)
        escaped[rows] = (((pos - 1) - prev_last) & 1) == 1
        del sub, last_nb, prev_last
    real_quote = (mat == ord('"')) & ~escaped & in_len
    parity = torch.cumsum(real_quote, dim=1, dtype=it) & 1
    str_token = (parity == 1) | real_quote
    return real_quote, str_token, escaped, in_len


def _depth(mat, str_token, in_len):
    """(depth after each byte, opens, closes): containers opened minus
    closed up to and including each position, outside strings."""
    outside = ~str_token & in_len
    opens = ((mat == ord("{")) | (mat == ord("["))) & outside
    closes = ((mat == ord("}")) | (mat == ord("]"))) & outside
    step = opens.to(torch.int8) - closes.to(torch.int8)
    d = torch.cumsum(step, dim=1, dtype=_plane_type(mat.shape[1]))
    return d, opens, closes


# ---------------------------------------------------------------------------
# the grammar DFA (whole-document validation)
# ---------------------------------------------------------------------------

def _validate(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """bool[n]: a structurally valid JSON document by the host PDA's
    grammar (objects, arrays, strings, numbers, literals, no trailing
    content, depth <= cap): the JAX package's ``_validate``, one step a
    byte column (``strings.column_scan``) through the transition table of
    its step (``_dfa_table``)."""
    n, W = mat.shape
    dev = mat.device
    lens = lens.to(torch.int32)
    steps = int(lens.max()) if n else 0
    table, st_of, sel_of, pos_of = _tab(dev)["dfa"]
    # a row's byte, or _END past its end: the table keeps every register
    # there (the step's ``act``)
    code_t = torch.where(
        torch.arange(steps, device=dev)[:, None] < lens[None, :],
        mat[:, :steps].t().to(torch.int32), _END).contiguous()
    one = torch.ones(n, dtype=torch.int64, device=dev)
    regs = (torch.zeros(n, dtype=torch.int32, device=dev),   # control
            torch.zeros(n, dtype=torch.int32, device=dev),   # depth
            torch.zeros(n, dtype=torch.int64, device=dev))   # objbits

    def step(r, j):
        ctrl, depth, objbits = r
        idx = (ctrl * (_END + 1) + column(code_t, j)) * _N_CTX \
            + _context(depth, objbits)
        out = table[idx.long()]
        bit_up = one << (depth + 1).clamp(0, 31).to(torch.int64)
        act = out >> 18
        objbits = torch.where(act == 1, objbits | bit_up,
                              torch.where(act == 2, objbits & ~bit_up,
                                          objbits))
        return out & 0xFFFF, depth + ((out >> 16) & 3) - 1, objbits

    ctrl, depth, _ = column_scan(step, regs, 0, steps)
    ctrl = ctrl.long()
    st, lit_sel, lit_pos = st_of[ctrl], sel_of[ctrl], pos_of[ctrl]
    # valid end states: DONE, or a top-level number or literal that runs
    # to the exact end of the document
    num_end_ok = ((st == _S_NUM_INT) | (st == _S_NUM_Z)
                  | (st == _S_NUM_FRAC) | (st == _S_NUM_EXP)) & (depth == 0)
    lit_end_ok = (st == _S_LIT) & (lit_pos == torch.where(lit_sel == 1, 5, 4)) \
        & (depth == 0)
    return (st == _S_DONE) | num_end_ok | lit_end_ok


# The DFA's step reads depth and the object/array bitfield only through
# these contexts: depth 0; depth 1 with bit 1; depth 2-29 with the bits at
# depth - 1 and depth; depth 30 (the cap) with the same two bits. A row
# past 30 is in _S_FAIL, which no context leaves.
_N_CTX = 11
_CTX_SAMPLES = ([(0, 0)] + [(1, b << 1) for b in (0, 1)]
                + [(2, (a << 1) | (b << 2)) for a in (0, 1) for b in (0, 1)]
                + [(30, (a << 29) | (b << 30)) for a in (0, 1)
                   for b in (0, 1)])
_END = 256  # the byte code of a position past the row's end


def _context(depth, objbits):
    """The context index of each row (``_CTX_SAMPLES``' order)."""
    bit = (objbits >> depth.clamp(0, 62).to(torch.int64)) & 1
    below = (objbits >> (depth - 1).clamp(0, 62).to(torch.int64)) & 1
    pair = (2 * below + bit).to(torch.int32)
    return torch.where(depth == 0, 0, torch.where(
        depth == 1, 1 + bit.to(torch.int32),
        torch.where(depth == 30, 7 + pair, 3 + pair)))


_DFA = None


def _dfa_table():
    """The transition table of ``_dfa_step`` (the JAX package's step,
    unchanged) over the control states the grammar reaches from the
    start: for each (state, byte or _END, context), the next state, the
    depth's change and the bitfield's action (keep, set or clear the bit
    above the depth), packed as ``state | (delta + 1) << 16 | action <<
    18``. Built once, on the CPU, by running the step on every
    combination; a control state is (st, esc, lit_sel, lit_pos, ucnt).
    Returns numpy (table, st, lit_sel, lit_pos of each state)."""
    global _DFA
    if _DFA is not None:
        return _DFA
    tab = {k: torch.from_numpy(v) for k, v in _TABLES.items()}
    states = [(_S_VALUE, 0, 0, 0, 0)]
    index = {states[0]: 0}
    rows = {}
    frontier = [0]
    codes = torch.arange(_END + 1)
    while frontier:
        k = len(frontier) * (_END + 1) * _N_CTX
        ctl = torch.tensor([states[i] for i in frontier], dtype=torch.int64)
        ctl = ctl.repeat_interleave((_END + 1) * _N_CTX, dim=0)
        code = codes.repeat_interleave(_N_CTX).repeat(len(frontier))
        ctx = torch.tensor(_CTX_SAMPLES, dtype=torch.int64).repeat(
            len(frontier) * (_END + 1), 1)
        depth = ctx[:, 0].to(torch.int32)
        bit_up = 1 << (depth + 1).clamp(0, 31).to(torch.int64)
        # the step over the bitfield with the bit above the depth clear and
        # set: it sets that bit, clears it or keeps it, and reads no other
        # bit but those of the context
        outs = []
        for objbits in (ctx[:, 1], ctx[:, 1] | bit_up):
            regs = (ctl[:, 0].to(torch.int32), depth, objbits,
                    ctl[:, 1].to(torch.bool), ctl[:, 2].to(torch.int32),
                    ctl[:, 3].to(torch.int32), ctl[:, 4].to(torch.int32))
            outs.append(_dfa_step(regs, code.clamp(max=255).to(torch.uint8),
                                  code < _END, tab,
                                  torch.ones(k, dtype=torch.int64)))
        (nst, ndepth, clear_in, nesc, nsel, npos, nucnt), set_in = outs
        if not all(torch.equal(a, b) for i, (a, b) in enumerate(
                zip(outs[0], outs[1])) if i != 2):
            raise AssertionError("the DFA step reads the bit above depth")
        objbits = ctx[:, 1]
        sets = clear_in == (objbits | bit_up)
        clears = set_in[2] == objbits
        if not bool((sets | (clear_in == objbits)).all() and (
                clears | (set_in[2] == (objbits | bit_up))).all()):
            raise AssertionError("the DFA step changed other bits")
        action = torch.where(sets, 1, torch.where(clears, 2, 0))
        delta = ndepth - depth
        nxt = torch.stack([nst.long(), nesc.long(), nsel.long(), npos.long(),
                           nucnt.long()], dim=1).tolist()
        frontier = []
        out = []
        for t in map(tuple, nxt):
            i = index.get(t)
            if i is None:
                i = index[t] = len(states)
                states.append(t)
                frontier.append(i)
            out.append(i)
        packed = (torch.tensor(out, dtype=torch.int64) | (delta + 1) << 16
                  | action << 18)
        first = ctl[::(_END + 1) * _N_CTX].tolist()
        for j, st in enumerate(first):
            rows[index[tuple(st)]] = packed[j * (_END + 1) * _N_CTX:
                                            (j + 1) * (_END + 1) * _N_CTX]
    table = torch.stack([rows[i] for i in range(len(states))]).reshape(-1)
    meta = np.array(states, dtype=np.int32)
    _DFA = (table.to(torch.int32).numpy(), meta[:, 0], meta[:, 2],
            meta[:, 3])
    return _DFA


def _after_value(depth, objbits):
    """The state once a value closes at this depth (a negative depth
    reads bit 0: its result is never used)."""
    bit = (objbits >> depth.clamp(min=0).to(torch.int64)) & 1
    return torch.where(depth == 0, _S_DONE,
                       torch.where(bit == 1, _S_OBJ_NEXT, _S_ARR_NEXT))


def _is_any(c, chars):
    out = c == ord(chars[0])
    for ch in chars[1:]:
        out = out | (c == ord(ch))
    return out


def _dfa_step(regs, cb, act, tab, one):
    """One byte column of the grammar DFA: registers (st, depth, objbits,
    esc, lit_sel, lit_pos, ucnt), the column's bytes ``cb`` and whether
    each row still has a byte there (``act``)."""
    st, depth, objbits, esc, lit_sel, lit_pos, ucnt = regs
    cl = cb.long()
    c = cb.to(torch.int32)
    is_ws = tab["ws"][cl]
    is_dig = tab["digit"][cl]

    # ---------- string bytes ----------
    in_str = st == _S_STR
    in_u = in_str & (ucnt > 0)
    # \uXXXX countdown: the next 4 bytes are hex digits
    bad_hex = in_u & ~tab["hex"][cl]
    new_ucnt = torch.where(in_u, ucnt - 1, ucnt)
    plain_str = in_str & ~in_u
    # a backslash arms; the armed character is a legal escape
    new_esc = plain_str & ~esc & (c == ord("\\"))
    bad_esc = plain_str & esc & ~tab["esc"][cl]
    new_ucnt = torch.where(plain_str & esc & (c == ord("u")), 4, new_ucnt)
    end_str = plain_str & ~esc & (c == ord('"'))
    # a KEY string (lit_sel == 3) closes into the colon state, a value
    # string into the state after a value
    av = _after_value(depth, objbits)
    av_up = _after_value(depth - 1, objbits)
    st_after_str = torch.where(lit_sel == 3, _S_OBJ_COLON, av)
    # raw control characters are illegal inside strings
    bad_ctl = (in_str & (c < 0x20)) | bad_esc | bad_hex

    # ---------- number termination ----------
    num_ok_end = (st == _S_NUM_INT) | (st == _S_NUM_Z) \
        | (st == _S_NUM_FRAC) | (st == _S_NUM_EXP)
    in_num = (st >= _S_NUM_SIGN) & (st <= _S_NUM_EXP)
    delim = is_ws | _is_any(c, ",}]")
    is_e = _is_any(c, "eE")
    int_or_z = (st == _S_NUM_INT) | (st == _S_NUM_Z)
    nxt_num = torch.full_like(st, _S_FAIL)
    nxt_num = torch.where(
        ((st == _S_NUM_EXP0) | (st == _S_NUM_EXP1) | (st == _S_NUM_EXP))
        & is_dig, _S_NUM_EXP, nxt_num)
    nxt_num = torch.where((st == _S_NUM_EXP0) & _is_any(c, "+-"),
                          _S_NUM_EXP1, nxt_num)
    nxt_num = torch.where(
        ((st == _S_NUM_FRAC0) | (st == _S_NUM_FRAC)) & is_dig,
        _S_NUM_FRAC, nxt_num)
    nxt_num = torch.where((int_or_z | (st == _S_NUM_FRAC)) & is_e,
                          _S_NUM_EXP0, nxt_num)
    nxt_num = torch.where(int_or_z & (c == ord(".")), _S_NUM_FRAC0,
                          nxt_num)
    nxt_num = torch.where((st == _S_NUM_INT) & is_dig, _S_NUM_INT, nxt_num)
    nxt_num = torch.where(
        (st == _S_NUM_SIGN) & is_dig,
        torch.where(c == ord("0"), _S_NUM_Z, _S_NUM_INT), nxt_num)

    # ---------- literal continuation ----------
    in_lit = st == _S_LIT
    lit_char = tab["lits"][(lit_sel.clamp(0, 2) * 6
                            + lit_pos.clamp(0, 5)).long()]
    lit_len = torch.where(lit_sel == 1, 5, 4)

    # ---------- value start (from _S_VALUE) ----------
    vs_oobj = c == ord("{")
    vs_oarr = c == ord("[")
    vs_st = torch.where(
        vs_oobj, _S_OBJ_KEY,
        torch.where(vs_oarr, _S_VALUE,
                    torch.where(c == ord('"'), _S_STR,
                                torch.where(c == ord("-"), _S_NUM_SIGN,
                                            _S_FAIL))))
    vs_st = torch.where(is_dig, torch.where(c == ord("0"), _S_NUM_Z,
                                            _S_NUM_INT), vs_st)
    vs_st = torch.where(_is_any(c, "tfn"), _S_LIT, vs_st)

    # ']' right after '[' (lit_pos == -7 marks a just-opened array)
    cur_bit = (objbits >> depth.clamp(min=0).to(torch.int64)) & 1
    arr_close_ok = (st == _S_VALUE) & (c == ord("]")) \
        & (lit_pos == -7) & (depth > 0) & (cur_bit == 0)

    new_st = st
    new_depth = depth
    new_objbits = objbits
    new_lit_sel = lit_sel
    new_lit_pos = lit_pos

    # --- _S_VALUE ---
    take = act & (st == _S_VALUE) & ~is_ws & ~arr_close_ok
    new_st = torch.where(take, vs_st, new_st)
    new_depth = torch.where(take & (vs_oobj | vs_oarr), depth + 1,
                            new_depth)
    bit_up = one << (depth + 1).clamp(0, 31).to(torch.int64)
    new_objbits = torch.where(
        take & vs_oobj, objbits | bit_up,
        torch.where(take & vs_oarr, objbits & ~bit_up, new_objbits))
    # entering a literal: which one, at position 1
    enter_lit = take & (vs_st == _S_LIT)
    new_lit_sel = torch.where(
        enter_lit, torch.where(c == ord("t"), 0,
                               torch.where(c == ord("f"), 1, 2)),
        new_lit_sel)
    new_lit_pos = torch.where(enter_lit, 1, new_lit_pos)
    # value strings are values, not keys
    new_lit_sel = torch.where(take & (vs_st == _S_STR), 0, new_lit_sel)
    # empty-array close
    aco = act & arr_close_ok
    new_st = torch.where(aco, av_up, new_st)
    new_depth = torch.where(aco, depth - 1, new_depth)
    # any other byte taken in _S_VALUE clears the just-opened marker;
    # opening an array arms ']', opening an object arms '}'
    new_lit_pos = torch.where(take & ~(vs_st == _S_LIT), 0, new_lit_pos)
    new_lit_pos = torch.where(take & vs_oarr, -7, new_lit_pos)
    new_lit_pos = torch.where(take & vs_oobj, -9, new_lit_pos)

    # --- _S_OBJ_KEY ---
    in_key = st == _S_OBJ_KEY
    is_q = c == ord('"')
    brace_ok = (c == ord("}")) & (lit_pos == -9)
    k_quote = act & in_key & is_q
    k_close = act & in_key & brace_ok
    k_bad = act & in_key & ~is_ws & ~is_q & ~brace_ok
    new_st = torch.where(k_quote, _S_STR, new_st)
    new_lit_sel = torch.where(k_quote, 3, new_lit_sel)  # key marker
    new_st = torch.where(k_close, av_up, new_st)
    new_depth = torch.where(k_close, depth - 1, new_depth)
    new_st = torch.where(k_bad, _S_FAIL, new_st)

    # --- _S_OBJ_COLON ---
    in_colon = st == _S_OBJ_COLON
    is_colon = c == ord(":")
    col_ok = act & in_colon & is_colon
    new_st = torch.where(col_ok, _S_VALUE, new_st)
    new_lit_pos = torch.where(col_ok, 0, new_lit_pos)
    new_st = torch.where(act & in_colon & ~is_ws & ~is_colon, _S_FAIL,
                         new_st)

    # --- _S_OBJ_NEXT / _S_ARR_NEXT ---
    is_comma = c == ord(",")
    is_cbrace = c == ord("}")
    is_cbrack = c == ord("]")
    on = st == _S_OBJ_NEXT
    on_comma = act & on & is_comma
    on_close = act & on & is_cbrace
    new_st = torch.where(on_comma, _S_OBJ_KEY, new_st)
    new_lit_pos = torch.where(on_comma, 0, new_lit_pos)
    new_st = torch.where(on_close, av_up, new_st)
    new_depth = torch.where(on_close, depth - 1, new_depth)
    new_st = torch.where(act & on & ~is_ws & ~is_comma & ~is_cbrace,
                         _S_FAIL, new_st)
    an = st == _S_ARR_NEXT
    an_comma = act & an & is_comma
    an_close = act & an & is_cbrack
    new_st = torch.where(an_comma, _S_VALUE, new_st)
    new_lit_pos = torch.where(an_comma, 0, new_lit_pos)
    new_st = torch.where(an_close, av_up, new_st)
    new_depth = torch.where(an_close, depth - 1, new_depth)
    new_st = torch.where(act & an & ~is_ws & ~is_comma & ~is_cbrack,
                         _S_FAIL, new_st)

    # --- strings ---
    new_st = torch.where(act & end_str, st_after_str, new_st)
    new_st = torch.where(act & bad_ctl, _S_FAIL, new_st)
    new_esc = act & in_str & new_esc
    # leaving a key string resets nothing; the marker clears on ':'
    new_lit_sel = torch.where(act & end_str & (lit_sel != 3), 0,
                              new_lit_sel)

    # --- numbers and literals: a delimiter closes the token, then is
    # processed in the follow state ---
    lit_full = in_lit & (lit_pos == lit_len)
    for ended in (act & in_num & delim & num_ok_end, None,
                  act & lit_full & delim):
        if ended is None:
            # a number byte that closes nothing continues it
            cont_num = act & in_num & ~(delim & num_ok_end)
            new_st = torch.where(cont_num, nxt_num, new_st)
            # literals: the next expected byte, or a failure
            lit_match = in_lit & (c == lit_char) & (lit_pos < lit_len)
            new_lit_pos = torch.where(act & lit_match, lit_pos + 1,
                                      new_lit_pos)
            new_st = torch.where(act & in_lit & ~lit_match, _S_FAIL, new_st)
            continue
        p_on = ended & (av == _S_OBJ_NEXT)
        p_an = ended & (av == _S_ARR_NEXT)
        p_close = (p_on & is_cbrace) | (p_an & is_cbrack)
        # a close bracket of the WRONG container kind is no terminator
        done_bad = (ended & (av == _S_DONE) & ~is_ws) \
            | (p_an & is_cbrace) | (p_on & is_cbrack)
        new_st = torch.where(ended, av, new_st)
        new_st = torch.where(p_on & is_comma, _S_OBJ_KEY, new_st)
        new_st = torch.where(p_an & is_comma, _S_VALUE, new_st)
        new_st = torch.where(p_close, av_up, new_st)
        new_depth = torch.where(p_close, depth - 1, new_depth)
        new_st = torch.where(done_bad, _S_FAIL, new_st)
    new_st = torch.where(act & lit_full & ~delim, _S_FAIL, new_st)

    # --- DONE: only whitespace ---
    new_st = torch.where(act & (st == _S_DONE) & ~is_ws, _S_FAIL, new_st)
    # depth cap / underflow; failure is sticky
    new_st = torch.where((new_depth > _DEPTH_CAP) | (new_depth < 0)
                         | (st == _S_FAIL), _S_FAIL, new_st)

    return (torch.where(act, new_st, st),
            torch.where(act, new_depth, depth),
            torch.where(act, new_objbits, objbits),
            torch.where(act, new_esc, esc),
            torch.where(act, new_lit_sel, lit_sel),
            torch.where(act, new_lit_pos, lit_pos),
            torch.where(act, new_ucnt, ucnt))


# ---------------------------------------------------------------------------
# navigation
# ---------------------------------------------------------------------------

def _at(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``plane[row, clamp(idx)]``."""
    W = plane.shape[1]
    return torch.gather(plane, 1, idx.clamp(0, W - 1).to(torch.int64)[:, None])[:, 0]


def _navigate(mat, lens, steps: Tuple):
    """Narrow [start, end) to the value span the KEY/INDEX chain addresses.
    Returns (found, certified, s, e, str_token); ``certified`` is False
    where device semantics might diverge (an escape inside a candidate
    key): those rows take the host tier whole."""
    n, W = mat.shape
    dev = mat.device
    i32 = torch.int32
    pos = torch.arange(W, dtype=i32, device=dev)[None, :]
    lens = lens.to(i32)
    real_quote, str_token, _escaped, in_len = _string_masks(mat, lens)
    del _escaped
    depth, opens, closes = _depth(mat, str_token, in_len)
    del opens
    structural = ~str_token & in_len
    nonws = ~_is_ws(mat) & in_len
    # the next non-ws position at or after each position; key matching
    # requires the colon BEFORE the first-index scan, so a string VALUE
    # whose content equals the key does not shadow it
    nn = _rev_cummin(torch.where(nonws, pos, W))
    colon_plane = structural & (mat == ord(":"))
    colon_pad = torch.cat([colon_plane, torch.zeros((n, 1), dtype=torch.bool,
                                                    device=dev)], dim=1)
    colon_at_next = torch.gather(colon_pad, 1, nn.clamp(0, W).to(torch.int64))
    del nn, colon_pad, colon_plane

    # root span: first non-ws .. last non-ws (validation guarantees one
    # root value and trailing whitespace only)
    zero = torch.zeros(n, dtype=i32, device=dev)
    full = torch.full_like(zero, W)
    nonws_m, quotes = Marks(nonws), Marks(real_quote)
    s, found_s = nonws_m.first(zero, lens)
    last_nonws, _ = nonws_m.last(zero, full)
    e = torch.where(found_s, last_nonws + 1, s)
    found = found_s
    certified = torch.ones(n, dtype=torch.bool, device=dev)
    is_delim_byte = (mat == ord(",")) | (mat == ord("}")) | (mat == ord("]"))

    def value_end(v, d_of_v):
        """End (exclusive) of the value starting at v, whose depth at v is
        d_of_v (inside the container if v opens one)."""
        b = byte_at(mat, v)
        is_open = (b == ord("{")) | (b == ord("["))
        is_str = b == ord('"')
        # a container: the first close back at depth d_of_v - 1
        c_idx, _ = first_index(closes & (depth == (d_of_v - 1)[:, None]),
                               v + 1, lens)
        # a string: the next real quote
        q_idx, _ = quotes.first(v + 1, lens)
        # a scalar: the next structural , } ] at this depth, else the end
        delim = structural & is_delim_byte & (depth <= d_of_v[:, None])
        s_idx, s_f = first_index(delim, v + 1, lens)
        return torch.where(is_open, c_idx + 1,
                           torch.where(is_str, q_idx + 1,
                                       torch.where(s_f, s_idx, lens)))

    for kind, name, index in steps:
        d_in = _at(depth, s).to(i32)
        if kind == "key":
            kb = name.encode()
            klen = len(kb)
            is_obj = byte_at(mat, s) == ord("{")
            # candidate key opens: real quotes at depth d_in inside the
            # span; a key's closing quote is followed (ws*) by ':'
            cand = real_quote & (depth == d_in[:, None]) \
                & (pos > s[:, None]) & (pos < e[:, None])
            is_key_match = cand.clone()
            _and_shifted(is_key_match, real_quote, klen + 1)
            _and_shifted(is_key_match, colon_at_next, klen + 2)
            for i, byte in enumerate(kb):
                _and_shifted(is_key_match, mat, i + 1, byte)
            # an escape inside the candidate content uncertifies the row
            # (the PDA compares raw bytes; the device refuses to guess)
            if klen:
                bs_plane = mat == ord("\\")
                bs_win = torch.zeros_like(bs_plane)
                for i in range(klen):
                    bs_win[:, :W - i - 1] |= bs_plane[:, i + 1:]
                certified = certified & ~(cand & bs_win).any(dim=1)
                del bs_plane, bs_win
            # the first colon-verified key match in document order
            k_open, k_f = first_index(is_key_match, s, e)
            k_close = k_open + klen + 1
            nx, nx_f = nonws_m.first(k_close + 1, e)
            k_ok = k_f & nx_f  # nx is the ':' (is_key_match verified it)
            v, v_f = nonws_m.first(nx + 1, e)
            new_found = found & is_obj & k_ok & v_f
        else:
            is_arr = byte_at(mat, s) == ord("[")
            if index == 0:
                v, v_f = nonws_m.first(s + 1, e)
                # an empty array: the first non-ws is ']'
                v_ok = v_f & (byte_at(mat, v) != ord("]"))
            else:
                commas = structural & (mat == ord(",")) \
                    & (depth == d_in[:, None]) \
                    & (pos > s[:, None]) & (pos < e[:, None])
                ccum = torch.cumsum(commas, dim=1, dtype=_plane_type(W))
                kth = commas & (ccum == index)
                c_idx, c_f = first_index(kth, s, e)
                v, v_f = nonws_m.first(c_idx + 1, e)
                v_ok = c_f & v_f
            new_found = found & is_arr & v_ok
        d_val = _at(depth, v).to(i32)
        new_e = value_end(v, d_val)
        s = torch.where(new_found, v, s)
        e = torch.where(new_found, new_e, e)
        found = new_found

    # trim trailing whitespace off the final span (a scalar's end ran to a
    # delimiter; container and string ends are exact already)
    last_n, has_any = nonws_m.last(s, e)
    e = torch.where(has_any, last_n + 1, e)
    found = found & has_any

    # Spark's evaluator: a KEY access landing on the literal null is SQL
    # NULL; an INDEX (or bare $) access returns the text 'null'
    if steps and steps[-1][0] == "key":
        is_null = (e - s) == 4
        for i, byte in enumerate(b"null"):
            is_null = is_null & (byte_at(mat, s + i) == byte)
        found = found & ~is_null
    return found, certified, s, e, str_token


def _span_is_canonical(mat, lens, s, e, str_token) -> torch.Tensor:
    """bool[n]: Spark's normalization is the identity on this span: no
    whitespace (outside strings it is stripped; inside, conservatively
    excluded too), no escape, numbers only as plain integers (< 19 digits,
    no '.'/exponent, no '-0'), so the raw span equals the PDA's output
    byte for byte."""
    n, W = mat.shape
    it = _plane_type(W)
    pos = torch.arange(W, dtype=torch.int32, device=mat.device)[None, :]
    in_len = pos < lens[:, None]
    span = (pos >= s[:, None]) & (pos < e[:, None]) & in_len
    dig = (mat >= ord("0")) & (mat <= ord("9"))
    bad = span & (_is_ws(mat) | (mat == ord("\\")))
    outside = span & ~str_token
    # a digit running into '.'/'e'/'E' marks a float or exponent token
    nxt = mat[:, 1:]
    bad[:, :-1] |= (outside & dig)[:, :-1] & (
        (nxt == ord(".")) | (nxt == ord("e")) | (nxt == ord("E")))
    # '-0' is valid JSON whose canonical double form may differ
    bad[:, 1:] |= (outside & (mat == ord("0")))[:, 1:] \
        & (mat[:, :-1] == ord("-"))
    # digit runs of 19 or more can exceed int64 and re-format (only a row
    # with 19 such digits in all can hold one: those rows are scanned)
    D = outside & dig
    ok = ~bad.any(dim=1)
    rows = torch.nonzero(D.sum(dim=1, dtype=torch.int32) >= 19)[:, 0]
    if rows.numel():
        sub = D.index_select(0, rows)
        idx = torch.arange(W, dtype=it, device=mat.device)[None, :]
        last_not = torch.cummax(torch.where(~sub, idx, -1), dim=1).values
        ok[rows] &= ~(sub & ((idx - last_not) >= 19)).any(dim=1)
    return ok


def _select_strings(mask, a: Column, b: Column) -> Column:
    """Row by row ``a`` where ``mask`` else ``b`` (two aligned STRING
    columns), one device gather over their joined characters."""
    na = int(a.data.shape[0])
    starts = torch.where(mask, a.offsets[:-1].to(torch.int64),
                         na + b.offsets[:-1].to(torch.int64))
    la = a.offsets[1:] - a.offsets[:-1]
    lb = b.offsets[1:] - b.offsets[:-1]
    validity = torch.where(mask, a.valid_mask(), b.valid_mask())
    return gather_spans(torch.cat([a.data, b.data]), starts,
                        torch.where(mask, la, lb), validity)


def replace_rows(col: Column, rows: torch.Tensor, sub: Column) -> Column:
    """``col`` with its rows ``rows`` (int64, ascending) replaced by the
    rows of ``sub`` in order: one device gather over the joined
    characters."""
    starts = col.offsets[:-1].to(torch.int64).clone()
    lens = (col.offsets[1:] - col.offsets[:-1]).clone()
    validity = col.valid_mask().clone()
    starts[rows] = int(col.data.shape[0]) + sub.offsets[:-1].to(torch.int64)
    lens[rows] = sub.offsets[1:] - sub.offsets[:-1]
    validity[rows] = sub.valid_mask()
    return gather_spans(torch.cat([col.data, sub.data]), starts, lens,
                        validity)


# ---------------------------------------------------------------------------
# the entry
# ---------------------------------------------------------------------------

def supported_steps(ops: Sequence) -> Optional[Tuple]:
    """A KEY/INDEX-only chain as ``(kind, name, index)`` steps; None where
    the path needs the host tier."""
    from .get_json_object import PathInstructionType as P
    steps = []
    for t, name, idx in ops:
        if t == P.KEY or t == P.SUBSCRIPT:
            continue  # markers before NAMED, and before INDEX/WILDCARD
        if t == P.NAMED:
            steps.append(("key", name, 0))
        elif t == P.INDEX:
            if idx < 0:
                return None
            steps.append(("index", "", int(idx)))
        else:
            return None  # WILDCARD
    return tuple(steps)


def document_validity(col: Column) -> torch.Tensor:
    """``_validate`` of a STRING column's documents, memoized on the
    column (get_json_object's paths and from_json over one column share
    it; a column is never changed in place)."""
    v = getattr(col, "_json_valid", None)
    if v is None:
        mat, lens = padded_bytes(col)
        v = _validate(mat, lens)
        col._json_valid = v
    return v


def _device_spans(col: Column, steps: Tuple):
    """(found, certified, s, e, canonical) of every row, a row chunk of
    the navigation planes at a time."""
    mat, lens = padded_bytes(col)
    n, W = mat.shape
    parts = []
    for r0, r1 in row_chunks(n, W, CHUNK_ELEMENTS):
        m, ln = mat[r0:r1], lens[r0:r1]
        found, certified, s, e, str_token = _navigate(m, ln, steps)
        canon = _span_is_canonical(m, ln, s, e, str_token)
        parts.append((found, certified, s, e, canon))
    return tuple(torch.cat(p) for p in zip(*parts))


@func_range()
def get_json_object_device(col: Column, ops: Sequence) -> Column:
    """Device validate + navigate, host normalization of the narrowed
    spans; rows the device cannot certify re-run on the host tier."""
    from .get_json_object import get_json_object_with_instructions

    steps = supported_steps(ops)
    if steps is None or col.size == 0:
        string_routes.inc("get_json_host_path", col.size)
        return get_json_object_with_instructions(col, ops)

    n = col.size
    string_routes.inc("get_json_device", n)
    valid_doc = document_validity(col)
    found, certified, s, e, canon = _device_spans(col, steps)
    base_valid = col.valid_mask()
    certified = certified & valid_doc | ~base_valid  # null rows are done
    present = found & valid_doc & certified & base_valid
    # the CANONICAL fast path: the span is the result (compact
    # machine-written JSON takes it for the whole column)
    canonical = present & canon
    counts = torch.stack([canonical.sum(), (present & ~canonical).sum(),
                          (~certified).sum()]).tolist()
    string_routes.inc("get_json_canonical", counts[0])
    string_routes.inc("get_json_span_normalized", counts[1])
    string_routes.inc("get_json_host_uncertified", counts[2])

    # the narrowed spans of the other present rows go through the PDA
    # with the root path (canonical rows as empty spans: "" normalizes to
    # null at about no cost, and one finishing call merges aligned)
    offs = col.offsets[:-1].to(torch.int64)
    spans = gather_spans(col.data, offs + s,
                         torch.where(canonical, 0, e - s), present)
    fin = get_json_object_with_instructions(spans, [])
    if counts[0]:
        # a string scalar unquotes (the PDA returns its content);
        # containers, integers and literals pass through as they are
        mat, _ = padded_bytes(col)
        is_strval = byte_at(mat, s) == ord('"')
        ds = torch.where(is_strval, s + 1, s)
        de = torch.where(is_strval, e - 1, e)
        dev_vals = gather_spans(col.data, offs + ds,
                                torch.where(canonical, de - ds, 0), canonical)
        fin = _select_strings(canonical, dev_vals, fin)
    if not counts[2]:
        return fin
    # only the uncertified rows re-run their whole documents on the host
    # tier, gathered into a small column (bytes end to end)
    rows = torch.nonzero(~certified)[:, 0]
    redo = get_json_object_with_instructions(gather(col, rows), ops)
    return replace_rows(fin, rows, redo)
