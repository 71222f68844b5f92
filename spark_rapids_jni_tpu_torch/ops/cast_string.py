"""Spark-exact string -> integer, decimal and float casts (the JAX
package's ops/cast_string.py; reference cast_string.cu and
cast_string_to_float.cu, CastStrings.java).

The reference marches each row with one CUDA thread. As in the JAX
package, the same per-character state machine runs here over the padded
byte matrix (``columnar/strings.padded_bytes``), one step per character
column, with the whole column's state held in tensors on the column's
device: the JAX package's ``lax.scan`` over the character axis becomes a
Python loop over the columns of the transposed matrix, and its bounded
``fori_loop``s keep their bounds and run masked. No step reads a value
back to the host; so every character loop runs as many steps as the
longest string has characters (rounded up to its padded width), for all
rows, as in the JAX package.

Spark semantics, reproduced as the JAX package computes them:
  * whitespace = {space, \\r, \\t, \\n}; optional leading/trailing strip;
  * integers: optional +/- for signed types only; a '.' truncates in
    non-ANSI mode, but a bad character after it still invalidates the
    row; per-digit overflow checks against the target type's limits in
    C's truncating division;
  * decimals: validate and locate the decimal point (scientific notation
    included), then a digit march with HALF_UP rounding at the precision,
    significant-digit accounting and zero padding to the scale. ``scale``
    is the cudf convention (negative = fractional digits); the column's
    dtype records the Java scale (= -scale). Exponents accumulate in 64
    bits, as in the JAX package (a deliberate departure from the
    reference's 128-bit lanes);
  * floats: nan / [+-]inf / [+-]infinity literals, one trailing f/F/d/D,
    exponents of at most 4 digits, mantissas past 19 digits truncated,
    with the JAX package's exponent bookkeeping (its deliberate departure
    from the reference's warp-batch accounting); the value's bits come
    from ops/float_bits.py, FLOAT32 rounded once;
  * ANSI mode: one host read decides whether a row failed; the first one
    is raised as ``CastException(row, string)``.

Accumulators: u64 bits in int64 lanes for integer targets and floats
(unsigned compares through ``int128.ult``). The JAX package marches every
decimal in 4 x 32-bit limbs; here a DECIMAL32/64 target marches in int64
lanes, which its storage limits bound (the same values, a quarter of the
bytes and none of the limb carries), and a DECIMAL128 target in 4 x
32-bit limb lanes (ops/int128.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar.column import Column
from ..columnar.dtype import DType, TypeId
from ..columnar.strings import padded_bytes
from . import float_bits, int128
from .int128 import s64, ult


class CastException(RuntimeError):
    """ANSI-mode cast failure carrying the first failing row
    (com.nvidia.spark.rapids.jni.CastException)."""

    def __init__(self, row_number: int, string_with_error: str):
        super().__init__(
            f"Error casting data on row {row_number}: {string_with_error}")
        self.row_number = row_number
        self.string_with_error = string_with_error


_INT_TYPES = {
    TypeId.INT8: "int8", TypeId.INT16: "int16",
    TypeId.INT32: "int32", TypeId.INT64: "int64",
    TypeId.UINT8: "uint8", TypeId.UINT16: "uint16",
    TypeId.UINT32: "uint32", TypeId.UINT64: "uint64",
}

_SPACE, _TAB, _LF, _CR = 32, 9, 10, 13
_PLUS, _MINUS, _DOT, _ZERO = ord("+"), ord("-"), ord("."), ord("0")


def _is_ws(ch):
    return (ch == _SPACE) | (ch == _TAB) | (ch == _LF) | (ch == _CR)


def _is_digit(ch):
    return (ch >= 48) & (ch <= 57)


_BLOCK = 32  # character columns transposed at a time


def _columns(mat: torch.Tensor):
    """The padded matrix's character columns in order, each contiguous,
    with their indices: the scan's ``xs``. Transposed a block of columns
    at a time, so the copy never takes more than a block's memory."""
    for c0 in range(0, mat.shape[1], _BLOCK):
        block = mat[:, c0:c0 + _BLOCK].t().contiguous()
        for k in range(block.shape[0]):
            yield c0 + k, block[k]


def _ule(a: torch.Tensor, c: int) -> torch.Tensor:
    """a <= c for u64 lanes a and a constant 0 <= c < 2^63."""
    return (a >= 0) & (a <= c)


def _first_non_ws(mat, lengths, strip: bool):
    """Index of each row's first non-whitespace character (its length if
    it has none): one step a character column, no [n, L] temporaries."""
    if not strip:
        return torch.zeros_like(lengths)
    first = lengths.clone()
    found = torch.zeros(mat.shape[0], dtype=torch.bool, device=mat.device)
    for c, ch in _columns(mat):
        hit = ~found & ~_is_ws(ch) & (c < lengths)
        first = torch.where(hit, c, first)
        found = found | hit
    return first


def _lead_sign(mat, lengths, strip: bool, signed: bool):
    """(index of the first payload character, negative, invalid): the
    whitespace skip and the sign."""
    n, L = mat.shape
    i_ws = _first_non_ws(mat, lengths, strip)
    ch0 = mat.gather(1, i_ws.clamp(0, L - 1)[:, None])[:, 0]
    if signed:
        has_sign = (i_ws < lengths) & ((ch0 == _PLUS) | (ch0 == _MINUS))
    else:
        has_sign = torch.zeros(n, dtype=torch.bool, device=mat.device)
    negative = has_sign & (ch0 == _MINUS)
    i0 = i_ws + has_sign.to(i_ws.dtype)
    invalid = (lengths == 0) | (i0 >= lengths)
    return i0, negative, invalid


def _padded(col: Column):
    mat, lengths = padded_bytes(col)
    return mat, lengths.to(torch.int32)


def _raise_first_error(col: Column, errors: torch.Tensor) -> None:
    """One host read: whether any row failed, and the first one. A
    failure raises CastException with that row's string."""
    any_row = torch.stack([errors.any().to(torch.int64),
                           torch.argmax(errors.to(torch.uint8)).to(
                               torch.int64)]).tolist()
    if any_row[0]:
        row = any_row[1]
        start, end = col.offsets[row:row + 2].tolist()
        s = bytes(col.data[start:end].cpu().numpy()).decode(
            "utf-8", errors="replace")
        raise CastException(row, s)


def _empty(out_dtype: DType, device) -> Column:
    shape = (0, 4) if out_dtype.id is TypeId.DECIMAL128 else (0,)
    return Column(out_dtype, 0, data=torch.zeros(
        shape, dtype=out_dtype.torch_dtype, device=device))


def _narrow(val: torch.Tensor, torch_dtype) -> torch.Tensor:
    """int64 lanes -> ``torch_dtype`` keeping the low bits (the value, when
    it fits; unsigned types land on their signed storage's bits)."""
    bits = torch.iinfo(torch_dtype).bits
    if bits == 64:
        return val
    low = val & ((1 << bits) - 1)
    if torch_dtype is not torch.uint8:
        sign = 1 << (bits - 1)
        low = (low ^ sign) - sign
    return low.to(torch_dtype)


# ---------------------------------------------------------------------------
# string -> integer
# ---------------------------------------------------------------------------

def _string_to_integer_core(mat, lengths, in_valid, *, tname: str,
                            ansi: bool, strip: bool):
    n, L = mat.shape
    dev = mat.device
    info = np.iinfo(tname)
    signed = info.min < 0
    # the limits as u64/int64 bits; C's division truncates toward zero
    tmax, tmin = s64(int(info.max)), int(info.min)
    tmax_d10 = s64(int(info.max) // 10)
    tmin_d10 = -((-int(info.min)) // 10) if signed else 0
    gt = torch.gt if signed else (lambda a, b: ult(b, a))
    lt = torch.lt if signed else ult

    valid0 = in_valid & (lengths > 0)
    zeros = torch.zeros(n, dtype=torch.bool, device=dev)
    started, seen_sign, negative = zeros, zeros, zeros
    truncating, trailing_ws = zeros, zeros
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    val = torch.zeros(n, dtype=torch.int64, device=dev)

    for c, ch in _columns(mat):
        act = (c < lengths) & valid & valid0
        is_ws = _is_ws(ch)
        is_dig = _is_digit(ch)

        # leading phase: skip whitespace (only before a sign), take one
        # optional sign; the character after the sign enters the loop
        lead = act & ~started
        stay_ws = lead & is_ws & ~seen_sign if strip else zeros
        if signed:
            take_sign = lead & ~stay_ws & ~seen_sign & (
                (ch == _PLUS) | (ch == _MINUS))
        else:
            take_sign = zeros
        start_now = lead & ~stay_ws & ~take_sign
        started = started | start_now
        seen_sign = seen_sign | take_sign
        negative = negative | (take_sign & (ch == _MINUS))

        # the digit loop (cast_string.cu:204-235)
        in_loop = act & started
        first = start_now
        inv_after_ws = in_loop & trailing_ws & ~is_ws
        set_trunc = in_loop & ~inv_after_ws & ~truncating & (ch == _DOT)
        if ansi:
            set_trunc = zeros
        in_else = in_loop & ~inv_after_ws & ~set_trunc
        nondig = in_else & ~is_dig
        tws_ok = is_ws & ~first if strip else zeros
        set_tws = nondig & tws_ok
        new_invalid = inv_after_ws | (nondig & ~tws_ok)

        proc = (in_loop & is_dig & ~new_invalid & ~truncating & ~trailing_ws
                & ~set_trunc)
        digit = ch.to(torch.int64) - 48
        adding = ~negative
        ovf_mul = torch.where(adding, gt(val, tmax_d10),
                              lt(val, tmin_d10)) & ~first
        val10 = torch.where(first, val, val * 10)
        ovf_add = torch.where(adding, gt(val10, tmax - digit),
                              lt(val10, tmin + digit))
        val_new = torch.where(adding, val10 + digit, val10 - digit)
        ok = proc & ~ovf_mul & ~ovf_add
        val = torch.where(ok, val_new, val)
        new_invalid = new_invalid | (proc & (ovf_mul | ovf_add))

        valid = valid & ~new_invalid
        truncating = truncating | set_trunc
        trailing_ws = trailing_ws | set_tws

    valid = valid & valid0 & started
    return torch.where(valid, val, 0), valid


def string_to_integer(col: Column, out_dtype: DType, ansi_mode: bool = False,
                      strip: bool = True) -> Column:
    """Cast a STRING column to an integer column with Spark semantics
    (spark_rapids_jni::string_to_integer, CastStrings.toInteger)."""
    if col.dtype.id is not TypeId.STRING:
        raise TypeError("input must be a STRING column")
    tname = _INT_TYPES[out_dtype.id]
    if col.size == 0:
        return _empty(out_dtype, col.device)
    mat, lengths = _padded(col)
    in_valid = col.valid_mask()
    val, valid = _string_to_integer_core(mat, lengths, in_valid,
                                         tname=tname, ansi=ansi_mode,
                                         strip=strip)
    if ansi_mode:
        _raise_first_error(col, in_valid & ~valid)
    return Column(out_dtype, col.size,
                  data=_narrow(val, out_dtype.torch_dtype), validity=valid)


# ---------------------------------------------------------------------------
# string -> decimal
# ---------------------------------------------------------------------------

# phase-1 states (cast_string.cu:260-269)
_ST_DIGITS, _ST_EXPONENT, _ST_DECIMAL_POINT = 0, 1, 2
_ST_EXP_OR_SIGN, _ST_EXP_SIGN, _ST_TRAIL_WS, _ST_INVALID = 3, 4, 5, 6


class _Lanes64:
    """The decimal march's values as int64 lanes: enough for a DECIMAL32 or
    DECIMAL64 target, whose storage limits bound every value the march
    and the zero padding hold (|value| < 2^63)."""

    def __init__(self, n, device):
        self.n, self.device = n, device

    def const(self, v):
        return v

    def zeros(self):
        return torch.zeros(self.n, dtype=torch.int64, device=self.device)

    gt, lt = staticmethod(torch.gt), staticmethod(torch.lt)

    @staticmethod
    def mul10(a):
        return a * 10

    @staticmethod
    def add(a, d):
        return a + d

    @staticmethod
    def sel(mask, a, b):
        return torch.where(mask, a, b)

    @staticmethod
    def is_zero(a):
        return a == 0

    def ndigits(self, a):
        mag = a.abs()
        count = torch.zeros_like(a)
        for k in range(19):
            count += (mag >= 10 ** k).to(torch.int64)
        return count

class _Lanes128:
    """The decimal march's values as 4 x 32-bit limb lanes
    (ops/int128.py): a DECIMAL128 target."""

    def __init__(self, n, device):
        self.n, self.device = n, device

    def const(self, v):
        return int128.from_int_py(v, self.n, self.device)

    def zeros(self):
        return int128.zeros(self.n, self.device)

    gt = staticmethod(int128.gt_signed)
    lt = staticmethod(int128.lt_signed)
    mul10 = staticmethod(int128.mul10)
    add = staticmethod(int128.add_small)
    is_zero = staticmethod(int128.is_zero)
    ndigits = staticmethod(int128.ndigits)

    @staticmethod
    def sel(mask, a, b):
        return torch.where(mask[:, None], a, b)


def _string_to_decimal_core(mat, lengths, in_valid, *, precision: int,
                            scale: int, strip: bool):
    n, L = mat.shape
    dev = mat.device
    # the storage type's limits, which every overflow check uses
    if precision <= 9:
        t_lo, t_hi = -(2 ** 31), 2 ** 31 - 1
    elif precision <= 18:
        t_lo, t_hi = -(2 ** 63), 2 ** 63 - 1
    else:
        t_lo, t_hi = -(2 ** 127), 2 ** 127 - 1
    emax, emin = min(t_hi, 2 ** 63 - 1), max(t_lo, -(2 ** 63))
    emax_d10, emin_d10 = emax // 10, -((-emin) // 10)
    V = (_Lanes64 if precision <= 18 else _Lanes128)(n, dev)
    max_v, min_v = V.const(t_hi), V.const(t_lo)
    maxd10, mind10 = V.const(t_hi // 10), V.const(-((-t_lo) // 10))
    max_less1, min_plus1 = V.const(t_hi - 1), V.const(t_lo + 1)

    def will_ovf_mul(val):
        return torch.where(positive, V.gt(val, maxd10), V.lt(val, mind10))

    i0, negative, invalid0 = _lead_sign(mat, lengths, strip, signed=True)
    positive = ~negative
    zeros = torch.zeros(n, dtype=torch.bool, device=dev)

    # ---- phase 1: validate and find the decimal point ------------------
    st = torch.full((n,), _ST_DIGITS, dtype=torch.int8, device=dev)
    dl = torch.full((n,), -1, dtype=torch.int32, device=dev)
    exp_pos = torch.ones(n, dtype=torch.bool, device=dev)
    exp = torch.zeros(n, dtype=torch.int64, device=dev)
    ld_rel = lengths - i0
    exp_invalid = zeros
    e_pos, found_e = lengths, zeros  # the first e/E of the payload
    for c, ch in _columns(mat):
        within = (c >= i0) & (c < lengths)
        act = within & (st != _ST_INVALID) & ~invalid0
        chr_idx = c - i0
        is_ws = _is_ws(ch)
        is_dig = _is_digit(ch)
        is_dot = ch == _DOT
        is_e = (ch == ord("e")) | (ch == ord("E"))
        ws_trail = (is_ws & (chr_idx != 0)) if strip else zeros
        first_e = within & is_e & ~found_e
        e_pos = torch.where(first_e, c, e_pos)
        found_e = found_e | first_e

        ns = st
        in_tw = act & (st == _ST_TRAIL_WS)
        ns = torch.where(in_tw & ~is_ws, _ST_INVALID, ns)
        in_dg = act & ((st == _ST_DIGITS) | (st == _ST_DECIMAL_POINT))
        take_dot = in_dg & ~is_dig & is_dot & (dl == -1)
        dg_next = torch.where(
            is_dig, _ST_DIGITS, torch.where(
                take_dot, _ST_DECIMAL_POINT, torch.where(
                    is_e, _ST_EXP_OR_SIGN, torch.where(
                        ws_trail, _ST_TRAIL_WS, _ST_INVALID)))).to(torch.int8)
        ns = torch.where(in_dg, dg_next, ns)
        dl = torch.where(take_dot, chr_idx, dl)
        in_es = act & (st == _ST_EXP_OR_SIGN)
        is_plus, is_minus = ch == _PLUS, ch == _MINUS
        es_next = torch.where(
            is_plus | is_minus, _ST_EXP_SIGN, torch.where(
                ws_trail, _ST_TRAIL_WS, torch.where(
                    is_dig, _ST_EXPONENT, _ST_INVALID))).to(torch.int8)
        ns = torch.where(in_es, es_next, ns)
        exp_pos = torch.where(in_es & is_minus, False, exp_pos)
        in_ex = act & ((st == _ST_EXP_SIGN) | (st == _ST_EXPONENT))
        ns = torch.where(in_ex, torch.where(is_dig, _ST_EXPONENT,
                                            _ST_INVALID).to(torch.int8), ns)

        # leaving the digits for a state other than a point records the
        # last digit's place
        left_digits = (act & (st == _ST_DIGITS) & (ns != _ST_DIGITS)
                       & (ns != _ST_DECIMAL_POINT))
        ld_rel = torch.where(left_digits, chr_idx, ld_rel)

        # the exponent (process_value, cast_string.cu:357-363)
        exp_here = act & (ns == _ST_EXPONENT)
        d = ch.to(torch.int64) - 48
        first = exp == 0
        ovf_m = ~first & torch.where(exp_pos, exp > emax_d10,
                                     exp < emin_d10)
        e10 = torch.where(first, exp, exp * 10)
        ovf_a = torch.where(exp_pos, e10 > emax - d, e10 < emin + d)
        e_new = torch.where(exp_pos, e10 + d, e10 - d)
        exp = torch.where(exp_here & ~ovf_m & ~ovf_a, e_new, exp)
        exp_invalid = exp_invalid | (exp_here & (ovf_m | ovf_a))
        st = ns

    valid1 = in_valid & ~invalid0 & (st != _ST_INVALID) & ~exp_invalid
    # the point defaults to the end of the digits; the exponent moves it
    dl = torch.where(dl < 0, ld_rel, dl).to(torch.int64) + exp

    # ---- phase 2: the digit march with rounding (cast_string.cu:442-527)
    last_digit_cnt = dl - scale
    march_on = valid1 & (last_digit_cnt >= 0)
    one = torch.where(positive, 1, -1)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    val = V.zeros()
    total = torch.zeros(n, dtype=torch.int32, device=dev)
    precise = torch.zeros(n, dtype=torch.int32, device=dev)
    found_sig, r_inc = zeros, zeros
    valid2 = torch.ones(n, dtype=torch.bool, device=dev)
    r_orig = V.zeros()
    # significant digits before the point in the string, counted in the
    # same pass (count_significant_digits, cast_string.cu:424-440): the
    # digits before the exponent, the first dl of them, from the first
    # nonzero one
    ordinal = torch.zeros(n, dtype=torch.int32, device=dev)
    seen_nz = zeros
    sig_in_string = torch.zeros(n, dtype=torch.int32, device=dev)
    for c, ch in _columns(mat):
        within = (c >= i0) & (c < lengths)
        is_dot = ch == _DOT
        eligible = within & (c < e_pos) & ~is_dot
        processed = eligible & (ordinal < dl)
        seen_nz = seen_nz | (processed & (ch != _ZERO))
        sig_in_string = sig_in_string + (processed & seen_nz).to(torch.int32)
        ordinal = ordinal + eligible.to(torch.int32)

        act = march_on & active & valid2 & within
        is_dig = _is_digit(ch)
        brk = act & ~is_dot & ~is_dig
        digp = act & is_dig
        digit = ch.to(torch.int64) - 48

        over = digp & ((precise + 1 > precision)
                       | (total + 1 > last_digit_cnt))
        # HALF_UP on the first dropped digit
        do_round = over & (digit >= 5)
        ovf_r = torch.where(positive, V.gt(val, max_less1),
                            V.lt(val, min_plus1))
        rounded = do_round & ~ovf_r
        r_orig = V.sel(rounded, val, r_orig)
        val = V.sel(rounded, V.add(val, one), val)
        r_inc = r_inc | rounded
        valid2 = valid2 & ~(do_round & ovf_r)

        norm = digp & ~over
        total_new = total + norm.to(torch.int32)
        sig = norm & (found_sig | (total_new > dl) | (digit != 0))
        precise = precise + sig.to(torch.int32)
        found_sig = found_sig | sig
        total = total_new

        first = c == i0
        ovf_m = ~first & will_ovf_mul(val)
        v10 = V.sel(first, val, V.mul10(val))
        ovf_a = torch.where(positive, V.gt(v10, V.add(max_v, -digit)),
                            V.lt(v10, V.add(min_v, digit)))
        v_new = V.add(v10, torch.where(positive, digit, -digit))
        ok = norm & ~ovf_m & ~ovf_a
        val = V.sel(ok, v_new, val)
        bad = norm & (ovf_m | ovf_a)
        valid2 = valid2 & ~bad
        active = active & ~brk & ~over & ~bad

    # rounding that carried into a new leading digit (cast_string.cu:489)
    add_dig = (r_inc & ~V.is_zero(r_orig)
               & (V.ndigits(val) > V.ndigits(r_orig))).to(torch.int64)
    total = total + add_dig
    precise = precise + add_dig
    dl = dl + add_dig

    sig_preceding_zeros = torch.where(dl < 0, -dl, 0)
    ztd = (dl - total - (scale if scale > 0 else 0)).clamp(min=0)
    sig_before = sig_in_string + ztd + add_dig
    valid2 = valid2 & (precision + scale >= sig_before)

    # zero pad up to the decimal point (cast_string.cu:547-554); valid1 and
    # valid2 hold through the loop, and k < 40 reads ztd only up to 41
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    ok12 = valid1 & valid2
    ztd_k = ztd.clamp(max=41).to(torch.int32)
    for k in range(40):
        go = alive & (k < ztd_k) & ok12
        ovf = will_ovf_mul(val) & go
        step = go & ~ovf
        val = V.sel(step, V.mul10(val), val)
        precise = precise + step.to(precise.dtype)
        alive = alive & ~ovf
    # a row still alive after 40 pads holds zero; finish arithmetically
    valid2 = valid2 & (alive | (ztd <= 40))
    precise = precise + torch.where(alive & (ztd > 40), ztd - 40, 0)

    # zero pad to the requested scale (cast_string.cu:561-573)
    digits_after = precise - sig_before + sig_preceding_zeros
    needed_after = torch.clamp(precision - sig_before, max=-scale)
    iters2 = (needed_after - digits_after).clamp(min=0)
    alive2 = torch.ones(n, dtype=torch.bool, device=dev)
    ok12 = valid1 & valid2
    iters_k = iters2.clamp(max=81).to(torch.int32)
    for k in range(80):
        go = alive2 & (k < iters_k) & ok12
        ovf = will_ovf_mul(val) & go
        val = V.sel(go & ~ovf, V.mul10(val), val)
        alive2 = alive2 & ~ovf
    valid2 = valid2 & (alive2 | (iters2 <= 80))

    valid = valid1 & valid2
    return V.sel(valid, val, V.zeros()), valid


def string_to_decimal(col: Column, precision: int, scale: int,
                      ansi_mode: bool = False, strip: bool = True) -> Column:
    """Cast a STRING column to DECIMAL32/64/128 with Spark semantics.

    ``scale`` is the native API's cudf convention (negative = digits after
    the point), as spark_rapids_jni::string_to_decimal and
    CastStrings.toDecimal receive it; the column's dtype holds the Java
    scale (= -scale)."""
    if col.dtype.id is not TypeId.STRING:
        raise TypeError("input must be a STRING column")
    if precision > 38 or precision < 1:
        raise ValueError(f"unsupported decimal precision {precision}")
    if precision <= 9:
        out_dtype = dt.decimal32(-scale)
    elif precision <= 18:
        out_dtype = dt.decimal64(-scale)
    else:
        out_dtype = dt.decimal128(-scale)
    if col.size == 0:
        return _empty(out_dtype, col.device)
    mat, lengths = _padded(col)
    in_valid = col.valid_mask()
    val, valid = _string_to_decimal_core(mat, lengths, in_valid,
                                         precision=precision, scale=scale,
                                         strip=strip)
    if ansi_mode:
        _raise_first_error(col, in_valid & ~valid)
    if out_dtype.id is TypeId.DECIMAL128:
        data = int128.storage(val)
    else:
        data = _narrow(val, out_dtype.torch_dtype)
    return Column(out_dtype, col.size, data=data, validity=valid)


# ---------------------------------------------------------------------------
# string -> float
# ---------------------------------------------------------------------------

# phases of the float parse (after whitespace, sign, nan and inf)
_F_DIG = 0      # mantissa digits and an optional point
_F_EXP0 = 1     # just saw e/E: a sign or a digit next
_F_EXP1 = 2     # saw the exponent's sign: a digit next
_F_EXPD = 3     # exponent digits (at most 4)
_F_F = 4        # took one trailing f/F/d/D
_F_TWS = 5      # trailing whitespace
_F_BAD = 6

_MAX_SAFE_DIGITS = 19  # cast_string_to_float.cu:198
_MAX_HOLDING = (2 ** 64 - 1 - 9) // 10  # cast_string_to_float.cu:401


def _string_to_float_core(mat, lengths, in_valid, *, is64: bool):
    n, L = mat.shape
    dev = mat.device
    i0, negative, _ = _lead_sign(mat, lengths, strip=True, signed=True)

    def at(idx):  # the lowercase character at idx (0 past the end)
        ch = mat.gather(1, idx.clamp(0, L - 1).long()[:, None])[:, 0] | 0x20
        return torch.where(idx < lengths, ch, 0)

    # literal nan / inf / infinity at the payload's start
    # (cast_string_to_float.cu:236-254, :274-307)
    c = [at(i0 + k) for k in range(8)]
    is_nan = (c[0] == ord("n")) & (c[1] == ord("a")) & (c[2] == ord("n"))
    nan_valid = is_nan & (lengths == 3)  # only the bare 3-character string
    is_inf = (c[0] == ord("i")) & (c[1] == ord("n")) & (c[2] == ord("f"))
    is_infinity = (is_inf & (c[3] == ord("i")) & (c[4] == ord("n"))
                   & (c[5] == ord("i")) & (c[6] == ord("t"))
                   & (c[7] == ord("y")))
    inf_valid = ((is_inf & (i0 + 3 == lengths))
                 | (is_infinity & (i0 + 8 == lengths)))
    no_payload = (lengths == 0) | (i0 >= lengths)
    handled = is_nan | is_inf | no_payload

    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    zb = torch.zeros(n, dtype=torch.bool, device=dev)
    ph = torch.full((n,), _F_DIG, dtype=torch.int8, device=dev)
    digits = torch.zeros(n, dtype=torch.int64, device=dev)
    real, trunc, dec_pos, exp_val, exp_cnt = zi, zi, zi, zi, zi
    dec, seen, exp_neg, saw_f, excp = zb, zb, zb, zb, zb
    for cidx, ch in _columns(mat):
        act = ((cidx >= i0) & (cidx < lengths) & ~handled & (ph != _F_BAD)
               & in_valid)
        low = ch | 0x20
        is_dig = _is_digit(ch)
        is_ws = _is_ws(ch)
        is_dot = ch == _DOT
        is_e = low == ord("e")
        is_fd = (low == ord("f")) | (low == ord("d"))
        is_sign = (ch == _PLUS) | (ch == _MINUS)
        d64 = ch.to(torch.int64) - 48

        # the mantissa (parse_digits, cast_string_to_float.cu:310)
        in_dig = act & (ph == _F_DIG)
        digit_here = in_dig & is_dig
        strip0 = digit_here & (digits == 0) & ~dec & (ch == _ZERO)
        add_try = digit_here & ~strip0
        dtimes = digits * 10 + d64  # u64: wraps as the JAX package's does
        can_extra = _ule(digits, _MAX_HOLDING) & _ule(dtimes, _MAX_HOLDING)
        do_add = add_try & ((real < _MAX_SAFE_DIGITS) | can_extra)
        digits = torch.where(do_add, dtimes, digits)
        real = real + do_add.to(torch.int32)
        trunc = trunc + (add_try & ~do_add).to(torch.int32)
        seen = seen | digit_here
        dot_ok = in_dig & is_dot & ~dec
        dot_bad = in_dig & is_dot & dec  # a second point
        dec = dec | dot_ok
        dec_pos = torch.where(dot_ok, real + trunc, dec_pos)
        to_exp = in_dig & is_e & seen
        to_f = in_dig & is_fd & seen
        to_tws = in_dig & is_ws & seen
        exit_noseen = in_dig & (is_e | is_fd | is_ws) & ~seen
        dig_bad = in_dig & ~is_dig & ~is_dot & ~is_e & ~is_fd & ~is_ws
        bad_now = dot_bad | exit_noseen | dig_bad

        # the exponent (parse_manual_exp, :479)
        in_e0 = act & (ph == _F_EXP0)
        in_e1 = act & (ph == _F_EXP1)
        in_ed = act & (ph == _F_EXPD)
        e_sign = in_e0 & is_sign
        exp_neg = exp_neg | (e_sign & (ch == _MINUS))
        e_dig = (in_e0 | in_e1 | in_ed) & is_dig
        e_over = e_dig & (exp_cnt >= 4)  # a 5th digit: trailing junk
        e_acc = e_dig & ~e_over
        exp_val = torch.where(e_acc, exp_val * 10 + (ch.to(torch.int32) - 48),
                              exp_val)
        exp_cnt = exp_cnt + e_acc.to(torch.int32)
        ed_f = in_ed & is_fd
        ed_ws = in_ed & is_ws
        bad_now = (bad_now | e_over | (in_e0 & ~is_sign & ~is_dig)
                   | (in_e1 & ~is_dig) | (in_ed & ~is_dig & ~is_fd & ~is_ws))

        # a trailing f and whitespace (check_trailing_bytes, :530)
        in_f = act & (ph == _F_F)
        in_t = act & (ph == _F_TWS)
        f_ws = in_f & is_ws
        bad_now = bad_now | (in_f & ~is_ws) | (in_t & ~is_ws)

        ph = torch.where(to_exp, _F_EXP0, ph)
        ph = torch.where(to_f, _F_F, ph)
        ph = torch.where(to_tws, _F_TWS, ph)
        ph = torch.where(e_sign, _F_EXP1, ph)
        ph = torch.where(e_acc, _F_EXPD, ph)
        ph = torch.where(ed_f, _F_F, ph)
        ph = torch.where(ed_ws | f_ws, _F_TWS, ph)
        ph = torch.where(bad_now, _F_BAD, ph).to(torch.int8)
        saw_f = saw_f | to_f | ed_f
        # every invalidation reports an ANSI error but inf with trailing
        # garbage (cast_string_to_float.cu:303)
        excp = excp | bad_now

    # invalid at the end of the string
    end_bad = (ph == _F_EXP0) | (ph == _F_EXP1) | ((ph == _F_DIG) & ~seen)
    scan_valid = (ph != _F_BAD) & ~end_bad & seen
    excp = excp | end_bad
    # a zero value takes a trailing exponent or whitespace, not f/d
    # (cast_string_to_float.cu:133-143)
    zero_bad = scan_valid & (digits == 0) & saw_f
    scan_valid = scan_valid & ~zero_bad
    excp = excp | zero_bad

    # the value (cast_string_to_float.cu:152-194): +-digits x 10^exp_ten
    total = real + trunc
    exp_base = trunc - torch.where(dec, total - dec_pos, 0)
    exp_ten = exp_base + torch.where(exp_neg, -exp_val, exp_val)
    if is64:
        bits = float_bits.decimal_to_f64_bits(digits, exp_ten, negative)
        nan_b, inf_b, sign_bit = 0x7FF8000000000000, 0x7FF0000000000000, \
            s64(1 << 63)
    else:
        bits = float_bits.decimal_to_f32_bits(digits, exp_ten, negative)
        nan_b, inf_b, sign_bit = 0x7FC00000, 0x7F800000, 1 << 31
    sign_b = torch.where(negative, sign_bit, 0)

    bits = torch.where(is_nan, nan_b, bits)
    bits = torch.where(is_inf, sign_b | inf_b, bits)
    valid = torch.where(handled, nan_valid | inf_valid, scan_valid)
    valid = valid & in_valid & ~no_payload
    excp = torch.where(handled, (is_nan & ~nan_valid)
                       | (no_payload & ~is_nan & ~is_inf), excp)
    return bits, valid, excp & in_valid


def string_to_float(col: Column, out_dtype: DType,
                    ansi_mode: bool = False) -> Column:
    """Cast a STRING column to FLOAT32/FLOAT64 with Spark semantics
    (spark_rapids_jni::string_to_float). ANSI errors follow the
    reference's except flag (inf with trailing garbage nulls without
    raising)."""
    if col.dtype.id is not TypeId.STRING:
        raise TypeError("input must be a STRING column")
    if out_dtype.id not in (TypeId.FLOAT32, TypeId.FLOAT64):
        raise TypeError(f"string_to_float to {out_dtype.id.value}")
    if col.size == 0:
        return _empty(out_dtype, col.device)
    mat, lengths = _padded(col)
    in_valid = col.valid_mask()
    is64 = out_dtype.id is TypeId.FLOAT64
    bits, valid, excp = _string_to_float_core(mat, lengths, in_valid,
                                              is64=is64)
    if ansi_mode:
        _raise_first_error(col, excp)
    data = (float_bits.f64_value_from_bits(bits) if is64
            else float_bits.f32_value_from_bits(bits))
    return Column(out_dtype, col.size, data=data, validity=valid)
