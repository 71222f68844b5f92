"""Java-compatible float/double -> string, Spark's ``cast(x as string)``
and ``format_number`` (the JAX package's ops/cast_float_to_string.py;
reference cast_float_to_string.cu and ftos_converter.cuh, a device port of
Ryu).

The Ryu shortest-representation algorithm (Ulf Adams, "Ryu: fast
float-to-string conversion", PLDI'18) runs here as torch ops over the
whole column on its device, as the JAX package runs it: masks replace
branches, each digit-strip loop is a masked loop with the JAX package's
bound, and the 64 x 128-bit products use 32-bit limb products
(``int128.umul128``). A u64 is the int64 of the same bits, so its
divisions by 5 and 10 are unsigned (``int128.udivmod``). The core gives
(digits, e10, sign, nan, inf, zero) per row; ``_format_java`` lays the
bytes out by Java's rules (plain decimal for 1e-3 <= |x| < 1e7, else
``d.dddE[-]e``; "NaN", "Infinity", "-Infinity", "0.0", "-0.0") as torch
ops on the device, in row chunks, byte for byte as the JAX package's numpy
layout. ``format_number`` renders each row on the host, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar.column import Column
from ..columnar.strings import from_padded_bytes, pack_byte_rows
from .int128 import M32, lsr, udivmod, ult, umul128

# ---------------------------------------------------------------------------
# tables (host, Python integers, once at import)
# ---------------------------------------------------------------------------

_D_POW5_INV_BITS = 125
_D_POW5_BITS = 125
_F_POW5_INV_BITS = 59
_F_POW5_BITS = 61


def _pow5bits(e: int) -> int:
    return ((e * 1217359) >> 19) + 1


def _gen_double_tables():
    inv = np.zeros((292, 2), dtype=np.uint64)  # (hi, lo)
    for q in range(292):
        k = _D_POW5_INV_BITS + _pow5bits(q) - 1
        v = (1 << k) // (5 ** q) + 1
        inv[q] = ((v >> 64) & 0xFFFFFFFFFFFFFFFF, v & 0xFFFFFFFFFFFFFFFF)
    pw = np.zeros((326, 2), dtype=np.uint64)
    for i in range(326):
        shift = _D_POW5_BITS - _pow5bits(i)
        v = (5 ** i) << shift if shift >= 0 else (5 ** i) >> (-shift)
        pw[i] = ((v >> 64) & 0xFFFFFFFFFFFFFFFF, v & 0xFFFFFFFFFFFFFFFF)
    return inv.view(np.int64), pw.view(np.int64)


def _gen_float_tables():
    inv = np.zeros(31, dtype=np.uint64)
    for q in range(31):
        k = _F_POW5_INV_BITS + _pow5bits(q) - 1
        inv[q] = (1 << k) // (5 ** q) + 1
    pw = np.zeros(48, dtype=np.uint64)
    for i in range(48):
        shift = _F_POW5_BITS - _pow5bits(i)
        pw[i] = (5 ** i) << shift if shift >= 0 else (5 ** i) >> (-shift)
    return inv.view(np.int64), pw.view(np.int64)


_D_INV_TABLE, _D_POW_TABLE = _gen_double_tables()
_F_INV_TABLE, _F_POW_TABLE = _gen_float_tables()
_TABLES = {}


def _tables(device):
    """The four Ryu tables on ``device`` (copied once)."""
    got = _TABLES.get(device)
    if got is None:
        got = _TABLES[device] = tuple(
            torch.from_numpy(t).to(device) for t in (
                _D_INV_TABLE, _D_POW_TABLE, _F_INV_TABLE, _F_POW_TABLE))
    return got


# ---------------------------------------------------------------------------
# 64/128-bit helpers
# ---------------------------------------------------------------------------

def _mul_shift64(m, mul_hi, mul_lo, j):
    """(m x mul) >> j for a 128-bit mul and 64 <= j < 128 (Ryu's
    mulShift64)."""
    b0_hi, _ = umul128(m, mul_lo)
    b2_hi, b2_lo = umul128(m, mul_hi)
    s_lo = b0_hi + b2_lo
    s_hi = b2_hi + ult(s_lo, b2_lo).to(torch.int64)
    return _shr128(s_hi, s_lo, j - 64)


def _shr128(hi, lo, s):
    """(hi:lo) >> s for 0 <= s < 64, and what the JAX package's u64 shifts
    give elsewhere: ``hi`` at s == 64, 0 beyond and below."""
    lo_part = torch.where((s >= 0) & (s < 64), lsr(lo, s.clamp(0, 63)), 0)
    hi_part = torch.where((s >= 1) & (s <= 64),
                          hi << (64 - s.clamp(1, 64)), 0)
    return lo_part | hi_part


def _pow5_factor_ge(value, p, max_iter: int):
    """Where value is divisible by 5^p (p >= 0, small): ``max_iter``
    masked divisions."""
    count = torch.zeros_like(value)
    v = value
    for _ in range(max_iter):
        q, r = udivmod(v, 5)
        divisible = r == 0
        v = torch.where(divisible, q, v)
        count = count + divisible.to(torch.int64)
    return count >= p


def _multiple_of_pow2(value, p):
    mask = torch.where(p >= 64, -1, (1 << p.clamp(max=63)) - 1)
    return (value & mask) == 0


def _strip(vr, vp, vm, vm_trail, vr_trail, last, removed, bound: int):
    """Ryu's shortest-digit search: ``bound`` masked removals, then as
    many again while vm ends in a zero (its general path)."""
    for _ in range(bound):
        qp, _ = udivmod(vp, 10)
        qm, rm = udivmod(vm, 10)
        qr, rr = udivmod(vr, 10)
        active = qp > qm
        vm_trail = torch.where(active, vm_trail & (rm == 0), vm_trail)
        vr_trail = torch.where(active, vr_trail & (last == 0), vr_trail)
        last = torch.where(active, rr, last)
        vr = torch.where(active, qr, vr)
        vp = torch.where(active, qp, vp)
        vm = torch.where(active, qm, vm)
        removed = removed + active.to(torch.int64)
    active = vm_trail
    for _ in range(bound):
        qp, _ = udivmod(vp, 10)
        qm, rm = udivmod(vm, 10)
        qr, rr = udivmod(vr, 10)
        active = active & (rm == 0)
        vr_trail = torch.where(active, vr_trail & (last == 0), vr_trail)
        last = torch.where(active, rr, last)
        vr = torch.where(active, qr, vr)
        vp = torch.where(active, qp, vp)
        vm = torch.where(active, qm, vm)
        removed = removed + active.to(torch.int64)
    return vr, vm, vm_trail, vr_trail, last, removed


def _finish(vr, vm, vm_trail, vr_trail, last, removed, accept, e10,
            specials):
    # round to even: ...50 exactly with an even vr rounds down
    last = torch.where(vr_trail & (last == 5) & ((vr & 1) == 0), 4, last)
    round_up = ((vr == vm) & ~(accept & vm_trail)) | (last >= 5)
    digits = vr + round_up.to(torch.int64)
    e10 = e10 + removed
    return torch.where(specials, 0, digits), torch.where(specials, 0, e10)


# ---------------------------------------------------------------------------
# the d2s core (FLOAT64)
# ---------------------------------------------------------------------------

def _ryu_d2s_core(bits):
    """int64 bits of f64 values -> (digits, e10, sign, is_nan, is_inf,
    is_zero), value = digits x 10^e10 in Ryu's shortest form."""
    inv_tab, pow_tab, _, _ = _tables(bits.device)
    sign = lsr(bits, 63) != 0
    ieee_m = bits & ((1 << 52) - 1)
    ieee_e = lsr(bits, 52) & 0x7FF

    is_nan = (ieee_e == 0x7FF) & (ieee_m != 0)
    is_inf = (ieee_e == 0x7FF) & (ieee_m == 0)
    is_zero = (ieee_e == 0) & (ieee_m == 0)

    subnormal = ieee_e == 0
    e2 = torch.where(subnormal, 1 - 1023 - 52 - 2, ieee_e - 1023 - 52 - 2)
    m2 = torch.where(subnormal, ieee_m, ieee_m | (1 << 52))
    accept = (m2 & 1) == 0

    mv = 4 * m2
    mm_shift = ((ieee_m != 0) | (ieee_e <= 1)).to(torch.int64)
    mp = mv + 2
    mm = mv - 1 - mm_shift

    pos = e2 >= 0
    q_pos = (((e2 * 78913) >> 18) - (e2 > 3).to(torch.int64)).clamp(min=0)
    neg_e2 = -e2
    q_neg = (((neg_e2 * 732923) >> 20) - (neg_e2 > 1).to(
        torch.int64)).clamp(min=0)
    k_pos = _D_POW5_INV_BITS + ((q_pos * 1217359) >> 19)
    j_pos = -e2 + q_pos + k_pos
    i_neg = neg_e2 - q_neg
    k_neg = ((i_neg * 1217359) >> 19) + 1 - _D_POW5_BITS
    j_neg = q_neg - k_neg

    inv = inv_tab[q_pos.clamp(0, inv_tab.shape[0] - 1)]
    pw = pow_tab[i_neg.clamp(0, pow_tab.shape[0] - 1)]
    mul = torch.where(pos[:, None], inv, pw)
    mul_hi, mul_lo = mul[:, 0], mul[:, 1]
    j = torch.where(pos, j_pos, j_neg)
    q = torch.where(pos, q_pos, q_neg)
    e10 = torch.where(pos, q_pos, q_neg + e2)

    vr = _mul_shift64(mv, mul_hi, mul_lo, j)
    vp = _mul_shift64(mp, mul_hi, mul_lo, j)
    vm = _mul_shift64(mm, mul_hi, mul_lo, j)

    # trailing-zero bookkeeping (Ryu's step 3b)
    vr_trail = torch.zeros_like(accept)
    vm_trail = torch.zeros_like(accept)
    small_q = pos & (q <= 21)
    mv_div5 = udivmod(mv, 5)[1] == 0
    c1 = small_q & mv_div5
    vr_trail = torch.where(c1, _pow5_factor_ge(mv, q, 23), vr_trail)
    c2 = small_q & ~mv_div5 & accept
    vm_trail = torch.where(c2, _pow5_factor_ge(mm, q, 23), vm_trail)
    c3 = small_q & ~mv_div5 & ~accept
    vp = vp - (c3 & _pow5_factor_ge(mp, q, 23)).to(torch.int64)
    neg_q1 = ~pos & (q <= 1)
    vr_trail = vr_trail | neg_q1
    vm_trail = torch.where(neg_q1 & accept, mm_shift == 1, vm_trail)
    vp = vp - (neg_q1 & ~accept).to(torch.int64)
    neg_q63 = ~pos & (q > 1) & (q < 63)
    vr_trail = torch.where(neg_q63, _multiple_of_pow2(mv, q), vr_trail)

    last = torch.zeros_like(e10)
    removed = torch.zeros_like(e10)
    vr, vm, vm_trail, vr_trail, last, removed = _strip(
        vr, vp, vm, vm_trail, vr_trail, last, removed, 20)
    digits, e10 = _finish(vr, vm, vm_trail, vr_trail, last, removed, accept,
                          e10, is_zero | is_nan | is_inf)
    return digits, e10, sign, is_nan, is_inf, is_zero


# ---------------------------------------------------------------------------
# the f2s core (FLOAT32)
# ---------------------------------------------------------------------------

def _mul_shift32(m, factor, shift):
    """(m x factor) >> shift, m < 2^35, a u64 factor, 32 < shift < 96."""
    bits0 = m * (factor & M32)
    bits1 = m * lsr(factor, 32)
    total = lsr(bits0, 32) + bits1
    s = shift - 32  # a u64 shift in the JAX package: 0 out of [0, 64)
    return torch.where((s >= 0) & (s < 64), lsr(total, s.clamp(0, 63)), 0)


def _ryu_f2s_core(bits):
    """int64 lanes of f32 bit patterns -> the d2s core's tuple, with
    float shortest digits."""
    _, _, inv_tab, pow_tab = _tables(bits.device)
    bits = bits & M32
    sign = (bits >> 31) != 0
    ieee_m = bits & ((1 << 23) - 1)
    ieee_e = (bits >> 23) & 0xFF

    is_nan = (ieee_e == 0xFF) & (ieee_m != 0)
    is_inf = (ieee_e == 0xFF) & (ieee_m == 0)
    is_zero = (ieee_e == 0) & (ieee_m == 0)

    subnormal = ieee_e == 0
    e2 = torch.where(subnormal, 1 - 127 - 23 - 2, ieee_e - 127 - 23 - 2)
    m2 = torch.where(subnormal, ieee_m, ieee_m | (1 << 23))
    accept = (m2 & 1) == 0

    mv = 4 * m2
    mm_shift = ((ieee_m != 0) | (ieee_e <= 1)).to(torch.int64)
    mp = mv + 2
    mm = mv - 1 - mm_shift

    pos = e2 >= 0
    q_pos = ((e2 * 78913) >> 18).clamp(min=0)
    neg_e2 = -e2
    q_neg = ((neg_e2 * 732923) >> 20).clamp(min=0)
    k_pos = _F_POW5_INV_BITS + ((q_pos * 1217359) >> 19)
    j_pos = -e2 + q_pos + k_pos
    i_neg = neg_e2 - q_neg
    k_neg = ((i_neg * 1217359) >> 19) + 1 - _F_POW5_BITS
    j_neg = q_neg - k_neg

    n_inv, n_pow = inv_tab.shape[0], pow_tab.shape[0]
    factor = torch.where(pos, inv_tab[q_pos.clamp(0, n_inv - 1)],
                         pow_tab[i_neg.clamp(0, n_pow - 1)])
    j = torch.where(pos, j_pos, j_neg)
    q = torch.where(pos, q_pos, q_neg)
    e10 = torch.where(pos, q_pos, q_neg + e2)

    vr = _mul_shift32(mv, factor, j)
    vp = _mul_shift32(mp, factor, j)
    vm = _mul_shift32(mm, factor, j)

    # the last removed digit, early, for the rare boundary case
    need_early = (q != 0) & ~ult(udivmod(vm, 10)[0], udivmod(vp - 1, 10)[0])
    qm1 = (q_pos - 1).clamp(0, n_inv - 1)
    l_pos = _F_POW5_INV_BITS + ((qm1 * 1217359) >> 19)
    # shifts clamped into mulShift32's range; the lanes out of it are
    # masked by need_early
    sh_pos = (-e2 + q_pos - 1 + l_pos).clamp(33, 95)
    early_pos = udivmod(_mul_shift32(mv, inv_tab[qm1], sh_pos), 10)[1]
    ip1 = (i_neg + 1).clamp(0, n_pow - 1)
    j2 = (q_neg - 1 - (((ip1 * 1217359) >> 19) + 1 - _F_POW5_BITS)).clamp(
        33, 95)
    early_neg = udivmod(_mul_shift32(mv, pow_tab[ip1], j2), 10)[1]
    last = torch.where(need_early, torch.where(pos, early_pos, early_neg), 0)

    vr_trail = torch.zeros_like(accept)
    vm_trail = torch.zeros_like(accept)
    small_q = pos & (q <= 9)
    mv_div5 = udivmod(mv, 5)[1] == 0
    c1 = small_q & mv_div5
    vr_trail = torch.where(c1, _pow5_factor_ge(mv, q, 11), vr_trail)
    c2 = small_q & ~mv_div5 & accept
    vm_trail = torch.where(c2, _pow5_factor_ge(mm, q, 11), vm_trail)
    c3 = small_q & ~mv_div5 & ~accept
    vp = vp - (c3 & _pow5_factor_ge(mp, q, 11)).to(torch.int64)
    neg_q1 = ~pos & (q <= 1)
    vr_trail = vr_trail | neg_q1
    vm_trail = torch.where(neg_q1 & accept, mm_shift == 1, vm_trail)
    vp = vp - (neg_q1 & ~accept).to(torch.int64)
    neg_q31 = ~pos & (q > 1) & (q < 31)
    vr_trail = torch.where(neg_q31, _multiple_of_pow2(mv, q - 1), vr_trail)

    removed = torch.zeros_like(e10)
    vr, vm, vm_trail, vr_trail, last, removed = _strip(
        vr, vp, vm, vm_trail, vr_trail, last, removed, 11)
    digits, e10 = _finish(vr, vm, vm_trail, vr_trail, last, removed, accept,
                          e10, is_zero | is_nan | is_inf)
    return digits, e10, sign, is_nan, is_inf, is_zero


# ---------------------------------------------------------------------------
# Java's layout
# ---------------------------------------------------------------------------

_MAX_DIGITS = 17  # the longest shortest form of a double
_W = 28           # '-' + digits, zeros and point + 'E-xxx'
_CHUNK = 1 << 22  # rows laid out at a time: the [rows, 28] index tensors
_POW10 = [10 ** k for k in range(_MAX_DIGITS - 1, -1, -1)]


def _digit_chars(digits: torch.Tensor):
    """(right-aligned ascii digits [n, 17], digit counts [n])."""
    pows = torch.tensor(_POW10, dtype=torch.int64, device=digits.device)
    dmat = torch.remainder(digits[:, None] // pows, 10).to(torch.uint8)
    nz = dmat != 0
    first = torch.where(nz.any(dim=1), torch.argmax(nz.to(torch.uint8),
                                                    dim=1), _MAX_DIGITS - 1)
    return dmat + ord("0"), _MAX_DIGITS - first


def _layout(digits, e10, sign, is_nan, is_inf, is_zero):
    """Java toString bytes of one chunk of Ryu outputs: (uint8 [n, 28],
    lengths int64 [n])."""
    dev = digits.device
    dmat, k = _digit_chars(digits)
    adj = e10 + k - 1
    neg = sign.to(torch.int64)

    def dig(J):  # the J-th most significant digit character, J in [0, k)
        idx = (_MAX_DIGITS - k[:, None] + J).clamp(0, _MAX_DIGITS - 1)
        return dmat.gather(1, idx)

    J = torch.arange(_W, device=dev)[None, :] - neg[:, None]
    DJ = dig(J.clamp(0, _W - 1))
    DJm1 = dig((J - 1).clamp(0, _W - 1))
    kc, adjc = k[:, None], adj[:, None]
    ZERO, POINT, E, DASH = ord("0"), ord("."), ord("E"), ord("-")
    u8 = torch.uint8

    def pick(*pairs):  # nested where: (cond, value)..., default last
        out = pairs[-1]
        for cond, v in reversed(pairs[:-1]):
            out = torch.where(cond, v, out)
        return out

    # plain, adj >= k-1: the digits, zeros up to adj, ".0"
    p1 = pick((J < kc, DJ), (J <= adjc, ZERO), (J == adjc + 1, POINT),
              (J == adjc + 2, ZERO), torch.zeros((), dtype=u8, device=dev))
    len1 = adj + 3
    # plain, 0 <= adj < k-1: the point after adj+1 digits
    p2 = pick((J <= adjc, DJ), (J == adjc + 1, POINT), (J <= kc, DJm1),
              torch.zeros((), dtype=u8, device=dev))
    len2 = k + 1
    # plain, adj < 0: "0." + zeros + digits
    z = (-adj - 1).clamp(min=0)
    zc = z[:, None]
    p3 = pick((J == 0, ZERO), (J == 1, POINT), (J < 2 + zc, ZERO),
              (J < 2 + zc + kc, dig((J - 2 - zc).clamp(0, _W - 1))),
              torch.zeros((), dtype=u8, device=dev))
    len3 = 2 + z + k

    # scientific: d '.' rest 'E' [-] exponent digits; rest "0" when k == 1
    a = adj.abs()
    endig = torch.where(a >= 100, 3, torch.where(a >= 10, 2, 1))
    eneg = adj < 0
    m = torch.where(k > 1, k + 1, 3)  # the position of 'E'
    mc = m[:, None]
    T = J - mc - 1
    dposc = T - eneg[:, None].to(torch.int64)
    epow = torch.pow(10, (endig[:, None] - 1 - dposc).clamp(0, 3))
    echar = (ZERO + torch.remainder(a[:, None] // epow, 10)).to(u8)
    evalid = (dposc >= 0) & (dposc < endig[:, None])
    epart = pick(((T == 0) & eneg[:, None], DASH), (evalid, echar),
                 torch.zeros((), dtype=u8, device=dev))
    ps = pick((J == 0, dig(torch.zeros_like(J))), (J == 1, POINT),
              ((J == 2) & (kc == 1), ZERO), ((J > 1) & (J < kc + 1), DJm1),
              (J == mc, E), epart)
    lens = m + 1 + eneg.to(torch.int64) + endig

    plain = (adj >= -3) & (adj < 7)
    c1 = plain & (adj >= k - 1)
    c2 = plain & (adj >= 0)
    body = pick((c1[:, None], p1), (c2[:, None], p2), (plain[:, None], p3),
                ps)
    lengths = pick((c1, len1), (c2, len2), (plain, len3), lens)
    out = torch.where(J == -1, torch.tensor(DASH, dtype=u8, device=dev),
                      body)
    lengths = lengths + neg

    # the specials replace whole rows
    for mask, text in ((is_nan, b"NaN"), (is_inf & ~sign, b"Infinity"),
                       (is_inf & sign, b"-Infinity"),
                       (is_zero & ~sign, b"0.0"), (is_zero & sign, b"-0.0")):
        row = torch.zeros(_W, dtype=u8, device=dev)
        row[:len(text)] = torch.tensor(list(text), dtype=u8, device=dev)
        out = torch.where(mask[:, None], row, out)
        lengths = torch.where(mask, len(text), lengths)
    return out, lengths


def _format_java(digits, e10, sign, is_nan, is_inf, is_zero):
    """Java toString bytes of every row: (uint8 [n, 28], lengths [n]),
    laid out ``_CHUNK`` rows at a time on the device."""
    n = digits.shape[0]
    mat = torch.empty((n, _W), dtype=torch.uint8, device=digits.device)
    lengths = torch.empty(n, dtype=torch.int64, device=digits.device)
    for r0 in range(0, n, _CHUNK):
        r1 = min(n, r0 + _CHUNK)
        mat[r0:r1], lengths[r0:r1] = _layout(
            *(t[r0:r1] for t in (digits, e10, sign, is_nan, is_inf,
                                 is_zero)))
    return mat, lengths


def _ryu_core_for(col: Column):
    if col.dtype.id is dt.TypeId.FLOAT64:
        return _ryu_d2s_core(col.data.contiguous().view(torch.int64))
    if col.dtype.id is dt.TypeId.FLOAT32:
        return _ryu_f2s_core(col.data.contiguous().view(torch.int32).to(
            torch.int64))
    raise TypeError(f"float->string: unsupported dtype {col.dtype}")


def float_to_string(col: Column) -> Column:
    """Spark ``cast(float/double as string)`` with Java toString semantics
    (reference float_to_string, cast_float_to_string.cu:109)."""
    mat, lengths = _format_java(*_ryu_core_for(col))
    return from_padded_bytes(mat, lengths, col.validity)


def format_number(col: Column, d: int) -> Column:
    """Spark ``format_number(x, d)``: ``d`` fixed decimals, ',' thousands
    grouping, HALF_EVEN rounding of the shortest decimal form (Java
    DecimalFormat). Per-row host code over one read of the Ryu core's
    outputs, as in the JAX package (reference format_float.cu:111)."""
    digits, e10, sign, is_nan, is_inf, is_zero = (
        t.cpu().numpy() for t in _ryu_core_for(col))
    parts = []
    for i in range(digits.shape[0]):
        if is_nan[i]:
            parts.append(b"NaN")
            continue
        if is_inf[i]:
            parts.append(b"-\xe2\x88\x9e" if sign[i] else b"\xe2\x88\x9e")
            continue
        if is_zero[i]:
            scaled = 0
        else:
            # digits x 10^e10 rounded at d decimals, HALF_EVEN
            v = int(digits[i])
            shift = int(e10[i]) + d
            if shift >= 0:
                scaled = v * (10 ** shift)
            else:
                q, r = divmod(v, 10 ** (-shift))
                half = 5 * 10 ** (-shift - 1)
                if r > half or (r == half and (q & 1)):
                    q += 1
                scaled = q
        int_part, frac_part = divmod(scaled, 10 ** d) if d > 0 else (scaled,
                                                                     0)
        body = f"{int_part:,d}" + (f".{frac_part:0{d}d}" if d > 0 else "")
        # DecimalFormat signs from the input (-0.0 and negatives that
        # round to zero too), not from the rounded result
        if sign[i]:
            body = "-" + body
        parts.append(body.encode())
    validity = None if col.validity is None else col.validity.cpu().numpy()
    return pack_byte_rows(parts, validity, device=col.device)
