"""Decimal -> binary float bit patterns, correctly rounded, in u64 integer
torch ops (the JAX package's ops/float_bits.py).

``decimal_to_f64_bits`` and ``decimal_to_f32_bits`` map ``±digits x
10^exp10`` (u64 digits) to IEEE-754 bit patterns by the Eisel-Lemire
assembly: one product of the digits, normalized, with a 192-bit
fixed-point mantissa of 10^q from a table (q in [-342, 308]), then
round-to-nearest-even on the product's top bits. The full 256-bit product
and an exact route for ties (digits divisible by 5^|q|, q in [-27, -1])
make the result correctly rounded for every u64 digits and q, with no
slow-path fallback. FLOAT32 is rounded ONCE from the decimal value, as
Java's ``Float.parseFloat`` (Spark on the CPU) does, not through an f64
(the CUDA reference's double rounding).

The contract is the JAX package's, bit for bit; the emulation is not
carried over. The JAX package also emulates f64 on a chip without it:
its double-double helpers ``_exp2i``, ``_dd_to_u53``, ``_u53_to_dd``,
``_f64_bits_arith`` and ``_f64_from_bits_arith`` exist only for that, and
are not ported. Hopper has exact f64, so ``f64_value_from_bits`` and
``f64_bits_from_value`` are ``view`` casts (the port stores FLOAT64 as
float64; columnar/dtype.py).

A u64 is held as the int64 of the same bits (ops/int128.py): compares go
through ``int128.ult``, right shifts through ``int128.lsr``, and the
division by 5^k through ``int128.udivmod``. Every function runs on the
device of its inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import int128
from .int128 import lsr, s64, udivmod, ult, umul128

_Q_MIN, _Q_MAX = -342, 308


def _build_pow10_table():
    """192-bit fixed-point mantissas m and binary exponents e2 with
    10^q = (m / 2^191) 2^e2, m in [2^191, 2^192): exact for q in [0, 82],
    truncated above, rounded up (the reciprocal) for q < 0. Derived from
    Python integers, as in the JAX package."""
    n = _Q_MAX - _Q_MIN + 1
    hi, mid, lo = (np.empty(n, np.uint64) for _ in range(3))
    e2 = np.empty(n, np.int64)
    for q in range(_Q_MIN, _Q_MAX + 1):
        if q >= 0:
            p = 5 ** q
            b = p.bit_length()
            m = p << (192 - b) if b <= 192 else p >> (b - 192)
            e = q + b - 1
        else:
            f = 5 ** (-q)
            b = f.bit_length()
            m = (1 << (191 + b)) // f + 1
            e = q - b
        i = q - _Q_MIN
        hi[i] = m >> 128
        mid[i] = (m >> 64) & 0xFFFFFFFFFFFFFFFF
        lo[i] = m & 0xFFFFFFFFFFFFFFFF
        e2[i] = e
    return hi.view(np.int64), mid.view(np.int64), lo.view(np.int64), e2


_POW10 = np.stack(_build_pow10_table(), axis=1)  # [651, 4]: hi mid lo e2
_POW5 = np.array([5 ** k for k in range(28)], np.int64)
_TABLES = {}


def _tables(device):
    """The 10^q table and 5^k powers on ``device`` (copied once)."""
    got = _TABLES.get(device)
    if got is None:
        got = _TABLES[device] = (torch.from_numpy(_POW10).to(device),
                                 torch.from_numpy(_POW5).to(device))
    return got


def _clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of u64 lanes x > 0 (a shift cascade)."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        low = ult(x, s64(1 << (64 - s)))
        x = torch.where(low, x << s, x)
        n = n + low.to(torch.int64) * s
    return n


def _decimal_to_bits(digits, exp10, negative, *, mant_bits: int,
                     exp_bias: int, min_unbiased: int, max_unbiased: int):
    """Shared assembly -> int64 lanes of the bit pattern. ``digits``: u64
    bits in int64 (0 gives a signed zero); ``exp10``: integer lanes."""
    digits = digits.to(torch.int64)
    exp10 = exp10.to(torch.int64)
    pow10, pow5 = _tables(digits.device)

    # exact route for ties: digits / 5^|q| times an exact 2^q
    p5 = pow5[(-exp10).clamp(0, 27)]
    q5, r5 = udivmod(digits, p5)
    rescued = (exp10 < 0) & (exp10 >= -27) & (r5 == 0)
    digits = torch.where(rescued, q5, digits)
    e2_bin = torch.where(rescued, exp10, 0)
    exp10 = torch.where(rescued, 0, exp10)

    entry = pow10[exp10.clamp(_Q_MIN, _Q_MAX) - _Q_MIN]
    m_hi, m_mid, m_lo, e2 = entry.unbind(1)

    safe = torch.where(digits == 0, 1, digits)
    lz = _clz64(safe)
    w = safe << lz

    # the 256-bit product w x (m_hi 2^128 + m_mid 2^64 + m_lo): its top
    # 128 bits (uh, ul); the lower 128 only feed the sticky bit
    h2, l2 = umul128(w, m_hi)
    h1, l1 = umul128(w, m_mid)
    h0, l0 = umul128(w, m_lo)
    limb1 = l1 + h0
    c1 = ult(limb1, l1).to(torch.int64)
    ul = l2 + h1
    c2 = ult(ul, l2).to(torch.int64)
    ul = ul + c1
    c2 = c2 + ult(ul, c1).to(torch.int64)
    uh = h2 + c2

    msb = lsr(uh, 63)  # the product's top bit: 255 or 254
    win_shift = 63 - (mant_bits + 2) + msb
    window = lsr(uh, win_shift)
    dropped = uh & ((1 << win_shift) - 1)
    sticky = (dropped != 0) | (ul != 0) | (limb1 != 0) | (l0 != 0)

    e_lead = e2 - lz + 63 + msb + e2_bin

    # rounding shift: 1 for normals, more for subnormals (the whole window
    # may shift out -> +-0)
    normal = e_lead >= min_unbiased
    r = torch.where(normal, 1, min_unbiased - e_lead + 1).clamp(
        1, mant_bits + 3)
    kept = window >> r
    round_bit = (window >> (r - 1)) & 1
    below = window & ((1 << (r - 1)) - 1)
    sticky = sticky | (below != 0)
    inc = (round_bit == 1) & (sticky | ((kept & 1) == 1))
    kept = kept + inc.to(torch.int64)

    eterm = torch.where(normal, e_lead + exp_bias - 1, 0)
    bits = (eterm << mant_bits) + kept

    inf_bits = (2 * exp_bias + 1) << mant_bits
    bits = torch.where(e_lead > max_unbiased, inf_bits, bits)
    # beyond the table the true value is infinite or under half the
    # smallest subnormal for every u64 digits
    bits = torch.where(exp10 > _Q_MAX, inf_bits, bits)
    bits = torch.where(exp10 < _Q_MIN, 0, bits)
    bits = torch.where(digits == 0, 0, bits)
    sign = s64(1 << 63) if mant_bits == 52 else 1 << 31
    return bits | torch.where(negative.to(torch.bool), sign, 0)


def decimal_to_f64_bits(digits, exp10, negative) -> torch.Tensor:
    """int64 lanes of the binary64 bit patterns of +-digits x 10^exp10."""
    return _decimal_to_bits(digits, exp10, negative, mant_bits=52,
                            exp_bias=1023, min_unbiased=-1022,
                            max_unbiased=1023)


def decimal_to_f32_bits(digits, exp10, negative) -> torch.Tensor:
    """int64 lanes holding binary32 bit patterns (the low 32 bits)."""
    return _decimal_to_bits(digits, exp10, negative, mant_bits=23,
                            exp_bias=127, min_unbiased=-126,
                            max_unbiased=127)


def f64_value_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """FLOAT64 values from their bit patterns (a view, every bit kept)."""
    return bits.to(torch.int64).view(torch.float64)


def f64_bits_from_value(vals: torch.Tensor) -> torch.Tensor:
    """The bit patterns (int64) of FLOAT64 values (a view)."""
    return vals.to(torch.float64).view(torch.int64)


def f32_value_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """FLOAT32 values from int64 lanes whose low 32 bits are the pattern."""
    low = bits & int128.M32
    return (low - ((low >> 31) << 32)).to(torch.int32).view(torch.float32)
