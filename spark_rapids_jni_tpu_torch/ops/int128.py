"""Two's-complement 128-bit integer math on 32-bit limbs, in torch ops
(the JAX package's ops/int128.py).

A DECIMAL128 column stores ``int32[n, 4]`` little-endian limbs
(columnar/column.py). The math here runs on *lanes*: ``int64[..., 4]``
tensors holding each limb's unsigned value in [0, 2^32), so sums and
32 x 32-bit products of limbs never overflow an int64 (torch has no
unsigned 64-bit arithmetic). ``lanes`` and ``storage`` convert between
the two. A u64 value is held as the int64 of the same bits: products wrap
as u64 does, and a logical right shift is ``_lsr``.
"""

from __future__ import annotations

import numpy as np
import torch

from .hashing import _lsr, _s64

NLIMBS = 4
M32 = 0xFFFFFFFF
_MASK128 = (1 << 128) - 1


def lanes(data: torch.Tensor) -> torch.Tensor:
    """int32[..., k] limb storage -> int64[..., k] unsigned limb lanes."""
    return data.to(torch.int64) & M32


def storage(limbs: torch.Tensor) -> torch.Tensor:
    """int64[..., k] limb lanes -> int32[..., k] storage (same bits)."""
    return (limbs & M32).to(torch.int32)


def words(data: torch.Tensor) -> torch.Tensor:
    """int32[n, 4] limb storage -> int64[n, 2]: the low and the high 64
    bits of each value."""
    return data.contiguous().view(torch.int64)


def take_words(data: torch.Tensor, idx: torch.Tensor):
    """(low, high) int64 words of rows ``idx`` of int32[n, 4] limbs: two
    1-D gathers (an index_select of [n, 4] rows is many times slower on
    the card)."""
    w = words(data)
    return w[:, 0].index_select(0, idx), w[:, 1].index_select(0, idx)


def take_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of int32[n, 4] limbs (``take_words`` joined)."""
    return torch.stack(take_words(data, idx), dim=1).view(torch.int32)


def umul128(a: torch.Tensor, b: torch.Tensor):
    """u64 x u64 -> (hi, lo), u64 bits in int64, via 32-bit limb
    products."""
    a_lo, a_hi = a & M32, _lsr(a, 32)
    b_lo, b_hi = b & M32, _lsr(b, 32)
    ll = a_lo * b_lo  # up to 2^64 - 2^33 + 1: wraps; read by _lsr
    hl = a_hi * b_lo
    lh = a_lo * b_hi
    hh = a_hi * b_hi
    cross = _lsr(ll, 32) + (hl & M32) + (lh & M32)
    lo = (cross << 32) | (ll & M32)
    hi = hh + _lsr(hl, 32) + _lsr(lh, 32) + _lsr(cross, 32)
    return hi, lo


_SIGN64 = -(1 << 63)
_MAX63 = (1 << 63) - 1
s64 = _s64  # a u64 constant as the int64 of the same bits


def ult(a, b) -> torch.Tensor:
    """a < b for u64 bits held in int64 (tensors or constants from
    ``s64``): flipping the sign bit turns unsigned order into signed."""
    return (a ^ _SIGN64) < (b ^ _SIGN64)


def lsr(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of u64 bits in int64 by a tensor (or int) of
    shift counts in [0, 64]."""
    if not isinstance(s, torch.Tensor):
        s = torch.tensor(s, dtype=torch.int64, device=x.device)
    return torch.where(s == 0, x, ((x >> 1) & _MAX63) >> (s - 1).clamp(min=0))


def udivmod(x: torch.Tensor, d):
    """(x // d, x % d) of u64 bits in int64 by a divisor 0 < d < 2^63 (a
    tensor or an int): the top bit dropped, then one correction step.
    x = 2h + b with h < 2^63, so x - 2(h // d)d = 2(h % d) + b < 2d. An
    even int divisor needs no correction (x // d = h // (d / 2)), and an
    int divisor under 2^62 keeps 2d in int64's range (a signed compare)."""
    h = (x >> 1) & _MAX63
    if isinstance(d, int) and d % 2 == 0:
        q = h // (d >> 1)
        return q, x - q * d
    q = (h // d) << 1
    r = x - q * d
    over = (r >= d) if isinstance(d, int) and d < 1 << 62 else ~ult(r, d)
    return q + over.to(torch.int64), torch.where(over, r - d, r)


def limbs_const(value: int, nlimbs: int = NLIMBS) -> np.ndarray:
    """A Python int as ``nlimbs`` unsigned 32-bit limb values (int64)."""
    v = value & ((1 << (32 * nlimbs)) - 1)
    return np.array([(v >> (32 * i)) & M32 for i in range(nlimbs)],
                    dtype=np.int64)


def from_int_py(value: int, n: int, device="cpu") -> torch.Tensor:
    """A Python int broadcast to n rows of lanes."""
    return torch.from_numpy(limbs_const(value)).to(device).expand(
        n, NLIMBS).clone()


def zeros(n: int, device="cpu") -> torch.Tensor:
    return torch.zeros((n, NLIMBS), dtype=torch.int64, device=device)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def is_negative(a: torch.Tensor) -> torch.Tensor:
    return (a[..., -1] >> 31) != 0


def _carry(limbs) -> torch.Tensor:
    """Stack per-limb sums, propagating carries (or borrows) upward."""
    out = []
    carry = 0
    for x in limbs:
        s = x + carry
        out.append(s & M32)
        carry = s >> 32  # arithmetic: a borrow propagates as -1
    return torch.stack(out, dim=-1)


def negate(a: torch.Tensor) -> torch.Tensor:
    """Two's-complement negation (~a + 1)."""
    inv = (~a) & M32
    return _carry([inv[..., 0] + 1] + [inv[..., i]
                                       for i in range(1, a.shape[-1])])


def abs_(a: torch.Tensor) -> torch.Tensor:
    return torch.where(is_negative(a)[..., None], negate(a), a)


def mul10(a: torch.Tensor) -> torch.Tensor:
    """a * 10 mod 2^128 (two's-complement signed values too)."""
    return _carry([a[..., i] * 10 for i in range(a.shape[-1])])


def add_small(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """a + d for an int32/int64 vector d, sign-extended to 128 bits."""
    d64 = d.to(torch.int64)
    ext = torch.where(d64 < 0, M32, 0)
    dl = [d64 & M32, _lsr(d64, 32), ext, ext]
    return _carry([a[..., i] + dl[i] for i in range(NLIMBS)])


def _flip_top(a: torch.Tensor) -> torch.Tensor:
    """XOR the sign bit so signed order becomes unsigned order."""
    out = a.clone()
    out[..., -1] ^= 0x80000000
    return out


def lt_unsigned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as unsigned: the most significant differing limb decides
    (its +-2^i outweighs every lower limb's)."""
    w = 1 << torch.arange(a.shape[-1], device=a.device)
    votes = ((a > b).to(torch.int64) - (a < b).to(torch.int64)) * w
    return votes.sum(dim=-1) < 0


def lt_signed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return lt_unsigned(_flip_top(a), _flip_top(b))


def gt_signed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return lt_signed(b, a)


_POW10_TABLE = np.stack([limbs_const(10 ** k) for k in range(39)])


def ndigits(a: torch.Tensor) -> torch.Tensor:
    """Decimal digit count of |a| (0 for a == 0), the reference's
    count_digits."""
    mag = abs_(a)
    table = torch.from_numpy(_POW10_TABLE).to(a.device)
    count = torch.zeros(a.shape[:-1], dtype=torch.int32, device=a.device)
    for k in range(39):
        count += (~lt_unsigned(mag, table[k].expand_as(mag))).to(
            torch.int32)
    return count


def to_int64(a: torch.Tensor) -> torch.Tensor:
    """The low 64 bits as int64 (the value when it fits)."""
    return a[..., 0] | (a[..., 1] << 32)


def from_int64(v: torch.Tensor) -> torch.Tensor:
    """Sign-extend an int64 vector to [..., 4] lanes."""
    v = v.to(torch.int64)
    ext = torch.where(v < 0, M32, 0)
    return torch.stack([v & M32, _lsr(v, 32), ext, ext], dim=-1)
