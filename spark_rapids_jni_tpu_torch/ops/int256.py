"""Two's-complement 256-bit integer math on 32-bit limbs, in torch ops
(the JAX package's ops/int256.py, the reference's ``chunked256``,
decimal_utils.cu:32-118).

A 256-bit row value is ``int64[n, 8]`` lanes, little-endian, each holding
an unsigned 32-bit limb (ops/int128.py explains the lanes). Every
operation runs across all rows at once. This module is the plain version
of kernel H2 (csrc/decimal128.cu): it is what ops/decimal128.py computes
on the CPU, and what chip_smoke.py holds H2 against on the card. The
division is the JAX package's binary long division, one Python step per
bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import int128 as i128
from .int128 import M32, _carry

NLIMBS = 8


def from_int_py(value: int, n: int = 1, device="cpu") -> torch.Tensor:
    """A Python int broadcast to n rows of 256-bit lanes."""
    row = torch.from_numpy(i128.limbs_const(value, NLIMBS)).to(device)
    return row.expand(n, NLIMBS).clone()


def to_int_py(limbs: torch.Tensor) -> list:
    """Lanes -> signed Python ints (host/debug path)."""
    out = []
    for row in limbs.cpu().tolist():
        v = sum((x & M32) << (32 * i) for i, x in enumerate(row))
        out.append(v - (1 << 256) if v >> 255 else v)
    return out


def from_i128_limbs(limbs4: torch.Tensor) -> torch.Tensor:
    """Sign-extend int32[n, 4] DECIMAL128 storage to 256-bit lanes."""
    lo = i128.lanes(limbs4)
    ext = torch.where(lo[:, 3:4] >> 31 != 0, M32, 0).expand(-1, 4)
    return torch.cat([lo, ext], dim=1)


def to_i128_limbs(limbs: torch.Tensor) -> torch.Tensor:
    """The low 128 bits as int32[n, 4] DECIMAL128 storage."""
    return i128.storage(limbs[:, :4])


def sign_neg(limbs: torch.Tensor) -> torch.Tensor:
    """bool[n]: the 256-bit value is negative."""
    return (limbs[:, NLIMBS - 1] >> 31) != 0


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod 2^256."""
    return _carry([a[:, i] + b[:, i] for i in range(NLIMBS)])


def add_small(a: torch.Tensor, v) -> torch.Tensor:
    """a + v for an int32[n] vector or a scalar v, sign-extended."""
    v = torch.as_tensor(v, dtype=torch.int64, device=a.device).expand(
        a.shape[0])
    ext = torch.where(v < 0, M32, 0)
    return _carry([a[:, 0] + (v & M32)]
                  + [a[:, i] + ext for i in range(1, NLIMBS)])


def negate(a: torch.Tensor) -> torch.Tensor:
    return i128.negate(a)


def abs_(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(|a|, was_negative)."""
    neg = sign_neg(a)
    return torch.where(neg[:, None], negate(a), a), neg


def lt_unsigned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool[n]: a < b as unsigned 256-bit values."""
    return i128.lt_unsigned(a, b)


def gte_unsigned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ~lt_unsigned(a, b)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=1)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2^256: schoolbook over 32-bit limbs (decimal_utils.cu:127).
    A limb product is below 2^64 but may pass 2^63: its low half is a
    mask, its high half a logical shift of the wrapped int64."""
    out = []
    carry = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    rb = b.flip(1)  # rb[:, 7 - j] = b[:, j]
    for col in range(NLIMBS):
        p = a[:, :col + 1] * rb[:, NLIMBS - 1 - col:]
        acc = carry + (p & M32).sum(dim=1)
        hi = ((p >> 32) & M32).sum(dim=1)
        out.append(acc & M32)
        carry = (acc >> 32) + hi
    return torch.stack(out, dim=1)


def shift_left_1(a: torch.Tensor) -> torch.Tensor:
    """a << 1 mod 2^256."""
    up = torch.nn.functional.pad(a[:, :-1] >> 31, (1, 0))
    return ((a << 1) & M32) | up


def sub_unsigned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod 2^256."""
    return _carry([a[:, i] - b[:, i] for i in range(NLIMBS)])


def divmod_unsigned(n_limbs: torch.Tensor, d_limbs: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary long division of unsigned n by unsigned d
    (decimal_utils.cu:149-169): 256 shift-compare-subtract steps, from
    the top bit down. Where d == 0 every step subtracts nothing: the
    quotient is all ones and the remainder n, as in the JAX package.
    Returns (quotient, remainder) lanes."""
    rows = n_limbs.shape[0]
    q = torch.zeros((rows, NLIMBS), dtype=torch.int64,
                    device=n_limbs.device)
    r = torch.zeros_like(q)
    for i in range(255, -1, -1):
        block, bit = divmod(i, 32)
        r = shift_left_1(r)
        r[:, 0] |= (n_limbs[:, block] >> bit) & 1
        ge = gte_unsigned(r, d_limbs)
        r = torch.where(ge[:, None], sub_unsigned(r, d_limbs), r)
        q[:, block] |= ge.to(torch.int64) << bit
    return q, r


def divmod_signed(n_limbs: torch.Tensor, d_limbs: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncating signed division: the quotient's sign is the xor of the
    signs, the remainder takes n's (decimal_utils.cu:171-191)."""
    abs_n, n_neg = abs_(n_limbs)
    abs_d, d_neg = abs_(d_limbs)
    q, r = divmod_unsigned(abs_n, abs_d)
    q = torch.where((n_neg ^ d_neg)[:, None], negate(q), q)
    r = torch.where(n_neg[:, None], negate(r), r)
    return q, r
