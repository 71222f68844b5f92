"""Spark-exact DECIMAL128 arithmetic with 256-bit intermediates (the JAX
package's ops/decimal128.py; the reference's decimal_utils.cu:
dec128_add_sub :561, dec128_multiplier :657, dec128_divider :744,
dec128_remainder :854, entry points :974-1175).

Each op returns a Table of (overflow BOOL8, result), the result DECIMAL128
(INT64 for ``integer_divide_decimal128``), with the inputs' validity ANDed
onto both. HALF_UP rounding, the SPARK-40129 interim cast of a product to
38 digits (``cast_interim_result``, on by default), the Java-definition
remainder and integer divide's overflow judged on the 128-bit quotient are
the JAX package's. So are its edges: ``precision10`` gives 77 where the
reference gives -1, a zero divisor gives overflow and a zero result, and
a power of ten outside 10^0..10^76 raises ValueError.

Scales: the public API takes Java scales (digits after the point); the
math runs on cudf scales (negated), as the reference writes it.

On a CUDA column every op is one launch of kernel H2 (csrc/decimal128.cu,
``kernels.decimal128_op``). The ``*_plain`` functions below are its plain
version: the JAX package's algorithm line for line in torch ops over
ops/int256's lanes, which is what a CPU column computes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table
from ..columnar.dtype import TypeId
from . import int256 as i256
from . import kernels

# 10^0 .. 10^76 as 256-bit lanes (the reference's pow_ten switch,
# decimal_utils.cu:248-511); H2 keeps the same table in constant memory
_POW10_HOST = torch.stack([i256.from_int_py(10 ** e)[0] for e in range(77)])
_POW10 = {}


def _pow10_table(device) -> torch.Tensor:
    t = _POW10.get(device)
    if t is None:
        t = _POW10[device] = _POW10_HOST.to(device)
    return t


def check_pow10(exps, n: int) -> None:
    """The JAX package's range check of host-known powers of ten (the
    reference asserts, decimal_utils.cu:507-510): only when there are
    rows to scale."""
    if n and any(e < 0 or e > 76 for e in exps):
        raise ValueError("pow10 exponent out of supported range [0, 76]")


def _pow10(exp, n: int, device) -> torch.Tensor:
    """10^exp lanes for n rows: exp an int or a per-row int64 tensor
    (checked on its values, as the JAX package checks its concrete
    arrays)."""
    if isinstance(exp, int):
        check_pow10([exp], n)
        return _pow10_table(device)[exp].expand(n, i256.NLIMBS)
    if n and (int(exp.min()) < 0 or int(exp.max()) > 76):
        raise ValueError("pow10 exponent out of supported range [0, 76]")
    return _pow10_table(device).index_select(0, exp)


def precision10(value: torch.Tensor) -> torch.Tensor:
    """int64[n]: the smallest i with 10^i >= |value|, 77 past 10^76
    (decimal_utils.cu:520-535, where the reference returns -1)."""
    a, _ = i256.abs_(value)
    table = _pow10_table(value.device)
    count = torch.zeros(value.shape[0], dtype=torch.int64,
                        device=value.device)
    for i in range(77):
        count += i256.lt_unsigned(table[i].expand_as(a), a).to(torch.int64)
    return count


def _is_greater_than_decimal_38(a: torch.Tensor) -> torch.Tensor:
    """|a| >= 10^38 (decimal_utils.cu:537-542)."""
    absa, _ = i256.abs_(a)
    return i256.gte_unsigned(absa, _pow10_table(a.device)[38].expand_as(a))


def _round_from_remainder(q, abs_r, n_neg, d_neg, abs_d):
    """HALF_UP: one away from zero when 2|r| >= |d| (decimal_utils.cu:
    193-225, in exact limb math)."""
    need_inc = i256.gte_unsigned(i256.shift_left_1(abs_r), abs_d)
    inc = torch.where(need_inc, torch.where(n_neg ^ d_neg, -1, 1), 0)
    return i256.add_small(q, inc)


def _divide_and_round(n, d):
    """n / d, HALF_UP (decimal_utils.cu:230-235)."""
    abs_n, n_neg = i256.abs_(n)
    abs_d, d_neg = i256.abs_(d)
    q, r = i256.divmod_unsigned(abs_n, abs_d)
    q = torch.where((n_neg ^ d_neg)[:, None], i256.negate(q), q)
    return _round_from_remainder(q, r, n_neg, d_neg, abs_d)


def _integer_divide(n, d):
    """Truncating division (decimal_utils.cu:241-246)."""
    return i256.divmod_signed(n, d)[0]


def _set_scale_and_round(data, old_c: int, new_c: int):
    """Rescale between cudf scales (decimal_utils.cu:544-558)."""
    if old_c == new_c:
        return data
    n = data.shape[0]
    if new_c < old_c:
        return i256.multiply(data, _pow10(old_c - new_c, n, data.device))
    return _divide_and_round(data, _pow10(new_c - old_c, n, data.device))


def _guard_zero(b8):
    """(divisor with zero rows replaced by 1, the zero rows)."""
    d_zero = i256.is_zero(b8)
    one = _pow10_table(b8.device)[0].expand_as(b8)
    return torch.where(d_zero[:, None], one, b8), d_zero


# ---------------------------------------------------------------------------
# the plain version of H2: (overflow bool[n], 256-bit result lanes)
# ---------------------------------------------------------------------------

def add_sub_plain(a8, b8, a_c: int, b_c: int, res_c: int, sub: bool):
    """decimal_utils.cu:561-654: both to the finer scale, add, then to the
    target scale with rounding; overflow where |result| >= 10^38."""
    inter_c = min(a_c, b_c)
    a8 = _set_scale_and_round(a8, a_c, inter_c)
    b8 = _set_scale_and_round(b8, b_c, inter_c)
    if sub:
        b8 = i256.negate(b8)
    s = _set_scale_and_round(i256.add(a8, b8), inter_c, res_c)
    return _is_greater_than_decimal_38(s), s


def check_scale_divisor(source_c: int, target_c: int) -> None:
    if target_c - source_c > 38:
        raise ValueError("divisor too big")


def multiply_plain(a8, b8, a_c: int, b_c: int, prod_c: int,
                   cast_interim_result: bool = True):
    """decimal_utils.cu:656-735 + :974-1008."""
    n = a8.shape[0]
    dev = a8.device
    check_scale_divisor(a_c + b_c, prod_c)
    product = i256.multiply(a8, b8)
    if cast_interim_result:
        fdp = (precision10(product) - 38).clamp(min=0)
        product = torch.where((fdp > 0)[:, None], _divide_and_round(
            product, _pow10(fdp, n, dev)), product)
        mult_scale = a_c + b_c + fdp
    else:
        mult_scale = torch.full((n,), a_c + b_c, dtype=torch.int64,
                                device=dev)
    exponent = prod_c - mult_scale
    new_precision = precision10(product)
    overflow_pre = (exponent < 0) & (new_precision - exponent > 38)
    product = i256.multiply(product, _pow10((-exponent).clamp(min=0), n,
                                            dev))
    pos_e = exponent.clamp(min=0)
    product = torch.where((pos_e > 0)[:, None], _divide_and_round(
        product, _pow10(pos_e, n, dev)), product)
    return overflow_pre | _is_greater_than_decimal_38(product), product


def divide_plain(a8, b8, a_c: int, b_c: int, quot_c: int,
                 is_int_div: bool):
    """decimal_utils.cu:743-852; ``is_int_div`` truncates (Spark's
    ``div``)."""
    n = a8.shape[0]
    dev = a8.device
    d, d_zero = _guard_zero(b8)
    n_shift_exp = quot_c - (a_c - b_c)
    if n_shift_exp > 0:
        # divide first, then shift the scale down with rounding
        q1 = i256.divmod_signed(a8, d)[0]
        divisor = _pow10(n_shift_exp, n, dev)
        result = (_integer_divide(q1, divisor) if is_int_div
                  else _divide_and_round(q1, divisor))
    elif n_shift_exp < -38:
        # two-step base-10 long division (decimal_utils.cu:796-826)
        n2 = i256.multiply(a8, _pow10_table(dev)[38].expand_as(a8))
        q1, r1 = i256.divmod_signed(n2, d)
        remaining = _pow10(-n_shift_exp - 38, n, dev)
        result = i256.multiply(q1, remaining)
        scaled_r = i256.multiply(r1, remaining)
        q2, r2 = i256.divmod_signed(scaled_r, d)
        result = i256.add(result, q2)
        if not is_int_div:
            abs_d, d_neg = i256.abs_(d)
            abs_r2, _ = i256.abs_(r2)
            result = _round_from_remainder(result, abs_r2,
                                           i256.sign_neg(scaled_r), d_neg,
                                           abs_d)
    else:
        nn = a8
        if n_shift_exp < 0:
            nn = i256.multiply(nn, _pow10(-n_shift_exp, n, dev))
        result = (_integer_divide(nn, d) if is_int_div
                  else _divide_and_round(nn, d))
    overflow = _is_greater_than_decimal_38(result) | d_zero
    return overflow, torch.where(d_zero[:, None], 0, result)


def remainder_plain(a8, b8, a_c: int, b_c: int, rem_c: int):
    """Java-definition remainder a - (a // b) * b at the requested scale
    (decimal_utils.cu:854-968)."""
    n = a8.shape[0]
    dev = a8.device
    d, d_zero = _guard_zero(b8)
    d_shift_exp = rem_c - b_c
    n_shift_exp = rem_c - a_c
    abs_d, _ = i256.abs_(d)
    if d_shift_exp > 0:
        abs_d = _divide_and_round(abs_d, _pow10(d_shift_exp, n, dev))
    else:
        n_shift_exp -= d_shift_exp
    abs_n, n_neg = i256.abs_(a8)
    if n_shift_exp > 0:
        q1 = i256.divmod_unsigned(abs_n, abs_d)[0]
        int_div = _integer_divide(q1, _pow10(n_shift_exp, n, dev))
    else:
        if n_shift_exp < 0:
            abs_n = i256.multiply(abs_n, _pow10(-n_shift_exp, n, dev))
        int_div = i256.divmod_unsigned(abs_n, abs_d)[0]
    less_n = i256.multiply(int_div, abs_d)
    if d_shift_exp < 0:
        less_n = i256.multiply(less_n, _pow10(-d_shift_exp, n, dev))
    res = i256.add(abs_n, i256.negate(less_n))
    overflow = _is_greater_than_decimal_38(res) | d_zero
    res = torch.where(n_neg[:, None], i256.negate(res), res)
    return overflow, torch.where(d_zero[:, None], 0, res)


# H2's operation codes (csrc/decimal128.cu enum Op)
OPS = {"add": 0, "sub": 1, "multiply": 2, "divide": 3,
       "integer_divide": 4, "remainder": 5}


def op_plain(op: str, a: torch.Tensor, b: torch.Tensor, a_c: int, b_c: int,
             out_c: int, cast_interim_result: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of H2 on int32[n, 4] limbs and cudf scales:
    (overflow bool[n], result int32[n, 4], or int64[n] for
    integer_divide)."""
    a8, b8 = i256.from_i128_limbs(a), i256.from_i128_limbs(b)
    if op in ("add", "sub"):
        over, res = add_sub_plain(a8, b8, a_c, b_c, out_c, op == "sub")
    elif op == "multiply":
        over, res = multiply_plain(a8, b8, a_c, b_c, out_c,
                                   cast_interim_result)
    elif op in ("divide", "integer_divide"):
        over, res = divide_plain(a8, b8, a_c, b_c, out_c,
                                 op == "integer_divide")
    elif op == "remainder":
        over, res = remainder_plain(a8, b8, a_c, b_c, out_c)
    else:
        raise ValueError(f"unknown decimal op {op!r}")
    if op == "integer_divide":
        return over, res[:, 0] | (res[:, 1] << 32)
    return over, i256.to_i128_limbs(res)


def host_checks(op: str, a_c: int, b_c: int, out_c: int, n: int,
                cast_interim_result: bool = True) -> bool:
    """The ValueErrors the plain version raises before it looks at a
    value, for the kernel's wrapper. Returns whether a row's value can
    still need a power of ten past 10^76 (multiply's rescale after the
    interim cast): the kernel then flags it and the wrapper raises."""
    if op in ("add", "sub"):
        inter = min(a_c, b_c)
        check_pow10([a_c - inter, b_c - inter, abs(out_c - inter)], n)
    elif op == "multiply":
        check_scale_divisor(a_c + b_c, out_c)
        worst = a_c + b_c - out_c + (39 if cast_interim_result else 0)
        if not cast_interim_result:
            check_pow10([max(worst, 0)], n)
        return bool(n) and worst > 76
    elif op in ("divide", "integer_divide"):
        e = out_c - (a_c - b_c)
        if e > 0:
            check_pow10([e], n)
        elif e < -38:
            check_pow10([-e - 38], n)
    elif op == "remainder":
        d_shift, n_shift = out_c - b_c, out_c - a_c
        if d_shift > 0:
            check_pow10([d_shift], n)
        else:
            n_shift -= d_shift
            check_pow10([-d_shift], n)
        check_pow10([abs(n_shift)], n)
    return False


# ---------------------------------------------------------------------------
# column API (Java scales)
# ---------------------------------------------------------------------------

def _check_dec128(col: Column):
    if col.dtype.id is not TypeId.DECIMAL128:
        raise TypeError("not a DECIMAL128 column")


def _and_validity(a: Column, b: Column) -> Optional[torch.Tensor]:
    if a.validity is None and b.validity is None:
        return None
    return a.valid_mask() & b.valid_mask()


def _run(op: str, a: Column, b: Column, out_scale: int,
         cast_interim_result: bool = True) -> Table:
    _check_dec128(a)
    _check_dec128(b)
    if a.size != b.size:
        raise ValueError("inputs have mismatched row counts")
    over, res = kernels.decimal128_op(op, a.data, b.data, -a.dtype.scale,
                                      -b.dtype.scale, -out_scale,
                                      cast_interim_result)
    validity = _and_validity(a, b)
    out_dtype = dt.INT64 if op == "integer_divide" else dt.decimal128(
        out_scale)
    return Table((Column(dt.BOOL8, a.size, data=over.to(torch.uint8),
                         validity=validity),
                  Column(out_dtype, a.size, data=res, validity=validity)))


def add_decimal128(a: Column, b: Column, target_scale: int) -> Table:
    return _run("add", a, b, target_scale)


def sub_decimal128(a: Column, b: Column, target_scale: int) -> Table:
    return _run("sub", a, b, target_scale)


def multiply_decimal128(a: Column, b: Column, product_scale: int,
                        cast_interim_result: bool = True) -> Table:
    """``cast_interim_result`` reproduces the SPARK-40129 legacy double
    rounding (on by default, as DecimalUtils.multiply128's 3-argument
    form)."""
    return _run("multiply", a, b, product_scale, cast_interim_result)


def divide_decimal128(a: Column, b: Column, quotient_scale: int) -> Table:
    return _run("divide", a, b, quotient_scale)


def integer_divide_decimal128(a: Column, b: Column) -> Table:
    """Spark's ``div``: the quotient at scale 0 as INT64; overflow is
    judged on the 128-bit quotient (decimal_utils.cu:796-826)."""
    return _run("integer_divide", a, b, 0)


def remainder_decimal128(a: Column, b: Column, remainder_scale: int
                         ) -> Table:
    return _run("remainder", a, b, remainder_scale)
