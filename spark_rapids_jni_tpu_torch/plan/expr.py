"""Expression IR of plan Filter predicates and Project columns (the
fixed-width part of the JAX package's plan/expr.py).

Column refs, integer/bool literals, ``+ - *`` evaluated in int64 (wrapping,
as int64 does on both packages), the six comparisons, and ``& | ~`` on
booleans. FLOAT64 columns may only pass through a bare ``col(i)``
projection; arithmetic or a comparison on a float column is a TypeError.

Null semantics: the result of any operator is null when ANY operand is
null (strict propagation — stricter than Kleene logic for ``&``/``|``:
Spark's ``null AND false = false`` does not apply here), and a Filter
drops null-predicate rows, as SQL WHERE does. The fused lowering and the
eager interpreter both evaluate through this one module.

A literal evaluates to a 0-dim tensor filled on the columns' device (a
fill, not a host-to-device copy, so a fused program stays free of syncs).

Not ported: dictionary-encoded, run-length and frame-of-reference
operands, and string literals (resolved to dictionary codes in the JAX
package); they raise, naming ROADMAP A10.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from ..columnar import dtype as dt
from ..columnar.column import Column


class _Val(NamedTuple):
    """Evaluated expression: data (a tensor of n rows, or 0-dim for a
    literal), optional validity, and the logical dtype."""

    data: torch.Tensor
    validity: Optional[torch.Tensor]
    dtype: dt.DType


# dtypes whose data takes part in int64 expression arithmetic
_INTLIKE = (
    dt.TypeId.BOOL8, dt.TypeId.INT8, dt.TypeId.INT16, dt.TypeId.INT32,
    dt.TypeId.INT64, dt.TypeId.UINT8, dt.TypeId.UINT16, dt.TypeId.UINT32,
    dt.TypeId.TIMESTAMP_DAYS, dt.TypeId.TIMESTAMP_SECONDS,
    dt.TypeId.TIMESTAMP_MILLISECONDS, dt.TypeId.TIMESTAMP_MICROSECONDS,
)

_ARITH = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}
_CMP = {"lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
        "eq": torch.eq, "ne": torch.ne}
_BOOL = {"and", "or"}


def _wrap(v) -> "Expr":
    if isinstance(v, Expr):
        return v
    if isinstance(v, (bool, int, str)):
        return Lit(v)
    raise TypeError(f"cannot use {type(v).__name__} in a plan expression")


class Expr:
    """Base class; operator overloads build the tree. ``==`` builds a
    comparison node (dataclass equality is disabled on purpose) — plan
    identity goes through the fingerprint, not ``__eq__``."""

    def __add__(self, o):
        return BinOp("add", self, _wrap(o))

    def __sub__(self, o):
        return BinOp("sub", self, _wrap(o))

    def __mul__(self, o):
        return BinOp("mul", self, _wrap(o))

    def __radd__(self, o):
        return BinOp("add", _wrap(o), self)

    def __rsub__(self, o):
        return BinOp("sub", _wrap(o), self)

    def __rmul__(self, o):
        return BinOp("mul", _wrap(o), self)

    def __lt__(self, o):
        return BinOp("lt", self, _wrap(o))

    def __le__(self, o):
        return BinOp("le", self, _wrap(o))

    def __gt__(self, o):
        return BinOp("gt", self, _wrap(o))

    def __ge__(self, o):
        return BinOp("ge", self, _wrap(o))

    def __eq__(self, o):  # type: ignore[override]
        return BinOp("eq", self, _wrap(o))

    def __ne__(self, o):  # type: ignore[override]
        return BinOp("ne", self, _wrap(o))

    def __and__(self, o):
        return BinOp("and", self, _wrap(o))

    def __or__(self, o):
        return BinOp("or", self, _wrap(o))

    def __invert__(self):
        return Not(self)

    __hash__ = None  # type: ignore[assignment]


@dataclasses.dataclass(frozen=True, eq=False, repr=True)
class Col(Expr):
    """Reference to input column ``index`` of the node's child."""

    index: int


@dataclasses.dataclass(frozen=True, eq=False, repr=True)
class Lit(Expr):
    """Integer or boolean literal (broadcast at evaluation). A string
    literal builds, so that plans fingerprint as in the JAX package, but
    raises at evaluation (dictionary codes, ROADMAP A10)."""

    value: int


@dataclasses.dataclass(frozen=True, eq=False, repr=True)
class Cast64(Expr):
    """Widen an integer-family operand to INT64."""

    operand: Expr


@dataclasses.dataclass(frozen=True, eq=False, repr=True)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr


@dataclasses.dataclass(frozen=True, eq=False, repr=True)
class Not(Expr):
    operand: Expr


def col(index: int) -> Col:
    return Col(index)


def lit(value: int) -> Lit:
    return Lit(value)


def i64(e) -> Cast64:
    return Cast64(_wrap(e))


def _merge_valid(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _intlike(v: _Val, what: str) -> torch.Tensor:
    if v.dtype.id not in _INTLIKE:
        raise TypeError(
            f"plan expression {what} requires an integer/bool operand, got "
            f"{v.dtype.id.value} (keep FLOAT64 columns as bare col(i) "
            f"passthroughs)")
    return v.data.to(torch.int64)


def eval_expr(e: Expr, cols: Sequence[Column]) -> _Val:
    """Evaluate over Columns (all on one device). Shared by the fused
    lowering and the eager interpreter."""
    if isinstance(e, Col):
        c = cols[e.index]
        c.dtype.require_stored()  # encoded and string columns raise
        return _Val(c.data, c.validity, c.dtype)
    if isinstance(e, Lit):
        dev = cols[0].device
        if isinstance(e.value, bool):
            return _Val(torch.full((), e.value, dtype=torch.bool,
                                   device=dev), None, dt.BOOL8)
        if isinstance(e.value, str):
            raise dt.not_ported("string literals in plan expressions "
                                "(dictionary codes)", "A10, encoded columns")
        if not -(1 << 63) <= e.value < (1 << 63):
            raise OverflowError(f"literal {e.value} is outside int64")
        return _Val(torch.full((), e.value, dtype=torch.int64, device=dev),
                    None, dt.INT64)
    if isinstance(e, Cast64):
        v = eval_expr(e.operand, cols)
        return _Val(_intlike(v, "i64()"), v.validity, dt.INT64)
    if isinstance(e, Not):
        v = eval_expr(e.operand, cols)
        if v.dtype.id is not dt.TypeId.BOOL8:
            raise TypeError("~ requires a boolean operand")
        return _Val(~v.data.to(torch.bool), v.validity, dt.BOOL8)
    if isinstance(e, BinOp):
        lv = eval_expr(e.left, cols)
        rv = eval_expr(e.right, cols)
        validity = _merge_valid(lv.validity, rv.validity)
        if e.op in _ARITH:
            data = _ARITH[e.op](_intlike(lv, e.op), _intlike(rv, e.op))
            return _Val(data, validity, dt.INT64)
        if e.op in _CMP:
            data = _CMP[e.op](_intlike(lv, e.op), _intlike(rv, e.op))
            return _Val(data, validity, dt.BOOL8)
        if e.op in _BOOL:
            if (lv.dtype.id is not dt.TypeId.BOOL8
                    or rv.dtype.id is not dt.TypeId.BOOL8):
                raise TypeError(f"{e.op} requires boolean operands")
            l, r = lv.data.to(torch.bool), rv.data.to(torch.bool)
            return _Val(l & r if e.op == "and" else l | r, validity,
                        dt.BOOL8)
        raise TypeError(f"unknown expression op {e.op!r}")
    raise TypeError(f"not a plan expression: {e!r}")


def project_column(e: Expr, cols: Sequence[Column], size: int) -> Column:
    """Project one expression to an output Column of ``size`` rows."""
    return materialize(eval_expr(e, cols), size)


def materialize(v: _Val, size: int) -> Column:
    """Output Column of an evaluated Project expression: a literal
    broadcasts to the row count; BOOL8 results are stored as uint8."""
    data = v.data
    if data.dim() == 0:
        data = data.expand(size).contiguous()
    if v.dtype.id is dt.TypeId.BOOL8:
        data = data.to(torch.uint8)
    validity = v.validity
    if validity is not None and validity.dim() == 0:
        validity = validity.expand(size).contiguous()
    return Column(v.dtype, size, data=data, validity=validity)


def predicate_mask(v: _Val) -> torch.Tensor:
    """bool[n] keep-mask of a Filter predicate: null rows are dropped (SQL
    WHERE)."""
    if v.dtype.id is not dt.TypeId.BOOL8:
        raise TypeError("filter predicate must be boolean")
    keep = v.data.to(torch.bool)
    if v.validity is not None:
        keep = keep & v.validity
    return keep
