"""Expression IR of plan Filter predicates and Project columns (the JAX
package's plan/expr.py).

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

Encoded operands stay encoded as far as they can: a DICT32 column is its
int32 codes, compared (eq/ne only) with a string literal that
``plan/executor.resolve_dict_literals`` has turned into its code; an RLE
column enters RUN space (one value per run, expanded to rows once, where
a shape needs it); a FOR column enters CODE space (codes plus the
reference as an offset: a comparison with a literal shifts the literal).
A bare ``col(i)`` Project passes an encoded column through as it is.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from ..columnar import dtype as dt
from ..columnar import encodings as enc
from ..columnar.column import Column


class _Val(NamedTuple):
    """Evaluated expression: data (a tensor of n rows, or 0-dim for a
    literal), optional validity, and the logical dtype.

    ``runs`` — ``(ends, n, key)`` marks a RUN-space value: data and
    validity hold one entry per run of an RLE column, ``ends`` the int64
    inclusive run ends, ``n`` the row count, ``key`` the identity of the
    run structure (two run-space operands combine per run only when their
    keys match). ``offset`` — an int64 0-dim reference marks FOR code
    space: the value is ``data + offset``."""

    data: torch.Tensor
    validity: Optional[torch.Tensor]
    dtype: dt.DType
    runs: Optional[tuple] = None
    offset: Optional[torch.Tensor] = None


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
    """Integer, boolean or string literal (broadcast at evaluation). A
    string literal is compared (eq/ne) with a DICT32 column only, and
    ``plan/executor.resolve_dict_literals`` rewrites it to its code before
    either engine evaluates the plan."""

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


def _expand(v: _Val) -> _Val:
    """A run-space value expanded to rows (row j takes the run
    ``searchsorted(ends, j, right)``; zero-length runs are never
    selected)."""
    if v.runs is None:
        return v
    ends, n, _ = v.runs
    rid = enc.row_to_run(ends, n)
    data = (v.data.index_select(0, rid) if v.data.dim()
            else v.data.expand(n))
    validity = (v.validity.index_select(0, rid)
                if v.validity is not None else None)
    return _Val(data, validity, v.dtype, None, v.offset)


def _deoffset(v: _Val) -> _Val:
    """A FOR code-space value with its reference added back (in the
    logical type's storage)."""
    if v.offset is None:
        return v
    data = (v.data.to(torch.int64) + v.offset).to(v.dtype.torch_dtype)
    return _Val(data, v.validity, v.dtype, v.runs, None)


def _align_runs(lv: _Val, rv: _Val):
    """Operands of one run structure (or a literal against run space) stay
    per run; any other pair expands to rows."""
    if lv.runs is not None and rv.runs is not None:
        if lv.runs[2] == rv.runs[2]:
            return lv, rv
        return _expand(lv), _expand(rv)
    if lv.runs is not None:
        return (lv, rv) if rv.data.dim() == 0 else (_expand(lv), rv)
    if rv.runs is not None:
        return (lv, rv) if lv.data.dim() == 0 else (lv, _expand(rv))
    return lv, rv


def _cmp_offsets(lv: _Val, rv: _Val):
    """A FOR code-space operand against an integer literal compares its
    codes with ``literal - reference``; every other pair adds the
    references back."""
    if (lv.offset is not None and rv.offset is None
            and rv.data.dim() == 0 and rv.dtype.id in _INTLIKE):
        return (lv._replace(offset=None),
                rv._replace(data=rv.data.to(torch.int64) - lv.offset))
    if (rv.offset is not None and lv.offset is None
            and lv.data.dim() == 0 and lv.dtype.id in _INTLIKE):
        return (lv._replace(data=lv.data.to(torch.int64) - rv.offset),
                rv._replace(offset=None))
    return _deoffset(lv), _deoffset(rv)


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
        if c.dtype.is_nested or c.dtype.id is dt.TypeId.STRING:
            raise TypeError(f"plan expressions cannot reference "
                            f"{c.dtype.id.value} column {e.index}")
        c.dtype.require_stored()
        # DICT32 flows through as its codes: equality with a resolved
        # literal code is string equality, and the bytes never enter
        if c.dtype.id is dt.TypeId.RLE:
            values = enc.rle_values(c)
            return _Val(values.data, values.validity, values.dtype,
                        runs=(enc.run_ends_device(c), c.size,
                              id(c.children[1])))
        if enc.is_for(c):
            return _Val(enc.for_codes(c), c.validity, enc.logical_dtype(c),
                        offset=enc.for_reference(c))
        return _Val(c.data, c.validity, c.dtype)
    if isinstance(e, Lit):
        dev = cols[0].device
        if isinstance(e.value, bool):
            return _Val(torch.full((), e.value, dtype=torch.bool,
                                   device=dev), None, dt.BOOL8)
        if isinstance(e.value, str):
            raise TypeError(
                "unresolved string literal in a plan expression: string "
                "literals are rewritten to dictionary codes "
                "(plan/executor.resolve_dict_literals) before evaluation")
        if not -(1 << 63) <= e.value < (1 << 63):
            raise OverflowError(f"literal {e.value} is outside int64")
        return _Val(torch.full((), e.value, dtype=torch.int64, device=dev),
                    None, dt.INT64)
    if isinstance(e, Cast64):
        v = _deoffset(eval_expr(e.operand, cols))
        return _Val(_intlike(v, "i64()"), v.validity, dt.INT64, runs=v.runs)
    if isinstance(e, Not):
        v = eval_expr(e.operand, cols)
        if v.dtype.id is not dt.TypeId.BOOL8:
            raise TypeError("~ requires a boolean operand")
        return _Val(~v.data.to(torch.bool), v.validity, dt.BOOL8,
                    runs=v.runs)
    if isinstance(e, BinOp):
        lv = eval_expr(e.left, cols)
        rv = eval_expr(e.right, cols)
        if e.op in _CMP:
            lv, rv = _cmp_offsets(lv, rv)
        else:
            lv, rv = _deoffset(lv), _deoffset(rv)
        lv, rv = _align_runs(lv, rv)
        runs = lv.runs if lv.runs is not None else rv.runs
        validity = _merge_valid(lv.validity, rv.validity)
        if e.op in _ARITH:
            data = _ARITH[e.op](_intlike(lv, e.op), _intlike(rv, e.op))
            return _Val(data, validity, dt.INT64, runs=runs)
        if e.op in _CMP:
            if (lv.dtype.id is dt.TypeId.DICT32
                    or rv.dtype.id is dt.TypeId.DICT32):
                return _Val(_dict_compare(e.op, lv, rv), validity, dt.BOOL8)
            data = _CMP[e.op](_intlike(lv, e.op), _intlike(rv, e.op))
            return _Val(data, validity, dt.BOOL8, runs=runs)
        if e.op in _BOOL:
            if (lv.dtype.id is not dt.TypeId.BOOL8
                    or rv.dtype.id is not dt.TypeId.BOOL8):
                raise TypeError(f"{e.op} requires boolean operands")
            l, r = lv.data.to(torch.bool), rv.data.to(torch.bool)
            return _Val(l & r if e.op == "and" else l | r, validity,
                        dt.BOOL8, runs=runs)
        raise TypeError(f"unknown expression op {e.op!r}")
    raise TypeError(f"not a plan expression: {e!r}")


def _dict_compare(op: str, lv: _Val, rv: _Val) -> torch.Tensor:
    """eq/ne of a DICT32 code array and a resolved literal code. Codes
    carry no order (ranks do) and two dictionary columns index different
    dictionaries: both raise."""
    if op not in ("eq", "ne"):
        raise TypeError(
            f"plan expression {op} is unsupported on dictionary-encoded "
            f"columns — codes carry equality only; sort via a Sort node "
            f"(rank lanes), or materialize first")
    if (lv.dtype.id is dt.TypeId.DICT32
            and rv.dtype.id is dt.TypeId.DICT32):
        raise TypeError(
            "comparing two dictionary-encoded columns is unsupported in "
            "plan expressions (their codes index different dictionaries); "
            "use a join on the key columns")
    dv, ov = (lv, rv) if lv.dtype.id is dt.TypeId.DICT32 else (rv, lv)
    if ov.dtype.id not in _INTLIKE:
        raise TypeError(
            f"dictionary-encoded comparison needs a resolved integer code "
            f"operand, got {ov.dtype.id.value}")
    return _CMP[op](dv.data.to(torch.int64), ov.data.to(torch.int64))


def project_column(e: Expr, cols: Sequence[Column], size: int) -> Column:
    """Project one expression to an output Column of ``size`` rows. A bare
    ``col(i)`` of an encoded column passes the column through as it is
    (codes, runs or packed bytes with their shared children)."""
    if isinstance(e, Col) and (cols[e.index].dtype.is_encoded
                               or cols[e.index].dtype.id
                               is dt.TypeId.DICT32):
        return cols[e.index]
    return materialize(eval_expr(e, cols), size)


def materialize(v: _Val, size: int) -> Column:
    """Output Column of an evaluated Project expression: run-space and
    code-space values expand here, a literal broadcasts to the row count;
    BOOL8 results are stored as uint8."""
    v = _deoffset(_expand(v))
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
    WHERE). A run-space predicate expands here, once."""
    if v.dtype.id is not dt.TypeId.BOOL8:
        raise TypeError("filter predicate must be boolean")
    v = _expand(v)
    keep = v.data.to(torch.bool)
    if v.validity is not None:
        keep = keep & v.validity
    return keep
