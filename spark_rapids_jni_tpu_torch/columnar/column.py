"""Column / Table over torch tensors.

The JAX package's model (its columnar/column.py) with PyTorch idiom: a
Column is a plain dataclass of tensors that all live on one device, and
every op runs on the device of the tensors it is given.

Fields of a Column:
  dtype:    DType (columnar/dtype.py; its docstring gives the storage of
            each type id — FLOAT64 is native float64 here, where the JAX
            package keeps uint64 bit patterns).
  size:     row count.
  data:     the values, a 1-D tensor of ``dtype.torch_dtype``; for a
            STRING column the characters, ``uint8[nbytes]``; for a
            DECIMAL128 column ``int32[n, 4]`` little-endian two's-complement
            limbs (the JAX package's ``uint32[n, 4]``, same bits). A
            DECIMAL128 literal may be one row expanded to n (row stride 0,
            ``decimal128_literal``).
  validity: ``bool[n]`` mask (True = valid), or None when every row is.
  offsets:  ``int32[n+1]`` row offsets of a STRING or LIST column, else
            None: row i is ``data[offsets[i]:offsets[i+1]]``.
  children: the child column of a LIST column; the field columns of a
            STRUCT column (which has no data and no offsets); the shared dictionary of a
            DICT32 column (values, ranks: columnar/dictionary.py); the run
            values and lengths of an RLE column and the reference header
            of a FOR column (columnar/encodings.py). Children are shared
            by reference and never changed in place.

A null STRING row may hold bytes (its offsets say how many); every op
carries them as they are, as the JAX package does. A null LIST row may
likewise own elements, and a STRUCT's validity is its own: a null STRUCT
row keeps its children's values and validity as they are (only the row
hashes lay the parent's nulls over the children, ops/hashing.py). The
LIST<INT8> columns of JCUDF rows (ops/row_conversion.convert_to_rows)
are LIST columns whose child is a view of kernel B3's words.

A column may carry advisory ``ColumnStats`` (``with_stats``/``stats``),
which the plan engine's planner reads. They are not a field: every derived
column (gather, slice, filter, ``dataclasses.replace``) starts without.
"""

from __future__ import annotations

import decimal as _pydecimal
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dtype as dt
from .dtype import DType, TypeId


@dataclass(frozen=True)
class ColumnStats:
    """Advisory value statistics of an integer column (the JAX package's
    ColumnStats). The planner (plan/planner.py) picks direct-addressed
    joins and direct-slot groupbys off them; every strategy re-checks its
    claim on the device and turns a violation into the plan's overflow
    flag, so lying stats cost an eager replay, never a wrong answer.

      lo / hi:          inclusive bounds over ALL rows of the data buffer,
                        null rows included.
      unique:           values are pairwise distinct.
      ascending_dense:  data == arange(n) + lo exactly.
    """

    lo: Optional[int] = None
    hi: Optional[int] = None
    unique: bool = False
    ascending_dense: bool = False

    @staticmethod
    def from_numpy(arr: np.ndarray) -> "ColumnStats":
        """Honest stats of a host integer array (the JAX package's values;
        a range narrower than the row count proves a repeat without the
        sort that ``np.unique`` costs)."""
        if arr.size == 0 or not np.issubdtype(arr.dtype, np.integer):
            return ColumnStats()
        lo = int(arr.min())
        hi = int(arr.max())
        dense = bool(hi - lo == arr.size - 1) and bool(
            np.array_equal(arr, np.arange(arr.size, dtype=arr.dtype) + lo))
        unique = dense or (hi - lo + 1 >= arr.size
                           and len(np.unique(arr)) == arr.size)
        return ColumnStats(lo=lo, hi=hi, unique=unique, ascending_dense=dense)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point builds on. ``"cuda"`` (the default of
    every column and table constructor) needs a card: with none present
    this raises, so a run never carries on quietly on the CPU. Pass
    ``device="cpu"`` to ask for the CPU."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return d


@dataclass
class Column:
    """A column of tensors on one device (see the module docstring)."""

    dtype: DType
    size: int
    data: Optional[torch.Tensor] = None
    validity: Optional[torch.Tensor] = None
    offsets: Optional[torch.Tensor] = None
    children: Tuple["Column", ...] = field(default_factory=tuple)

    def __len__(self) -> int:
        return self.size

    @property
    def device(self) -> torch.device:
        if self.data is not None:
            return self.data.device
        if self.offsets is not None:
            return self.offsets.device
        return self.children[0].device

    def valid_mask(self) -> torch.Tensor:
        """Always-materialized ``bool[n]`` validity mask."""
        if self.validity is not None:
            return self.validity
        return torch.ones(self.size, dtype=torch.bool, device=self.device)

    def with_validity(self, validity: Optional[torch.Tensor]) -> "Column":
        return replace(self, validity=validity)

    def with_stats(self, stats: Optional[ColumnStats]) -> "Column":
        """Attach advisory stats; returns self (chainable)."""
        if stats is not None:
            self._stats = stats
        return self

    def stats(self) -> Optional[ColumnStats]:
        return getattr(self, "_stats", None)

    def device_nbytes(self) -> int:
        """Device footprint in bytes (data + validity + offsets +
        children)."""
        n = 0
        for t in (self.data, self.validity, self.offsets):
            if t is not None:
                n += t.numel() * t.element_size()
        return int(n + sum(c.device_nbytes() for c in self.children))

    # ---- host constructors ------------------------------------------------
    @staticmethod
    def from_numpy(arr: np.ndarray, dtype: Optional[DType] = None,
                   validity: Optional[np.ndarray] = None,
                   device="cuda") -> "Column":
        """Fixed-width column from a host numpy array, on ``device``
        (DECIMAL128: ``[n, 4]`` 32-bit limbs)."""
        dev = resolve_device(device)
        if dtype is None:
            dtype = dt.infer_dtype(arr.dtype)
        if dtype.id is TypeId.DECIMAL128 and (arr.ndim != 2
                                              or arr.shape[1] != 4):
            raise ValueError("DECIMAL128 data is [n, 4] 32-bit limbs")
        host = np.ascontiguousarray(arr.astype(dtype.np_dtype, copy=False))
        if not host.flags.writeable:  # torch.from_numpy needs writable
            host = host.copy()
        data = _host_to_tensor(host, dtype, dev)
        vmask = None
        if validity is not None:
            vmask = torch.from_numpy(
                np.array(validity, dtype=bool, copy=True)).to(dev)
        return Column(dtype, int(host.shape[0]), data=data, validity=vmask)

    @staticmethod
    def from_pylist(values, dtype: DType, device="cuda") -> "Column":
        """Column from a Python list; None entries become nulls. STRING
        takes str (UTF-8 encoded) or bytes, a null row holds no bytes."""
        dev = resolve_device(device)
        n = len(values)
        valid = np.array([v is not None for v in values], dtype=bool)
        vmask = None if valid.all() else torch.from_numpy(valid).to(dev)
        if dtype.id is TypeId.STRING:
            parts = [b"" if v is None else
                     (v.encode("utf-8") if isinstance(v, str) else bytes(v))
                     for v in values]
            offsets = np.zeros(n + 1, dtype=np.int32)
            np.cumsum([len(p) for p in parts], out=offsets[1:])
            chars = np.frombuffer(b"".join(parts), dtype=np.uint8).copy()
            return Column(dtype, n, data=torch.from_numpy(chars).to(dev),
                          validity=vmask,
                          offsets=torch.from_numpy(offsets).to(dev))
        if dtype.id is TypeId.DECIMAL128:
            limbs = np.zeros((n, 4), dtype=np.uint32)
            for i, v in enumerate(values):
                if v is not None:
                    limbs[i] = int128_to_limbs(
                        _to_unscaled_int(v, dtype.scale))
            col = Column.from_numpy(limbs, dtype, device=dev)
            col.validity = vmask
            return col
        if dtype.is_decimal:  # DECIMAL32 / DECIMAL64: unscaled values
            values = [None if v is None else _to_unscaled_int(v, dtype.scale)
                      for v in values]
        arr = np.zeros(n, dtype=dtype.np_dtype)
        for i, v in enumerate(values):
            if v is not None:
                arr[i] = bool(v) if dtype.id is TypeId.BOOL8 else v
        col = Column.from_numpy(arr, dtype, device=dev)
        col.validity = vmask
        return col

    @staticmethod
    def list_of(child: "Column", offsets: torch.Tensor,
                validity: Optional[torch.Tensor] = None) -> "Column":
        """LIST column: row i is ``child[offsets[i]:offsets[i+1]]``
        (``offsets``: n + 1 entries, made int32)."""
        return Column(dt.LIST, int(offsets.shape[0]) - 1, data=None,
                      validity=validity, offsets=offsets.to(torch.int32),
                      children=(child,))

    @staticmethod
    def struct_of(children: Sequence["Column"],
                  validity: Optional[torch.Tensor] = None) -> "Column":
        """STRUCT column of equal-length field columns."""
        assert children, "struct needs at least one child"
        n = children[0].size
        for c in children:
            assert c.size == n, "struct children must share row count"
        return Column(dt.STRUCT, n, data=None, validity=validity,
                      children=tuple(children))

    # ---- host readback ----------------------------------------------------
    def host_offsets(self) -> Optional[np.ndarray]:
        """Host copy of ``offsets`` (int32), memoized on the column and
        read-only: a column is never changed in place."""
        if self.offsets is None:
            return None
        cached = getattr(self, "_host_offsets", None)
        if cached is None:
            cached = self.offsets.cpu().numpy()
            cached.flags.writeable = False
            self._host_offsets = cached
        return cached

    def to_numpy(self) -> np.ndarray:
        """Host copy of the values in the type's numpy dtype (unsigned
        storage viewed back; null rows hold whatever the data holds)."""
        if self.dtype.id is TypeId.STRING:
            raise ValueError("a STRING column has no fixed-width values: "
                             "read data and offsets, or to_pylist()")
        if self.dtype.is_encoded:
            raise ValueError("an RLE or FOR column holds no row values: "
                             "decode it (columnar/encodings.materialize)")
        if self.dtype.is_nested:
            raise ValueError("a LIST or STRUCT column has no flat values: "
                             "read its offsets and children, or to_pylist()")
        host = self.data.detach().cpu().numpy()
        return host.view(self.dtype.np_dtype)

    def to_pylist(self) -> list:
        """Python list with None for nulls (test/debug path)."""
        valid = self.valid_mask().cpu().numpy()
        if self.dtype.id is TypeId.STRING:
            chars = self.data.cpu().numpy().tobytes()
            offs = self.host_offsets()
            return [chars[offs[i]:offs[i + 1]].decode("utf-8",
                                                      errors="replace")
                    if valid[i] else None for i in range(self.size)]
        if self.dtype.id is TypeId.DICT32:
            from .dictionary import materialize
            return materialize(self).to_pylist()
        if self.dtype.is_encoded:
            from .encodings import materialize
            return materialize(self).to_pylist()
        if self.dtype.id is TypeId.LIST:
            child = self.children[0].to_pylist()
            offs = self.host_offsets()
            return [child[offs[i]:offs[i + 1]] if valid[i] else None
                    for i in range(self.size)]
        if self.dtype.id is TypeId.STRUCT:
            fields = [c.to_pylist() for c in self.children]
            return [tuple(f[i] for f in fields) if valid[i] else None
                    for i in range(self.size)]
        arr = self.to_numpy()
        if self.dtype.id is TypeId.DECIMAL128:
            return [_scaled_decimal(limbs_to_int128(arr[i]), self.dtype.scale)
                    if valid[i] else None for i in range(self.size)]
        if self.dtype.is_decimal:
            return [_scaled_decimal(int(arr[i]), self.dtype.scale)
                    if valid[i] else None for i in range(self.size)]
        if self.dtype.id is TypeId.BOOL8:
            return [bool(arr[i]) if valid[i] else None
                    for i in range(self.size)]
        return [arr[i].item() if valid[i] else None
                for i in range(self.size)]


def decimal128_literal(value, scale: int, n: int, device="cuda") -> Column:
    """A DECIMAL128 literal as an n-row column: one row of limbs expanded
    to n (row stride 0, no copy), as Spark's ``1 - l_discount`` holds its
    ``1.00``. ``value``: an int (unscaled), a Decimal or its string."""
    dev = resolve_device(device)
    row = int128_to_limbs(_to_unscaled_int(value, scale))
    data = torch.from_numpy(row.view(np.int32).copy()).to(dev)
    return Column(dt.decimal128(scale), n, data=data[None, :].expand(n, 4))


def _host_to_tensor(host: np.ndarray, dtype: DType,
                    dev: torch.device) -> torch.Tensor:
    """numpy values -> tensor in the dtype's torch storage (a bit view for
    the unsigned types stored signed). Always a fresh buffer: a CPU tensor
    never aliases the caller's array."""
    storage_np = torch.empty(0, dtype=dtype.torch_dtype).numpy().dtype
    t = torch.from_numpy(host.view(storage_np))
    return t.clone() if dev.type == "cpu" else t.to(dev)


# ---- int128 limb helpers (host side; the JAX package's) --------------------

_MASK128 = (1 << 128) - 1


def int128_to_limbs(value: int) -> np.ndarray:
    """Two's-complement 128-bit -> 4 little-endian uint32 limbs."""
    v = value & _MASK128
    return np.array([(v >> (32 * i)) & 0xFFFFFFFF for i in range(4)],
                    dtype=np.uint32)


def limbs_to_int128(limbs: np.ndarray) -> int:
    v = 0
    for i in range(4):
        v |= (int(limbs[i]) & 0xFFFFFFFF) << (32 * i)
    if v >= (1 << 127):
        v -= 1 << 128
    return v


def _to_unscaled_int(v, scale: int) -> int:
    """The unscaled integer of a value at a Java scale: an int is taken
    as unscaled already; a Decimal (or its string) is shifted by its
    exponent and rounded HALF_UP, independent of the decimal context."""
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, _pydecimal.Decimal):
        sign, digits, exp = v.as_tuple()
        shifted = _pydecimal.Decimal((sign, digits, exp + scale))
        return int(shifted.to_integral_value(
            rounding=_pydecimal.ROUND_HALF_UP))
    if isinstance(v, str):
        return _to_unscaled_int(_pydecimal.Decimal(v), scale)
    raise TypeError(f"cannot build decimal from {type(v)}")


def _scaled_decimal(unscaled: int, scale: int) -> _pydecimal.Decimal:
    """Exact Decimal of an unscaled value (``scaleb`` would round to the
    context's precision, 28 digits by default)."""
    sign = 1 if unscaled < 0 else 0
    digits = tuple(int(c) for c in str(abs(unscaled)))
    return _pydecimal.Decimal((sign, digits, -scale))


class Table:
    """An ordered collection of equal-length columns. ``donate()`` hands
    the columns to a consumer that then holds the only references (plan
    input donation); a donated table raises on use, as a deleted
    ``jax.Array`` does."""

    def __init__(self, columns: Sequence[Column]):
        self._columns: Optional[Tuple[Column, ...]] = tuple(columns)
        if self._columns:
            n = self._columns[0].size
            for c in self._columns:
                if c.size != n:
                    raise ValueError("table columns must share row count")

    @property
    def columns(self) -> Tuple[Column, ...]:
        if self._columns is None:
            raise RuntimeError("Table has been donated: its columns were "
                               "handed to the program that consumed it")
        return self._columns

    @property
    def is_donated(self) -> bool:
        return self._columns is None

    def donate(self) -> List[Column]:
        """The columns, as a list the caller takes ownership of; the
        table keeps none of them."""
        cols = list(self.columns)
        self._columns = None
        return cols

    def __repr__(self) -> str:
        if self._columns is None:
            return "Table(<donated>)"
        return f"Table(columns={self._columns!r})"

    @property
    def num_rows(self) -> int:
        return self.columns[0].size if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def device(self) -> torch.device:
        return self.columns[0].device

    def device_nbytes(self) -> int:
        return sum(c.device_nbytes() for c in self.columns)

    def __getitem__(self, i: int) -> Column:
        return self.columns[i]

    def __iter__(self):
        return iter(self.columns)

    def __len__(self) -> int:
        return len(self.columns)
