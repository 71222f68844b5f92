"""Column / Table over torch tensors.

The JAX package's model (its columnar/column.py) with PyTorch idiom: a
Column is a plain dataclass of tensors that all live on one device, and
every op runs on the device of the tensors it is given.

Fields of a Column:
  dtype:    DType (columnar/dtype.py; its docstring gives the storage of
            each type id — FLOAT64 is native float64 here, where the JAX
            package keeps uint64 bit patterns).
  size:     row count.
  data:     the values, a 1-D tensor of ``dtype.torch_dtype``.
  validity: ``bool[n]`` mask (True = valid), or None when every row is.
  offsets:  ``int32[n+1]`` row offsets of a LIST column, else None.
  children: the child column of a LIST column.

The only LIST column in this slice is the LIST<INT8> column of JCUDF rows
that ops/row_conversion.convert_to_rows returns.

A column may carry advisory ``ColumnStats`` (``with_stats``/``stats``),
which the plan engine's planner reads. They are not a field: every derived
column (gather, slice, filter, ``dataclasses.replace``) starts without.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

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
        """Fixed-width column from a host numpy array, on ``device``."""
        dev = resolve_device(device)
        if dtype is None:
            dtype = dt.infer_dtype(arr.dtype)
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
    def list_of(child: "Column", offsets: torch.Tensor,
                validity: Optional[torch.Tensor] = None) -> "Column":
        return Column(dt.LIST, int(offsets.shape[0]) - 1, data=None,
                      validity=validity, offsets=offsets.to(torch.int32),
                      children=(child,))

    # ---- host readback ----------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """Host copy of the values in the type's numpy dtype (unsigned
        storage viewed back; null rows hold whatever the data holds)."""
        if not self.dtype.is_stored:
            raise dt.not_ported(f"to_numpy of {self.dtype.id.value}",
                                "A1, nested columns")
        host = self.data.detach().cpu().numpy()
        return host.view(self.dtype.np_dtype)

    def to_pylist(self) -> list:
        """Python list with None for nulls (test/debug path)."""
        valid = self.valid_mask().cpu().numpy()
        if self.dtype.id is TypeId.LIST:
            child = self.children[0].to_pylist()
            offs = self.offsets.cpu().numpy()
            return [child[offs[i]:offs[i + 1]] if valid[i] else None
                    for i in range(self.size)]
        arr = self.to_numpy()
        if self.dtype.id is TypeId.BOOL8:
            return [bool(arr[i]) if valid[i] else None
                    for i in range(self.size)]
        return [arr[i].item() if valid[i] else None
                for i in range(self.size)]


def _host_to_tensor(host: np.ndarray, dtype: DType,
                    dev: torch.device) -> torch.Tensor:
    """numpy values -> tensor in the dtype's torch storage (a bit view for
    the unsigned types stored signed). Always a fresh buffer: a CPU tensor
    never aliases the caller's array."""
    storage_np = torch.empty(0, dtype=dtype.torch_dtype).numpy().dtype
    t = torch.from_numpy(host.view(storage_np))
    return t.clone() if dev.type == "cpu" else t.to(dev)


@dataclass
class Table:
    """An ordered collection of equal-length columns."""

    columns: Tuple[Column, ...]

    def __post_init__(self):
        self.columns = tuple(self.columns)
        if self.columns:
            n = self.columns[0].size
            for c in self.columns:
                if c.size != n:
                    raise ValueError("table columns must share row count")

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
