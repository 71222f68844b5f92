"""Column data types: the JAX package's type surface, mapped to torch.

The type ids and their wire names are the JAX package's (a column crosses
between the two packages as ``(dtype_str, rows, data, offsets, validity)``;
see columnar/interop.py), so every id is declared here. The port stores
the fixed-width ids only; the others raise ``NotImplementedError`` naming
the ROADMAP queue item that brings them.

Storage (``DType.torch_dtype``): each fixed-width id is held in the torch
dtype of its byte size and signedness. torch's kernels lack arithmetic and
comparison for uint16/uint32/uint64, so those three are stored as the
int16/int32/int64 of the same bits; readback (``Column.to_numpy``) views
them back. FLOAT64 is stored as native float64 (Hopper has exact f64; the
JAX package keeps uint64 bit patterns because the TPU's f64 is lossy) —
views, copies and gathers keep every bit, NaN payloads included.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class TypeId(enum.Enum):
    BOOL8 = "bool8"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    TIMESTAMP_DAYS = "timestamp_days"
    TIMESTAMP_SECONDS = "timestamp_s"
    TIMESTAMP_MILLISECONDS = "timestamp_ms"
    TIMESTAMP_MICROSECONDS = "timestamp_us"
    STRING = "string"
    DICT32 = "dict32"
    RLE = "rle"
    FOR32 = "for32"
    FOR64 = "for64"
    DECIMAL32 = "decimal32"
    DECIMAL64 = "decimal64"
    DECIMAL128 = "decimal128"
    LIST = "list"
    STRUCT = "struct"


# (numpy dtype of the wire bytes, torch storage dtype) per stored id
_FIXED = {
    TypeId.BOOL8: (np.uint8, torch.uint8),
    TypeId.INT8: (np.int8, torch.int8),
    TypeId.INT16: (np.int16, torch.int16),
    TypeId.INT32: (np.int32, torch.int32),
    TypeId.INT64: (np.int64, torch.int64),
    TypeId.UINT8: (np.uint8, torch.uint8),
    TypeId.UINT16: (np.uint16, torch.int16),
    TypeId.UINT32: (np.uint32, torch.int32),
    TypeId.UINT64: (np.uint64, torch.int64),
    TypeId.FLOAT32: (np.float32, torch.float32),
    TypeId.FLOAT64: (np.float64, torch.float64),
    TypeId.TIMESTAMP_DAYS: (np.int32, torch.int32),
    TypeId.TIMESTAMP_SECONDS: (np.int64, torch.int64),
    TypeId.TIMESTAMP_MILLISECONDS: (np.int64, torch.int64),
    TypeId.TIMESTAMP_MICROSECONDS: (np.int64, torch.int64),
    TypeId.DECIMAL32: (np.int32, torch.int32),
    TypeId.DECIMAL64: (np.int64, torch.int64),
}

# where each id the port does not store yet is queued (ROADMAP.md queue A)
_QUEUED = {
    TypeId.STRING: "A9/A10, strings",
    TypeId.DICT32: "A10, encoded columns",
    TypeId.RLE: "A10, encoded columns",
    TypeId.FOR32: "A10, encoded columns",
    TypeId.FOR64: "A10, encoded columns",
    TypeId.DECIMAL128: "A12, decimal128",
    TypeId.LIST: "A1, nested columns",
    TypeId.STRUCT: "A1, nested columns",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error every unported type or option raises, naming its queue
    item in ROADMAP.md."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


@dataclass(frozen=True)
class DType:
    """A column dtype: a TypeId plus decimal scale where applicable."""

    id: TypeId
    scale: int = 0

    @property
    def is_fixed_width(self) -> bool:
        return self.id not in (TypeId.STRING, TypeId.LIST, TypeId.STRUCT)

    @property
    def is_decimal(self) -> bool:
        return self.id in (TypeId.DECIMAL32, TypeId.DECIMAL64,
                           TypeId.DECIMAL128)

    @property
    def is_nested(self) -> bool:
        return self.id in (TypeId.LIST, TypeId.STRUCT)

    @property
    def is_integral(self) -> bool:
        return self.id in (
            TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
            TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64,
        )

    @property
    def is_floating(self) -> bool:
        return self.id in (TypeId.FLOAT32, TypeId.FLOAT64)

    @property
    def is_stored(self) -> bool:
        """True for the fixed-width ids this port stores."""
        return self.id in _FIXED

    def require_stored(self) -> "DType":
        """self, or NotImplementedError naming the queue item that ports
        this type."""
        self._fixed()
        return self

    def _fixed(self):
        if self.id not in _FIXED:
            raise not_ported(f"{self.id.value} columns", _QUEUED[self.id])
        return _FIXED[self.id]

    @property
    def itemsize(self) -> int:
        """Element size in bytes (the JCUDF layout size)."""
        return np.dtype(self._fixed()[0]).itemsize

    @property
    def np_dtype(self) -> np.dtype:
        """numpy dtype of the values (the wire bytes' element type)."""
        return np.dtype(self._fixed()[0])

    @property
    def torch_dtype(self) -> torch.dtype:
        """torch dtype the port stores the values in (see module doc)."""
        return self._fixed()[1]

    def __repr__(self) -> str:
        if self.is_decimal:
            return f"DType({self.id.value}, scale={self.scale})"
        return f"DType({self.id.value})"


BOOL8 = DType(TypeId.BOOL8)
INT8 = DType(TypeId.INT8)
INT16 = DType(TypeId.INT16)
INT32 = DType(TypeId.INT32)
INT64 = DType(TypeId.INT64)
UINT8 = DType(TypeId.UINT8)
UINT16 = DType(TypeId.UINT16)
UINT32 = DType(TypeId.UINT32)
UINT64 = DType(TypeId.UINT64)
FLOAT32 = DType(TypeId.FLOAT32)
FLOAT64 = DType(TypeId.FLOAT64)
LIST = DType(TypeId.LIST)


def parse_dtype(s: str) -> DType:
    """Wire dtype string -> DType ("int64", "decimal64:2", ...)."""
    if ":" in s:
        name, scale = s.split(":", 1)
        return DType(TypeId(name), int(scale))
    return DType(TypeId(s))


def dtype_str(d: DType) -> str:
    """DType -> wire dtype string (inverse of parse_dtype)."""
    if d.is_decimal:
        return f"{d.id.value}:{d.scale}"
    return d.id.value


_INFER = {
    np.dtype(np.int8): INT8, np.dtype(np.int16): INT16,
    np.dtype(np.int32): INT32, np.dtype(np.int64): INT64,
    np.dtype(np.uint8): UINT8, np.dtype(np.uint16): UINT16,
    np.dtype(np.uint32): UINT32, np.dtype(np.uint64): UINT64,
    np.dtype(np.float32): FLOAT32, np.dtype(np.float64): FLOAT64,
    np.dtype(np.bool_): BOOL8,
}


def infer_dtype(np_dtype) -> DType:
    return _INFER[np.dtype(np_dtype)]
