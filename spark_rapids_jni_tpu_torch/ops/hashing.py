"""Spark row hashes over fixed-width columns: MurmurHash3_32 and XXHash64.

The fixed-width part of the JAX package's ops/hashing.py. Spark's rules,
as that module reproduces them:

  * the running hash is chained across columns as the next column's seed,
    and a null element passes it through unchanged;
  * INT8/INT16 sign-extend to 4 bytes, BOOL8 hashes as ``!= 0``,
    DECIMAL32/64 hash as the 8 bytes of the sign-extended unscaled value;
  * murmur3 canonicalizes float NaNs only; xxhash64 canonicalizes NaNs
    and folds -0.0 into 0.0.

The per-type normalization (``_fixed_element_words``) runs here in torch;
the chained mixing runs in the CUDA kernels B1 (murmur3) and B2 (xxhash64)
behind ops/kernels.py, whose plain versions are built from the mixing
functions below.

torch has no shift, add or compare for uint32/uint64, so these mixing
functions hold a u32 value in an int64 tensor masked to its low 32 bits,
and a u64 value as the int64 of the same bits (int64 multiply and add wrap
as u64 does; a logical right shift is ``_lsr``). They run the same on the
CPU and on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table
from ..columnar.dtype import DType, TypeId
from . import kernels

DEFAULT_MURMUR_SEED = 42  # Hash.java:33
DEFAULT_XXHASH64_SEED = 42

_M32 = 0xFFFFFFFF


def _s64(v: int) -> int:
    """A u64 constant as the int64 of the same bits."""
    v &= 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >> 63 else v


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64-held u64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


# ---------------------------------------------------------------------------
# murmur3 (u32 in int64 lanes)
# ---------------------------------------------------------------------------

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_C3 = 0xE6546B64


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _mm_block(h, k):
    """One full murmur block mix; Spark uses the same mix for tail bytes."""
    k = (k * _C1) & _M32
    k = _rotl32(k, 15)
    k = (k * _C2) & _M32
    h = h ^ k
    h = _rotl32(h, 13)
    return (h * 5 + _C3) & _M32


def _mm_fmix(h, length: int):
    h = h ^ length
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _mm_u32(h, v_u32):
    """Hash a 4-byte value."""
    return _mm_fmix(_mm_block(h, v_u32), 4)


def _mm_u64(h, v_u64):
    """Hash an 8-byte value (little-endian block order)."""
    h = _mm_block(h, v_u64 & _M32)
    h = _mm_block(h, _lsr(v_u64, 32))
    return _mm_fmix(h, 8)


# ---------------------------------------------------------------------------
# xxhash64 (u64 as int64 bits)
# ---------------------------------------------------------------------------

_P1 = _s64(0x9E3779B185EBCA87)
_P2 = _s64(0xC2B2AE3D27D4EB4F)
_P3 = _s64(0x165667B19E3779F9)
_P4 = _s64(0x85EBCA77C2B2AE63)
_P5 = _s64(0x27D4EB2F165667C5)


def _rotl64(x, r: int):
    return (x << r) | _lsr(x, 64 - r)


def _xx_final(h):
    h = h ^ _lsr(h, 33)
    h = h * _P2
    h = h ^ _lsr(h, 29)
    h = h * _P3
    return h ^ _lsr(h, 32)


def _xx_round8(h, k64):
    k1 = _rotl64(k64 * _P2, 31) * _P1
    h = h ^ k1
    return _rotl64(h, 27) * _P1 + _P4


def _xx_round4(h, k32):
    h = h ^ (k32 * _P1)
    return _rotl64(h, 23) * _P2 + _P3


def _xx_u32(seed, v_u32):
    """4-byte value path (v zero-extended to u64)."""
    return _xx_final(_xx_round4(seed + _s64(_P5 + 4), v_u32))


def _xx_u64(seed, v_u64):
    return _xx_final(_xx_round8(seed + _s64(_P5 + 8), v_u64))


# ---------------------------------------------------------------------------
# element normalization
# ---------------------------------------------------------------------------

def _f32_bits(x: torch.Tensor, normalize_zero: bool) -> torch.Tensor:
    """int32 bits of float32 values: NaNs canonical (0x7FC00000), and
    -0.0 folded into 0.0 when ``normalize_zero``."""
    bits = torch.where(torch.isnan(x), 0x7FC00000, x.view(torch.int32))
    if normalize_zero:
        bits = torch.where(x == 0.0, torch.zeros_like(bits), bits)
    return bits


def _f64_bits(x: torch.Tensor, normalize_zero: bool) -> torch.Tensor:
    """int64 bits of float64 values: NaNs canonical
    (0x7FF8000000000000), and -0.0 folded into 0.0 when
    ``normalize_zero``."""
    bits = torch.where(torch.isnan(x), 0x7FF8000000000000,
                       x.view(torch.int64))
    if normalize_zero:
        bits = torch.where(x == 0.0, torch.zeros_like(bits), bits)
    return bits


def spark_key_values(col: Column) -> torch.Tensor:
    """Comparable values of a join/group key column: float bits with NaNs
    canonical and -0.0 == 0.0 (Spark's key equality, which agrees with the
    row hash and the sort order). Other columns pass through."""
    if col.dtype.id is TypeId.FLOAT64:
        return _f64_bits(col.data, normalize_zero=True)
    if col.dtype.id is TypeId.FLOAT32:
        return _f32_bits(col.data, normalize_zero=True)
    return col.data


def _fixed_element_words(col_dtype: DType, data: torch.Tensor,
                         for_xxhash: bool) -> Tuple[str, torch.Tensor]:
    """('u32', int32 words) or ('u64', int64 words) for one column: the
    bits each element is hashed as."""
    tid = col_dtype.id
    if tid is TypeId.BOOL8:
        return "u32", (data != 0).to(torch.int32)
    if tid in (TypeId.UINT8, TypeId.UINT16):
        mask = 0xFF if tid is TypeId.UINT8 else 0xFFFF
        return "u32", data.to(torch.int32) & mask
    if tid in (TypeId.INT8, TypeId.INT16):
        return "u32", data.to(torch.int32)
    if tid in (TypeId.INT32, TypeId.TIMESTAMP_DAYS, TypeId.UINT32):
        return "u32", data
    if tid is TypeId.FLOAT32:
        return "u32", _f32_bits(data, normalize_zero=for_xxhash)
    if tid in (TypeId.INT64, TypeId.UINT64, TypeId.TIMESTAMP_SECONDS,
               TypeId.TIMESTAMP_MILLISECONDS, TypeId.TIMESTAMP_MICROSECONDS,
               TypeId.DECIMAL64):
        return "u64", data
    if tid is TypeId.FLOAT64:
        return "u64", _f64_bits(data, normalize_zero=for_xxhash)
    if tid is TypeId.DECIMAL32:
        return "u64", data.to(torch.int64)
    if tid in (TypeId.DECIMAL128, TypeId.STRING, TypeId.LIST,
               TypeId.STRUCT):
        raise dt.not_ported(f"{tid.value} hashing", "A2, variable-width "
                            "and nested row hashes")
    raise dt.not_ported(f"{tid.value} hashing", "A10, encoded columns")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _normalize_input(table: Union[Table, Sequence[Column]]
                     ) -> Tuple[Column, ...]:
    if isinstance(table, Table):
        return table.columns
    return tuple(table)


def _hash_rows(columns: Tuple[Column, ...], seed: int, algo: str) -> Column:
    """Seed-chain ``algo`` ("mm" or "xx") across the columns; the mixing
    runs in kernel B1 or B2 (ops/kernels.py). Every column is flat here,
    so each is its own hash unit (STRUCT/LIST flattening is queued with
    nested hashing and raises in _fixed_element_words)."""
    for_xx = algo == "xx"
    out_dt = dt.INT64 if for_xx else dt.INT32
    if not columns:
        return Column(out_dt, 0, data=torch.zeros(0,
                                                  dtype=out_dt.torch_dtype))
    n = columns[0].size
    schema = []
    for c in columns:
        kind, words = _fixed_element_words(c.dtype, c.data, for_xx)
        schema.append((kind, words, c.validity))
    if for_xx:
        h = kernels.xxhash64_fixed_rows(schema, seed, n)
    else:
        h = kernels.murmur3_fixed_rows(schema, seed, n)
    return Column(out_dt, n, data=h)


def murmur_hash3_32(table: Union[Table, Sequence[Column]],
                    seed: int = DEFAULT_MURMUR_SEED) -> Column:
    """Spark murmur3_32 row hash -> INT32 column (Hash.java:40-56)."""
    return _hash_rows(_normalize_input(table), seed, "mm")


def xxhash64(table: Union[Table, Sequence[Column]],
             seed: int = DEFAULT_XXHASH64_SEED) -> Column:
    """Spark xxhash64 row hash -> INT64 column (Hash.java:70-90)."""
    return _hash_rows(_normalize_input(table), seed, "xx")
