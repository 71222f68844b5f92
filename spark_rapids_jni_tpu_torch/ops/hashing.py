"""Spark row hashes over fixed-width, STRING and nested columns:
MurmurHash3_32 and XXHash64.

The JAX package's ops/hashing.py. Spark's rules, as that module
reproduces them:

  * the running hash is chained across columns as the next column's seed,
    and a null element passes it through unchanged;
  * INT8/INT16 sign-extend to 4 bytes, BOOL8 hashes as ``!= 0``,
    DECIMAL32/64 hash as the 8 bytes of the sign-extended unscaled value,
    DECIMAL128 as the bytes of Java's
    ``BigDecimal.unscaledValue().toByteArray()``: the minimal big-endian
    two's complement, 1-16 bytes (``_dec128_java_bytes``);
  * murmur3 canonicalizes float NaNs only; xxhash64 canonicalizes NaNs
    and folds -0.0 into 0.0;
  * a string hashes its bytes: murmur3 mixes 4-byte little-endian blocks,
    then each tail byte SIGN-EXTENDED as a full block (not standard
    murmur3), then fmix with the length; xxhash64 runs 32-byte stripes,
    8-, 4- and 1-byte rounds (``_mm_bytes``, ``_xx_bytes``);
  * murmur3 of nested columns (Hash.java's flattening, ``_flatten_units``):
    a STRUCT hashes its fields depth first, each leaf with the STRUCT's
    validity ANDed over its own; a LIST hashes its leaf elements in order,
    each element's hash the seed of the next, null elements skipped and a
    null row passing the running hash through; a LIST<LIST<...>> composes
    its offsets into one element range per row (``_compose_chain``). A
    LIST of STRUCT raises ValueError, nesting deeper than
    ``MAX_STACK_DEPTH`` raises ValueError, and xxhash64 of any nested
    column raises TypeError.

The per-type normalization (``_fixed_element_words``) runs here in torch;
the chained mixing of whole rows, strings included, runs in the CUDA
kernels B1 (murmur3) and B2 (xxhash64) behind ops/kernels.py, whose plain
versions are built from the mixing functions below (strings over their
zero-padded bytes, columnar/strings.py). A DECIMAL128 column enters
them as a "str" entry of its Java bytes, a flattened STRUCT leaf as the
entry of its type with the combined validity, and a LIST unit as B1's
"list" entry: each row's [start, end) range over the leaf and the leaf's
own entry and validity.

torch has no shift, add or compare for uint32/uint64, so these mixing
functions hold a u32 value in an int64 tensor masked to its low 32 bits,
and a u64 value as the int64 of the same bits (int64 multiply and add wrap
as u64 does; a logical right shift is ``_lsr``). They run the same on the
CPU and on the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table
from ..columnar.dtype import DType, TypeId
from . import kernels

DEFAULT_MURMUR_SEED = 42  # Hash.java:33
DEFAULT_XXHASH64_SEED = 42
MAX_STACK_DEPTH = 8  # Hash.java:28

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


def _bytes4_to_u32(b0, b1, b2, b3):
    """Little-endian u32 (in int64) of four byte lanes."""
    return (b0.to(torch.int64) | (b1.to(torch.int64) << 8)
            | (b2.to(torch.int64) << 16) | (b3.to(torch.int64) << 24))


def _mm_bytes(h, mat, lengths):
    """murmur3 of variable-length bytes: padded ``uint8[n, L]`` and
    ``[n]`` lengths, seeds ``h`` (compute_bytes, murmur_hash.cuh:95-119)."""
    n, L = mat.shape
    lengths = lengths.to(torch.int64)
    nblocks = lengths // 4
    for i in range(L // 4):
        k = _bytes4_to_u32(*(mat[:, 4 * i + j] for j in range(4)))
        h = torch.where(i < nblocks, _mm_block(h, k), h)
    # Spark's tail: each remaining byte sign-extended, a full block mix
    smat = mat.view(torch.int8)
    for i in range(min(3, L)):
        idx = (nblocks * 4 + i).clamp(0, L - 1)
        k = smat.gather(1, idx[:, None])[:, 0].to(torch.int64) & _M32
        h = torch.where(nblocks * 4 + i < lengths, _mm_block(h, k), h)
    return _mm_fmix(h, lengths)


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


def _xx_round1(h, b):
    h = h ^ (b * _P5)
    return _rotl64(h, 11) * _P1


def _gather_bytes_le(mat, idx, nbytes: int):
    """The ``nbytes`` little-endian bytes of each row at byte ``idx``
    (positions past the row clipped: callers mask those rows)."""
    L = mat.shape[1]
    pos = (idx[:, None] + torch.arange(nbytes, device=mat.device)).clamp(
        0, L - 1)
    b = mat.gather(1, pos).to(torch.int64)
    out = b[:, 0]
    for i in range(1, nbytes):
        out = out | (b[:, i] << (8 * i))
    return out


def _gather_u64(mat, idx):
    return _gather_bytes_le(mat, idx, 8)


def _gather_u32(mat, idx):
    return _gather_bytes_le(mat, idx, 4)


def _xx_bytes(seed, mat, lengths):
    """xxhash64 of variable-length bytes: padded ``uint8[n, L]`` and
    ``[n]`` lengths, seeds ``seed`` (compute_bytes, xxhash64.cu:109-175)."""
    n, L = mat.shape
    lengths = lengths.to(torch.int64)
    nstripes = lengths // 32
    h = seed + _P5
    if L >= 32:
        v = [seed + _s64(_P1 + _P2), seed + _P2, seed, seed - _P1]

        def vround(acc, k):
            return _rotl64(acc + k * _P2, 31) * _P1

        for s in range(L // 32):
            active = s < nstripes
            base = torch.full((n,), s * 32, dtype=torch.int64,
                              device=mat.device)
            v = [torch.where(active,
                             vround(acc, _gather_u64(mat, base + 8 * j)), acc)
                 for j, acc in enumerate(v)]
        merged = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12)
                  + _rotl64(v[3], 18))
        for acc in v:
            merged = (merged ^ vround(0, acc)) * _P1 + _P4
        h = torch.where(lengths >= 32, merged, h)
    h = h + lengths
    offset = nstripes * 32
    n8 = (lengths - offset) // 8
    if L >= 8:
        for i in range(3):
            k = _gather_u64(mat, offset + 8 * i)
            h = torch.where(i < n8, _xx_round8(h, k), h)
    offset = offset + n8 * 8
    if L >= 4:
        has4 = (lengths % 8) >= 4
        h = torch.where(has4, _xx_round4(h, _gather_u32(mat, offset)), h)
        offset = offset + torch.where(has4, 4, 0)
    for i in range(min(3, L)):
        b = mat.gather(1, (offset + i).clamp(0, L - 1)[:, None])[:, 0]
        h = torch.where(offset + i < lengths,
                        _xx_round1(h, b.to(torch.int64)), h)
    return _xx_final(h)


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
    every value whose exponent field is zero (±0.0 and the subnormals)
    folded into +0.0 when ``normalize_zero``: the JAX package's ``x ==
    0.0`` runs under XLA:CPU's denormals-are-zero, which makes a float32
    subnormal equal 0.0. The test is on the bits, so it holds on any
    backend and denormal mode."""
    bits = x.view(torch.int32)
    bits = torch.where((bits & 0x7FFFFFFF) > 0x7F800000, 0x7FC00000, bits)
    if normalize_zero:
        bits = torch.where((bits & 0x7F800000) == 0, 0, bits)
    return bits


def _f64_bits(x: torch.Tensor, normalize_zero: bool) -> torch.Tensor:
    """int64 bits of float64 values: NaNs canonical
    (0x7FF8000000000000), and -0.0 folded into 0.0 when
    ``normalize_zero`` (by the bits, as the JAX package tests its
    bit-pattern storage: float64 subnormals are kept)."""
    bits = x.view(torch.int64)
    bits = torch.where((bits & 0x7FFFFFFFFFFFFFFF) > 0x7FF0000000000000,
                       0x7FF8000000000000, bits)
    if normalize_zero:
        bits = torch.where((bits & 0x7FFFFFFFFFFFFFFF) == 0, 0, bits)
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
    if tid in (TypeId.STRING, TypeId.DECIMAL128):
        raise TypeError(f"a {tid.name} column hashes its bytes (the "
                        f"\"str\" schema entry of _hash_rows), not "
                        f"fixed-width words")
    # DICT32, RLE and FOR: the JAX package's TypeError (a join aligns
    # dictionary codes, and decodes run and packed keys, before hashing)
    raise TypeError(f"unsupported hash element type {col_dtype}")


def _dec128_java_bytes(limbs: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32[n, 4] limbs -> (uint8[n, 16] big-endian minimal two's
    complement bytes, zero padded; int64[n] lengths 1-16): Java's
    BigInteger.toByteArray (hash.cuh:63-102)."""
    n = limbs.shape[0]
    le = limbs.contiguous().view(torch.uint8).reshape(n, 16)
    is_neg = limbs[:, 3] < 0
    fill = torch.where(is_neg, 0xFF, 0).to(torch.uint8)
    pos = torch.arange(16, device=limbs.device)
    length = torch.where(le != fill[:, None], pos + 1, 0).amax(dim=1) \
        .clamp(min=1)
    # a sign byte where the top kept byte's sign bit says otherwise
    top = le.gather(1, (length - 1)[:, None])[:, 0]
    length = torch.where((length < 16) & (is_neg ^ (top >= 0x80)),
                         length + 1, length)
    be = le.gather(1, (length[:, None] - 1 - pos).clamp(0, 15))
    return torch.where(pos < length[:, None], be, 0), length


def dec128_hash_words(col: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    """A DECIMAL128 column's "str" schema words: (int32[n+1] offsets,
    uint8 characters) of its Java bytes."""
    be, length = _dec128_java_bytes(col.data)
    offsets = torch.zeros(col.size + 1, dtype=torch.int32,
                          device=be.device)
    torch.cumsum(length, 0, dtype=torch.int32, out=offsets[1:])
    pos = torch.arange(16, device=be.device)
    return offsets, be[pos < length[:, None]]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _normalize_input(table: Union[Table, Sequence[Column]]
                     ) -> Tuple[Column, ...]:
    if isinstance(table, Table):
        return table.columns
    return tuple(table)


class _HashUnit:
    """A flattened hashable column: a leaf column, its effective validity
    (the parents' ANDed over its own) and, for a LIST unit, the offsets of
    its LIST levels from the outer one in."""

    def __init__(self, col: Column, valid: Optional[torch.Tensor],
                 list_chain: Sequence[torch.Tensor] = ()):
        self.col = col
        self.valid = valid
        self.list_chain = tuple(list_chain)


def _and_valid(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _flatten_units(col: Column, parent_valid: Optional[torch.Tensor],
                   depth: int = 0) -> List[_HashUnit]:
    if depth > MAX_STACK_DEPTH:
        raise ValueError("max nesting depth exceeded")
    eff = _and_valid(parent_valid, col.validity)
    tid = col.dtype.id
    if tid is TypeId.STRUCT:
        units: List[_HashUnit] = []
        for ch in col.children:
            units.extend(_flatten_units(ch, eff, depth + 1))
        return units
    if tid is TypeId.LIST:
        chain = [col.offsets]
        cur = col.children[0]
        while cur.dtype.id is TypeId.LIST:
            chain.append(cur.offsets)
            cur = cur.children[0]
        if cur.dtype.id is TypeId.STRUCT:
            raise ValueError(
                "Cannot compute hash of a table with a LIST of STRUCT "
                "columns.")
        return [_HashUnit(cur, eff, chain)]
    return [_HashUnit(col, eff)]


def _compose_chain(chain: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 [start, end) of each outer row over the innermost leaf."""
    starts, ends = chain[0][:-1], chain[0][1:]
    for offs in chain[1:]:
        starts = offs.index_select(0, starts.to(torch.int64))
        ends = offs.index_select(0, ends.to(torch.int64))
    return starts.contiguous(), ends.contiguous()


def _leaf_entry(col: Column, for_xx: bool):
    """(kind, words) of a flat column: "str" for STRING and DECIMAL128
    bytes, else its fixed-width words."""
    if col.dtype.id is TypeId.STRING:
        return "str", (col.offsets, col.data)
    if col.dtype.id is TypeId.DECIMAL128:
        return "str", dec128_hash_words(col)
    return _fixed_element_words(col.dtype, col.data, for_xx)


def _hash_rows(columns: Tuple[Column, ...], seed: int, algo: str) -> Column:
    """Seed-chain ``algo`` ("mm" or "xx") across the columns' hash units
    (``_flatten_units``); the mixing runs in kernel B1 or B2
    (ops/kernels.py), one launch for the whole row (more past
    ``kernels.MAX_HASH_COLUMNS`` units)."""
    for_xx = algo == "xx"
    out_dt = dt.INT64 if for_xx else dt.INT32
    if not columns:
        return Column(out_dt, 0, data=torch.zeros(0,
                                                  dtype=out_dt.torch_dtype))
    n = columns[0].size
    units: List[_HashUnit] = []
    for c in columns:
        if for_xx and c.dtype.is_nested:
            raise TypeError("xxhash64 does not support nested types")
        units.extend(_flatten_units(c, None))
    schema = []
    for u in units:
        kind, words = _leaf_entry(u.col, for_xx)
        if u.list_chain:
            starts, ends = _compose_chain(u.list_chain)
            words = (starts, ends, kind, words, u.col.validity)
            kind = "list"
        schema.append((kind, words, u.valid))
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
