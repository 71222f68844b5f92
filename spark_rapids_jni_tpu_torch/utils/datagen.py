"""Seeded benchmark data (the JAX package's utils/datagen.py).

Per-type value distributions (uniform, normal, geometric, with bounds),
null frequency, a pool of distinct values (cardinality), geometric runs of
repeated values and string lengths: the reference's data_profile. The
numpy draws are the JAX package's, call for call, so one seed gives the
same column in both packages, bit for bit.

A STRING column's bytes are expanded on the column's device: the JAX
package indexes every output byte on the host, which at 60M rows of ~16
bytes takes int64 index arrays of ~7.7 GB each. Here the pool is padded
to a ``uint8[cardinality, L]`` matrix, the rows gather their pool rows in
chunks, and a mask keeps each row's bytes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table, resolve_device
from ..columnar.dtype import DType, TypeId

UNIFORM = "uniform"
NORMAL = "normal"
GEOMETRIC = "geometric"

# rows of one chunk of the string expansion
_EXPAND_ROWS = 1 << 22


@dataclass(frozen=True)
class Dist:
    """A bounded sampling distribution; GEOMETRIC concentrates samples
    near ``lower``."""

    kind: str = UNIFORM
    lower: float = 0.0
    upper: float = 1.0


def _int_upper(dtype: DType) -> int:
    bits = min(dtype.itemsize * 8, 63)
    if dtype.id in (TypeId.UINT8, TypeId.UINT16, TypeId.UINT32,
                    TypeId.UINT64):
        return (1 << bits) - 1
    return (1 << (bits - 1)) - 1


def _default_dist(dtype: DType) -> Dist:
    """Timestamps and unsigned integers geometric, signed integers and
    decimals uniform over their range, floats normal."""
    tid = dtype.id
    if tid.value.startswith("timestamp"):
        return Dist(GEOMETRIC, 0, 2_000_000_000)
    if tid in (TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64):
        return Dist(GEOMETRIC, 0, _int_upper(dtype))
    if dtype.is_integral or dtype.is_decimal:
        return Dist(UNIFORM, -_int_upper(dtype) - 1, _int_upper(dtype))
    if dtype.is_floating:
        return Dist(NORMAL, -1e5, 1e5)
    return Dist(UNIFORM, 0, 1)


@dataclass(frozen=True)
class ColumnProfile:
    """How one column is generated."""

    dtype: DType
    dist: Optional[Dist] = None            # value distribution
    null_frequency: Optional[float] = 0.01
    cardinality: int = 2000                # 0 = unbounded distinct values
    avg_run_length: int = 4                # 1 = no runs
    string_len: Dist = field(default_factory=lambda: Dist(NORMAL, 0, 32))
    bool_probability: float = 0.5


def _sample(dist: Dist, n: int, rng: np.random.Generator,
            integral: bool) -> np.ndarray:
    lo, hi = float(dist.lower), float(dist.upper)
    span = max(hi - lo, 1e-9)
    if dist.kind == UNIFORM:
        vals = rng.uniform(lo, hi, n)
    elif dist.kind == NORMAL:
        vals = np.clip(rng.normal((lo + hi) / 2, span / 6, n), lo, hi)
    elif dist.kind == GEOMETRIC:
        vals = np.clip(lo + rng.exponential(span / 4, n), lo, hi)
    else:
        raise ValueError(f"unknown distribution {dist.kind!r}")
    if integral:
        vals = np.clip(vals, -9.223372036854775e18, 9.223372036854775e18)
        return np.floor(vals).astype(np.int64)
    return vals


def _with_runs(n: int, arl: int, rng: np.random.Generator,
               draw) -> np.ndarray:
    """n values in geometric runs averaging ``arl``."""
    if arl <= 1:
        return draw(n)
    n_runs = max(1, int(np.ceil(n / arl * 1.5)))
    lengths = rng.geometric(1.0 / arl, n_runs)
    vals = draw(n_runs)
    out = np.repeat(vals, lengths)
    while out.shape[0] < n:
        more = draw(n_runs)
        out = np.concatenate(
            [out, np.repeat(more, rng.geometric(1.0 / arl, n_runs))])
    return out[:n]


def _pooled(cardinality: int, rng: np.random.Generator, sample_pool):
    """A draw routed through a pool of ``cardinality`` distinct values
    (unbounded when cardinality <= 0)."""
    if cardinality <= 0:
        return sample_pool
    pool = sample_pool(cardinality)

    def draw(k):
        return pool[rng.integers(0, len(pool), k)]
    return draw


def generate_column(n: int, profile: ColumnProfile, seed: int = 0,
                    device="cuda") -> Column:
    """One seeded column per the profile, on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    p = profile
    dtype = p.dtype
    tid = dtype.id
    valid = (rng.random(n) >= p.null_frequency
             if p.null_frequency is not None and p.null_frequency > 0
             else None)
    if tid is TypeId.STRING:
        return _generate_strings(n, p, rng, valid, dev)
    if tid is TypeId.BOOL8:
        def sample_bool(k):
            return (rng.random(k) < p.bool_probability).astype(np.uint8)
        vals = _with_runs(n, p.avg_run_length, rng, sample_bool)
        return Column.from_numpy(vals, dtype, validity=valid, device=dev)
    dtype.require_stored()
    dist = p.dist or _default_dist(dtype)

    def sample_fixed(k):
        return _sample(dist, k, rng, not dtype.is_floating)

    vals = _with_runs(n, p.avg_run_length, rng,
                      _pooled(p.cardinality, rng, sample_fixed))
    if tid is TypeId.DECIMAL128:  # int64 draws, sign-extended to limbs
        return Column.from_numpy(decimal128_limbs(vals), dtype,
                                 validity=valid, device=dev)
    return Column.from_numpy(vals.astype(dtype.np_dtype), dtype,
                             validity=valid, device=dev)


def decimal128_limbs(vals: np.ndarray) -> np.ndarray:
    """int64 unscaled values -> uint32[n, 4] DECIMAL128 limbs (sign
    extended)."""
    v = np.ascontiguousarray(vals, dtype=np.int64)
    out = np.empty((v.shape[0], 4), dtype=np.uint32)
    out[:, :2] = v.view(np.uint32).reshape(-1, 2)
    out[:, 2:] = np.where(v < 0, 0xFFFFFFFF, 0).astype(np.uint32)[:, None]
    return out


@dataclass(frozen=True)
class StringDraws:
    """The numpy draws of a STRING column: a pool of strings and, per row,
    its pool entry and length (0 for a null row)."""

    pool_lengths: np.ndarray   # int64[card]
    pool_offsets: np.ndarray   # int64[card + 1]
    pool_chars: np.ndarray     # uint8[pool_offsets[-1]]
    index: np.ndarray          # int64[n]: the pool entry of each row
    lengths: np.ndarray        # int64[n]

    def pool_strings(self) -> list:
        """The pool's strings as bytes."""
        return [self.pool_chars[a:b].tobytes() for a, b in
                zip(self.pool_offsets[:-1], self.pool_offsets[1:])]


_ALPHABET = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 _-",
    dtype=np.uint8)


def string_draws(n: int, p: ColumnProfile, rng: np.random.Generator,
                 valid) -> StringDraws:
    """The JAX package's draws for a STRING column, in its order."""
    card = p.cardinality if p.cardinality > 0 else max(n, 1)
    pool_lengths = np.maximum(
        _sample(p.string_len, card, rng, integral=True), 0)
    pool_offs = np.zeros(card + 1, dtype=np.int64)
    np.cumsum(pool_lengths, out=pool_offs[1:])
    pool_chars = _ALPHABET[rng.integers(0, len(_ALPHABET),
                                        int(pool_offs[-1]))]
    idx = _with_runs(n, p.avg_run_length, rng,
                     lambda k: rng.integers(0, card, k))
    lengths = pool_lengths[idx]
    if valid is not None:
        lengths = np.where(valid, lengths, 0)  # nulls carry no bytes
    return StringDraws(pool_lengths, pool_offs, pool_chars, idx, lengths)


def _generate_strings(n: int, p: ColumnProfile, rng: np.random.Generator,
                      valid, dev: torch.device) -> Column:
    d = string_draws(n, p, rng, valid)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(d.lengths, out=offs[1:])
    if offs[-1] >= 1 << 31:
        raise ValueError("STRING column over 2^31 bytes: int32 offsets")
    width = max(1, int(d.pool_lengths.max(initial=0)))
    pool = np.zeros((len(d.pool_lengths), width), dtype=np.uint8)
    keep = np.arange(width) < d.pool_lengths[:, None]
    pool[keep] = d.pool_chars
    pool_t = torch.from_numpy(pool).to(dev)
    at = torch.arange(width, device=dev)
    parts = []
    for r0 in range(0, n, _EXPAND_ROWS):
        idx = torch.from_numpy(d.index[r0:r0 + _EXPAND_ROWS]).to(dev)
        ln = torch.from_numpy(d.lengths[r0:r0 + _EXPAND_ROWS]).to(dev)
        parts.append(pool_t.index_select(0, idx)[at < ln[:, None]])
    chars = (torch.cat(parts) if parts
             else torch.zeros(0, dtype=torch.uint8, device=dev))
    vmask = None if valid is None else torch.from_numpy(valid).to(dev)
    return Column(dt.STRING, n, data=chars, validity=vmask,
                  offsets=torch.from_numpy(offs.astype(np.int32)).to(dev))


def generate_table(n: int, profiles: Sequence[ColumnProfile],
                   seed: int = 0, device="cuda") -> Table:
    """A table; column i uses ``seed + i``."""
    return Table(tuple(generate_column(n, p, seed + i, device)
                       for i, p in enumerate(profiles)))


# The JAX package's string row-conversion table
# (benchmarks/bench_ops.py:109-137): INT64, INT32 in [0, 100), FLOAT64,
# BOOL8 from one generator, and a STRING column of 1000 pooled strings of
# 0-32 ASCII bytes in runs of mean 4.
STRING_ROWS_PROFILE = ColumnProfile(
    dt.STRING, string_len=Dist(NORMAL, 0, 32), cardinality=1000,
    null_frequency=None)


def string_rows_table(rows: int, seed: int = 0, device="cuda") -> Table:
    """The string row-conversion table of the JAX package's bench_ops.py
    at ``rows`` rows, on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cols = [
        Column.from_numpy(rng.integers(-2**31, 2**31, rows), dt.INT64,
                          device=dev),
        Column.from_numpy(rng.integers(0, 100, rows).astype(np.int32),
                          dt.INT32, device=dev),
        Column.from_numpy(rng.standard_normal(rows), dt.FLOAT64,
                          device=dev),
        Column.from_numpy(rng.integers(0, 2, rows).astype(np.uint8),
                          dt.BOOL8, device=dev),
        generate_column(rows, STRING_ROWS_PROFILE, seed=seed, device=dev),
    ]
    return Table(tuple(cols))


def random_bytes_column(n: int, max_len: int, null_frequency: float = 0.0,
                        seed: int = 0, device="cuda") -> Column:
    """A STRING column of ``n`` strings of uniform random bytes 0-255
    (UTF-8 multibyte sequences and invalid UTF-8 included), lengths uniform
    in [0, max_len], a ``null_frequency`` share null (with their bytes):
    the input that reaches every branch of the byte hashes."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len + 1, n)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offs[1:])
    chars = rng.integers(0, 256, int(offs[-1]), dtype=np.uint8)
    valid = rng.random(n) >= null_frequency if null_frequency else None
    return Column(dt.STRING, n, data=torch.from_numpy(chars).to(dev),
                  validity=None if valid is None
                  else torch.from_numpy(valid).to(dev),
                  offsets=torch.from_numpy(offs.astype(np.int32)).to(dev))


# float bits a float aggregate has to carry through exactly: NaNs of both
# signs and several payloads (one signaling), ±0, ±inf, subnormals, the
# smallest normals and values whose sums underflow
_F64_EDGE_BITS = np.array([
    0x0000000000000000, 0x8000000000000000, 0x7FF0000000000000,
    0xFFF0000000000000, 0x7FF8000000000000, 0x7FF8000000000042,
    0xFFF8000000000001, 0x7FF0000000000001, 0x0000000000000001,
    0x800000000000DEAD, 0x000FFFFFFFFFFFFF, 0x0010000000000000,
    0x8010000000000000, 0x0018000000000000, 0x8014000000000000,
    0x3FF8000000000000, 0xC002000000000000, 0x7FEFFFFFFFFFFFFF,
], dtype=np.uint64)
_F32_EDGE_BITS = np.array([
    0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
    0x7FC00005, 0xFF800123, 0x7F800001, 0x00000001, 0x80400000,
    0x00800000, 0x80800000, 0x3FC00000, 0xC0100000, 0x7F7FFFFF,
], dtype=np.uint32)


def float_edge_table(n: int, seed: int = 0, device="cuda") -> Table:
    """(INT32 key, FLOAT64, FLOAT32) with about 16 rows a key: values drawn
    from the edge bits above and from normals scaled across the whole
    exponent range (so sums underflow and overflow), 10% nulls, keys that
    are all null in both value columns, one-row keys, and keys whose rows
    are a subnormal of negative sign (flushed to -0.0) followed by a null
    row (its +0.0 turns the sum to +0.0). The last value rows of a key come
    in table order, as a stable sort keeps them."""
    rng = np.random.default_rng(seed)
    n_keys = max(1, n // 16)
    key = rng.integers(0, n_keys, n).astype(np.int32)
    f64 = (rng.standard_normal(n)
           * 10.0 ** rng.integers(-320, 308, n)).view(np.uint64)
    edge = rng.random(n) < 0.4
    f64[edge] = _F64_EDGE_BITS[rng.integers(0, len(_F64_EDGE_BITS),
                                            int(edge.sum()))]
    f32 = rng.standard_normal(n).astype(np.float32).view(np.uint32)
    edge = rng.random(n) < 0.4
    f32[edge] = _F32_EDGE_BITS[rng.integers(0, len(_F32_EDGE_BITS),
                                            int(edge.sum()))]
    v64 = rng.random(n) > 0.1
    v32 = rng.random(n) > 0.1
    m = max(4, n // 1000)
    if n >= 4 * m:
        # one-row keys, all-null keys, then (-subnormal, null) pairs
        key[:m] = n_keys + np.arange(m)
        key[m:2 * m] = n_keys + m + np.arange(m) // 2
        v64[m:2 * m] = v32[m:2 * m] = False
        key[2 * m:4 * m] = n_keys + 2 * m + np.arange(2 * m) // 2
        f64[2 * m:4 * m:2] = 0x800000000000DEAD
        f32[2 * m:4 * m:2] = 0x80400000
        v64[2 * m:4 * m] = v32[2 * m:4 * m] = True
        v64[2 * m + 1:4 * m:2] = v32[2 * m + 1:4 * m:2] = False
    return Table((
        Column.from_numpy(key, dt.INT32, device=device),
        Column.from_numpy(f64.view(np.float64), dt.FLOAT64, validity=v64,
                          device=device),
        Column.from_numpy(f32.view(np.float32), dt.FLOAT32, validity=v32,
                          device=device)))


# rows whose sequential sum passes through a subnormal partial sum (t =
# 2^-1022, the smallest normal): each starts from a sum of exactly ±0
_T = 2.0 ** -1022
SUBNORMAL_SUM_PATTERNS = {
    # 2t, then 0.5t (subnormal), then 1.5t; the flushed sum: 2t, 0, t
    "back_to_normal": (2 * _T, -1.5 * _T, _T),
    # 2t, 0.5t (subnormal), -1.5t, then +0.0; the flushed sum ends at -0.0
    "back_to_zero": (2 * _T, -1.5 * _T, -2 * _T, 1.5 * _T),
    # ends on 0.5t (subnormal); the flushed sum ends at +0.0
    "ends_subnormal": (2 * _T, -1.5 * _T),
}
SUBNORMAL_SUM_LENGTHS = (2, 3, 4, 31, 33, 40, 255, 257, 300, 513, 700, 1500)


def subnormal_sum_table(n_segments: int = 72, seed: int = 0,
                        device="cuda") -> Table:
    """(INT32 key, FLOAT64 value) whose groups' sequential sums pass
    through subnormal partial sums, so that the flushed sum of the
    reference differs from an unflushed one: each group of a length from
    ``SUBNORMAL_SUM_LENGTHS`` holds one of ``SUBNORMAL_SUM_PATTERNS`` (or,
    one group in six, none), at its first row, across a 32-row or a
    256-row boundary, or ending at its last row, sign flipped in half of
    the groups. The other rows bring the sum back to exactly ±0: pairs
    (v, -v) of normals drawn across the exponent range, +0.0 rows and
    masked rows (their values tiny, huge or NaN). Groups are contiguous,
    their keys a permutation."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    vals, valid, keys = [], [], []
    perm = rng.permutation(n_segments)
    kinds = list(SUBNORMAL_SUM_PATTERNS)
    for g in range(n_segments):
        n = SUBNORMAL_SUM_LENGTHS[g % len(SUBNORMAL_SUM_LENGTHS)]
        kind = None if g % 6 == 5 else kinds[g % len(kinds)]
        pat = np.array(SUBNORMAL_SUM_PATTERNS[kind] if kind else (),
                       dtype=np.float64) * (-1.0 if g % 2 else 1.0)
        if kind == "ends_subnormal" or len(pat) > n:
            at = max(0, n - len(pat))
        else:
            at = [0, 30, 31, 254, 255, n - len(pat)][g % 6]
            at = min(at, n - len(pat))
        v = np.zeros(n)
        ok = np.ones(n, dtype=bool)
        for lo, hi in ((0, at), (at + len(pat), n)):
            i = lo
            while i < hi:
                r = rng.random()
                if r < 0.6 and i + 1 < hi:  # a pair that cancels exactly
                    x = rng.standard_normal() * 2.0 ** rng.integers(-960,
                                                                    960)
                    v[i], v[i + 1] = x, -x
                    i += 2
                    continue
                if r < 0.8:  # a masked row adds +0.0 in its place
                    ok[i] = False
                    v[i] = rng.choice([2 * _T, 1e300, np.nan, -_T / 4])
                i += 1
        v[at:at + len(pat)] = pat[:n]
        vals.append(v)
        valid.append(ok)
        keys.append(np.full(n, perm[g], dtype=np.int32))
    return Table((
        Column.from_numpy(np.concatenate(keys), dt.INT32, device=dev),
        Column.from_numpy(np.concatenate(vals), dt.FLOAT64,
                          validity=np.concatenate(valid), device=dev)))


def decimal128_draws(n: int, rng: np.random.Generator,
                     max_digits: int = 38) -> list:
    """n signed Python ints of 0..``max_digits`` decimal digits (the digit
    count uniform), the edges of DECIMAL128 among them: 0, +-1,
    +-(10^38 - 1), +-10^37 and the int128 extremes."""
    digits = rng.integers(0, max_digits + 1, n)
    out = []
    for k in digits.tolist():
        v = int.from_bytes(rng.bytes(17), "little") % (10 ** k)
        out.append(-v if rng.random() < 0.5 else v)
    edges = [0, 1, -1, 10 ** 38 - 1, -(10 ** 38 - 1), 10 ** 37, -10 ** 37,
             (1 << 127) - 1, -(1 << 127)]
    out[:min(n, len(edges))] = edges[:n]
    return out


def decimal128_column(values, scale: int, valid=None,
                      device="cuda") -> Column:
    """DECIMAL128 column of unscaled Python ints at a Java scale."""
    from ..columnar.column import int128_to_limbs
    limbs = np.stack([int128_to_limbs(int(v)) for v in values]) if len(
        values) else np.zeros((0, 4), np.uint32)
    return Column.from_numpy(limbs, dt.decimal128(scale), validity=valid,
                             device=device)


# (Java scales a, b -> out) per op of the edge table: -10..38, with the
# 38-digit results, rescales both ways and each divide branch
_EDGE_SCALES = {
    "add": [(0, 0, 0), (10, 10, 9), (-5, 3, -5), (38, 0, 10),
            (2, 38, 38)],
    "sub": [(0, 0, 0), (10, 2, 9), (-10, 10, 0), (2, 2, 2)],
    "multiply": [(10, 10, 6), (0, 0, 0), (2, 2, 4), (1, -1, 1),
                 (20, 18, 38), (-10, -10, -20), (38, 0, 0)],
    "divide": [(1, 0, 1), (10, 10, 6), (2, 20, 17), (0, 0, 38),
               (38, 0, 0), (-10, 0, 6), (0, 38, 10)],
    "integer_divide": [(2, 2, 0), (2, 3, 0), (0, 0, 0), (38, 0, 0),
                       (-10, 10, 0)],
    "remainder": [(0, 1, 1), (2, 1, 2), (0, 12, 7), (0, 10, 10),
                  (10, 0, 38), (-10, 5, 0)],
}


def decimal128_edge_cases(rows: int = 512, seed: int = 0, device="cuda"):
    """The edge table of kernel H2: a list of (op, a, b, out scale,
    cast_interim_result) over DECIMAL128 columns of ``rows`` rows. Values
    of every digit count (decimal128_draws), 5% nulls, zero divisors,
    each op at Java scales from -10 to 38 (every branch of the division
    and the rescales, overflow in each op), multiply with and without the
    interim cast, the SPARK-40129 vectors of the JAX package's tests, and
    quotients past int64 for integer_divide (its overflow is judged on
    the 128-bit quotient). Every case keeps its powers of ten within
    10^0..10^76: none raises."""
    rng = np.random.default_rng(seed)
    interim = [33583773388230965117849476564650294583,
               71610217851860101571101375465940777916,
               91735941859980016076428384215479932913]
    cases = []
    for op, scales in _EDGE_SCALES.items():
        for a_s, b_s, o_s in scales:
            a = decimal128_draws(rows, rng)
            b = decimal128_draws(rows, rng, 20 if "div" in op or
                                 op == "remainder" else 38)
            if op == "multiply" and (a_s, b_s) == (10, 10):
                a[-3:] = interim
                b[-3:] = [-120000000000] * 3
            if op in ("divide", "integer_divide", "remainder"):
                for i in np.flatnonzero(rng.random(rows) < 0.05):
                    b[i] = 0  # division by zero
            if op == "integer_divide":
                a[-2:] = [10 ** 30, -(10 ** 37)]
                b[-2:] = [3, 7]
            va = rng.random(rows) >= 0.05
            vb = rng.random(rows) >= 0.05
            cols = (decimal128_column(a, a_s, va, device),
                    decimal128_column(b, b_s, vb, device))
            for cast in ((True, False) if op == "multiply" else (True,)):
                cases.append((op, *cols, o_s, cast))
    return cases


_I128 = 1 << 127


def _of_bits(bits: int, rng: np.random.Generator) -> int:
    """A value of exactly ``bits`` bits (1 <= bits <= 127)."""
    low = int.from_bytes(rng.bytes(16), "little") % (1 << (bits - 1))
    return (1 << (bits - 1)) | low


def _data_divisors(rows: int, lengths, rng: np.random.Generator) -> list:
    """Signed divisors of the given bit lengths of their magnitude (128:
    -2^127), cycled over ``rows``."""
    out = []
    for i in range(rows):
        bits = lengths[i % len(lengths)]
        v = -_I128 if bits == 128 else _of_bits(bits, rng)
        out.append(-v if bits < 128 and rng.random() < 0.5 else v)
    return out


def _numerators(divisors, rng: np.random.Generator) -> list:
    """For each divisor d, in turn: a multiple of d, d q + |d| - 1 (a
    remainder of |d| - 1), |d| (2^64 - 1) + r (a quotient digit of all
    ones), a random value below 2^127 and one below 2^64, each within
    DECIMAL128's 128-bit range (a random value where the others do not
    fit)."""
    out = []
    for i, d in enumerate(divisors):
        m = abs(d) or 1
        top = (_I128 - 1) // m
        q = int.from_bytes(rng.bytes(16), "little") % (top + 1)
        v = [m * q, m * q + m - 1 if q < top else m * q,
             m * (2**64 - 1) + int(rng.integers(0, 2**62)) % m,
             int.from_bytes(rng.bytes(16), "little") % _I128,
             int.from_bytes(rng.bytes(8), "little")][i % 5]
        if v >= _I128:
            v = int.from_bytes(rng.bytes(16), "little") % _I128
        out.append(-v if rng.random() < 0.5 else v)
    return out


def _pow10_numerators(k: int, rng: np.random.Generator) -> list:
    """Unsigned numerators for a division by 10^k that reach Algorithm D's
    hard cases: the window whose top words equal the normalised divisor's
    (a digit of 2^64 - 1, after an add-back), 10^k shifted with its low
    words cleared (q one too large: an add-back), exact multiples, ties
    of HALF_UP, remainders of 10^k - 1 and values of every word count;
    all below 2^127 10^38, so that x + y 10^38 holds them. (Exact
    multiples take the 3-by-2 step's second correction for some 10^k.)"""
    p = 10 ** k
    words = (p.bit_length() + 63) // 64
    s = 64 * words - p.bit_length()
    dn = p << s
    limit = _I128 * 10 ** 38
    vals = []
    if words >= 3:
        vals.append(((dn >> 64) << 128) >> s)        # top words equal
        vals.append(((dn >> 64) << 64) >> s)         # one word cleared
        vals.append(((dn >> 128) << 128) >> s)       # two words cleared
        vals.append((((dn >> 128) << 128) >> s) * 3)
    for i in range(16):
        q = int.from_bytes(rng.bytes(32), "little") % max(1, limit // p)
        vals += [p * q] + ([p * q + p // 2, p * q + p - 1] if i < 4 else [])
    for bits in (0, 1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 250):
        vals.append(int.from_bytes(rng.bytes(32), "little") % (1 << bits)
                    if bits else 0)
    return [v for v in vals if v < limit]


def decimal128_division_cases(rows: int = 64, seed: int = 0,
                              device="cuda"):
    """The division table of kernel H2: a list of (op, a, b, out scale,
    cast_interim_result) over DECIMAL128 columns of ``rows`` rows (at
    least 64), built to reach every branch of H2's long division through
    the public ops: divisors from the data of every bit length 1-128
    (divide at each of its branches, shift < -38 included; integer
    divide; remainder), numerators of 0-4 64-bit words, every power of
    ten 10^1..10^39 as a divisor in multiply's interim cast and rescale
    (per row) and 10^39..10^76 in add's rescale of x + y 10^38 (x at
    scale 38, y at scale 0), Algorithm D's
    hard cases (multiples of d, remainders of d - 1, quotient digits of
    2^64 - 1, windows whose top words equal a power of ten's, add-backs),
    zero divisors, remainder's divisor that rescales to 0 and
    integer-divide quotients at the int64 edges, products at and beside
    powers of ten (precision10's edges). 5% nulls in each
    operand. Every case keeps its powers of ten within 10^0..10^76."""
    if rows < 64:
        raise ValueError("the division table needs at least 64 rows")
    rng = np.random.default_rng(seed)
    cases = []

    def case(op, scales, a, b, cast=True):
        a = a + decimal128_draws(rows - len(a), rng)
        b = b + decimal128_draws(rows - len(b), rng, 20)
        va = rng.random(rows) >= 0.05
        vb = rng.random(rows) >= 0.05
        cases.append((op, decimal128_column(a[:rows], scales[0], va,
                                            device),
                      decimal128_column(b[:rows], scales[1], vb, device),
                      scales[2], cast))

    def zeros(b):  # two zero divisors
        return b[:-2] + [0, 0]

    # divide, HALF_UP: every bit length of d; n of 1-2 words, then n x 10^38
    # (3-4 words), then the first division of shift > 0, then shift < -38
    for lengths in (range(1, 65), range(65, 129)):
        b = _data_divisors(64, list(lengths), rng)
        a = _numerators(b, rng)
        # the 2-by-1 step's second correction (q one too small)
        a[-4:-2] = [(2**64 - 2) * (2**62 + 1), (2**64 - 2) * (2**62 + 1) + 1]
        b[-4:-2] = [2**62 + 1, -(2**62 + 1)]
        case("divide", (0, 0, 0), a, zeros(b))
    odd = list(range(1, 129, 2))
    b = _data_divisors(64, odd, rng)
    case("divide", (0, 0, 38), _numerators(b, rng), zeros(b))
    b = _data_divisors(64, list(range(2, 129, 2)), rng)
    case("divide", (20, 0, 2), _numerators(b, rng), zeros(b))
    b = _data_divisors(64, odd[::-1], rng)
    case("divide", (0, 10, 60), _numerators(b, rng), zeros(b))
    # integer divide: quotients at the int64 edges (the low 64 bits of the
    # quotient are the result; overflow is judged on all of it)
    edges = [2**63 - 1, 2**63, 2**63 + 1, 2**64 - 1, 2**64, 2**64 + 1,
             -2**63, -2**63 - 1, -2**63 + 1, -(2**64)]
    a, b = [], []
    for i in range(64):
        q = edges[i % len(edges)]
        d = _of_bits(1 + i % 60, rng) * (-1 if i % 3 == 0 else 1)
        a.append(q * d + (d - 1 if i % 2 else 0))
        b.append(d)
    case("integer_divide", (0, 0, 0), a, zeros(b))
    b = _data_divisors(64, list(range(1, 65)), rng)
    case("integer_divide", (2, 0, 0), _numerators(b, rng), zeros(b))
    b = _data_divisors(64, list(range(64, 129)), rng)
    case("integer_divide", (0, 2, 0), _numerators(b, rng), zeros(b))
    # remainder: n by d directly; 11d's scales; a divisor that rescales to
    # 0 (|b| < 5 x 10^7 at d_shift 8); n x 10^38 by d
    b = _data_divisors(64, list(range(1, 129, 2)), rng)
    case("remainder", (0, 0, 0), _numerators(b, rng), zeros(b))
    b = _data_divisors(64, list(range(1, 65)), rng)
    case("remainder", (4, 2, 4), _numerators(b, rng), zeros(b))
    b = _data_divisors(64, list(range(1, 40)), rng)
    case("remainder", (0, 10, 2), _numerators(b, rng), zeros(b))
    b = _data_divisors(64, list(range(2, 129, 2)), rng)
    case("remainder", (0, 38, 38), _numerators(b, rng), zeros(b))
    # multiply: products of 39-77 digits, so that the interim cast divides
    # by 10^1..10^39 and the rescale to scale -38 by 10^0..10^37, per row
    a, b = [], []
    for i in range(64):
        total = 39 + i % 39
        da = max(1, min(38, total - int(rng.integers(1, 39))))
        db = min(38, max(1, total - da))
        a.append(int(10 ** (da - 1) * (1 + rng.random() * 8.99)))
        b.append(int(10 ** (db - 1) * (1 + rng.random() * 8.99)))
    a[-2:], b[-2:] = [_I128 - 1, -_I128], [_I128 - 1, -_I128]
    case("multiply", (0, 0, -38), a, b)
    # products at 10^13..10^76, one below it or one past it (precision10's
    # edges)
    a, b = [], []
    for i in range(64):
        k = 13 + i
        a.append(10 ** (k // 2))
        b.append(10 ** (k - k // 2) + (0, -1, 1)[i % 3])
    case("multiply", (0, 0, -38), a, b)
    # add: x + y 10^38 divided by 10^k in the rescale to scale 38 - k
    for k in range(39, 77):
        a, b = [], []
        for v in _pow10_numerators(k, rng)[:64]:
            y, x = divmod(v, 10 ** 38)
            sign = -1 if rng.random() < 0.5 else 1
            a.append(sign * x)
            b.append(sign * y)
        case("add", (38, 0, 38 - k), a, b)
    return cases


def tbl_decimal_strings(unscaled: torch.Tensor, frac_digits: int) -> Column:
    """A STRING column of non-negative unscaled decimals as TPC-H dbgen
    writes them in its ``.tbl`` files: ``frac_digits`` = 0 gives "17",
    2 gives "21168.23" and "0.04". Rendered on ``unscaled``'s device in
    torch digit ops (one character column at a time), independent of the
    casts that parse it back; one host read, the widest row."""
    v = unscaled.to(torch.int64)
    if v.numel() and bool((v < 0).any()):
        raise ValueError("tbl_decimal_strings renders non-negative values")
    scale = 10 ** frac_digits
    whole, frac = v // scale, v % scale
    nd = torch.ones_like(whole)  # digits of the whole part (0 has one)
    for k in range(1, 19):
        nd += (whole >= 10 ** k).to(torch.int64)
    point = 1 if frac_digits else 0
    lengths = nd + point + frac_digits
    width = int(lengths.max()) if v.numel() else 0
    pow10 = torch.tensor([10 ** k for k in range(19)], dtype=torch.int64,
                         device=v.device)
    mat = torch.zeros((v.shape[0], width), dtype=torch.uint8,
                      device=v.device)
    for j in range(width):
        e_whole = nd - 1 - j                      # the whole digit's power
        e_frac = frac_digits - (j - nd - point) - 1
        d_whole = (whole // pow10[e_whole.clamp(0, 18)]) % 10
        d_frac = (frac // pow10[e_frac.clamp(0, 18)]) % 10
        ch = torch.where(j < nd, 48 + d_whole,
                         torch.where(j < nd + point, ord("."), 48 + d_frac))
        mat[:, j] = torch.where(j < lengths, ch, 0).to(torch.uint8)
    keep = torch.arange(width, device=v.device)[None, :] < lengths[:, None]
    offsets = torch.zeros(v.shape[0] + 1, dtype=torch.int32, device=v.device)
    offsets[1:] = torch.cumsum(lengths, 0).to(torch.int32)
    return Column(dt.STRING, int(v.shape[0]), data=mat[keep],
                  offsets=offsets)


# ---------------------------------------------------------------------------
# web logs: a batch of URLs and of JSON events (the string device tiers'
# inputs; chip_smoke.py phase 15)
# ---------------------------------------------------------------------------

class _Tokens:
    """The byte strings a row layout is assembled from, each with an id."""

    def __init__(self):
        self.items = []
        self._ids = {}

    def add(self, toks) -> np.ndarray:
        out = []
        for t in toks:
            i = self._ids.get(t)
            if i is None:
                i = self._ids[t] = len(self.items)
                self.items.append(t)
            out.append(i)
        return np.asarray(out, dtype=np.int32)

    def lengths(self) -> np.ndarray:
        return np.fromiter((len(t) for t in self.items), np.int64,
                           len(self.items))


def _assemble(tokens: _Tokens, slots, valid: np.ndarray, device,
              chunk_rows: int = 1 << 21) -> Column:
    """STRING column whose row r is the concatenation over ``slots`` of
    token ``ids[r]`` (-1: nothing), cut to ``lens[r]`` bytes where a slot
    gives lengths; a null row holds no bytes. The draws cross to
    ``device`` once a slot; lengths, offsets and bytes are made there, the
    bytes a slot and a chunk of rows at a time."""
    dev = resolve_device(device)
    n = int(valid.shape[0])
    tlen = torch.from_numpy(tokens.lengths()).to(dev)
    valid_t = torch.from_numpy(valid.copy()).to(dev)
    sized = []
    row_len = torch.zeros(n, dtype=torch.int64, device=dev)
    for ids, lens in slots:
        it = torch.from_numpy(np.ascontiguousarray(ids, np.int32)).to(dev)
        ln = (torch.where(it >= 0, tlen[it.clamp(min=0).long()], 0)
              if lens is None else torch.from_numpy(
                  np.ascontiguousarray(lens, np.int64)).to(dev))
        ln = torch.where(valid_t, ln, 0)
        row_len += ln
        sized.append((it, ln))
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(row_len, 0, out=offsets[1:])
    width = int(tlen.max()) if len(tokens.items) else 1
    pool = np.zeros((len(tokens.items), width), dtype=np.uint8)
    for i, t in enumerate(tokens.items):
        pool[i, :len(t)] = np.frombuffer(t, np.uint8)
    pool_t = torch.from_numpy(pool).to(dev)
    data = torch.zeros(int(offsets[-1]), dtype=torch.uint8, device=dev)
    at = offsets[:-1].clone()
    for it, ln in sized:
        lk = int(ln.max()) if n else 0
        if lk:
            cols = torch.arange(lk, device=dev)
            for r0 in range(0, n, chunk_rows):
                r1 = min(n, r0 + chunk_rows)
                keep = cols[None, :] < ln[r0:r1, None]
                vals = pool_t[:, :lk].index_select(
                    0, it[r0:r1].clamp(min=0).long())
                pos = at[r0:r1, None] + cols
                data[pos[keep]] = vals[keep]
        at += ln
    return Column(dt.STRING, n, data=data,
                  validity=None if valid.all() else valid_t,
                  offsets=offsets.to(torch.int32))


_LOWER = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
_HEXCH = np.frombuffer(b"0123456789abcdef", np.uint8)


def _words(rng: np.random.Generator, k: int, lo: int, hi: int,
           alphabet=_LOWER) -> list:
    lens = rng.integers(lo, hi + 1, k)
    chars = rng.choice(alphabet, int(lens.sum()))
    ends = np.cumsum(lens)
    return [chars[e - ln:e].tobytes() for e, ln in zip(ends, lens)]


def _pick(rng: np.random.Generator, ids: np.ndarray, n: int,
          skew: int = 1) -> np.ndarray:
    """n draws from ``ids``, the first ones most often where skew > 1
    (u ** skew over the list, u uniform in [0, 1))."""
    if skew == 1:
        return ids[rng.integers(0, len(ids), n)]
    u = rng.random(n, dtype=np.float32)
    v = u.copy()
    for _ in range(skew - 1):
        v *= u
    return ids[np.minimum((v * len(ids)).astype(np.int32), len(ids) - 1)]


# kinds of invalid URL rows (all parts null): a raw space, a bad %
# escape, an unclosed '[' host, a byte that is not UTF-8
URL_INVALID_KINDS = ("space", "bad_percent", "unclosed_bracket",
                     "bad_utf8")


def weblog_urls(rows: int, seed: int = 0, device="cuda"):
    """A web log's URL column of ``rows`` rows, 60-200 bytes each (a
    uniform target length; a row's parts past it trim its query), and the
    draw: schemes http / https / ftp, 2% none (``//host/...``); hosts from
    50,000 domain names (a skewed draw), 1% IPv4, 0.1% bracketed IPv6;
    ports on 5%; paths of 1-5 segments; queries of 0-6 ``key=value`` pairs
    with ``%XX`` escapes, ``utm_source`` first on every third row;
    fragments on 3%; 0.5% invalid (``URL_INVALID_KINDS``); 1% null.

    Returns (STRING column on ``device``, dict of numpy per-row flags:
    ``valid``, ``invalid`` (kind index or -1), ``scheme``, ``query``,
    ``utm``)."""
    rng = np.random.default_rng(seed)
    n = rows
    tok = _Tokens()
    words = _words(rng, 3000, 2, 9,
                   np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789-_",
                                 np.uint8))
    tlds = [b"com", b"net", b"org", b"io", b"de", b"co.uk", b"fr", b"jp",
            b"info", b"app"]
    subs = [b"", b"www.", b"m.", b"api.", b"cdn.", b"shop."]
    labels = _words(rng, 50_000, 3, 14)
    domains = [subs[a] + lab + b"." + tlds[b] for lab, a, b in zip(
        labels, rng.integers(0, len(subs), 50_000),
        rng.integers(0, len(tlds), 50_000))]
    v4 = [b".".join(str(x).encode() for x in q)
          for q in rng.integers(0, 256, (2000, 4))]
    v6 = [b"[2001:db8:%x::%x]" % (a, b)
          for a, b in rng.integers(0, 0xFFFF, (200, 2))] + [b"[::1]"]
    schemes = tok.add([b"http://", b"https://", b"ftp://", b"//"])
    dom_ids, v4_ids, v6_ids = tok.add(domains), tok.add(v4), tok.add(v6)
    ports = tok.add([b":8080", b":443", b":8443", b":3000", b":80"])
    segs = tok.add([b"/" + w for w in words])
    keys = [b"id", b"q", b"page", b"ref", b"lang", b"sort", b"cat", b"s",
            b"sid", b"v", b"lim", b"off", b"tab", b"src", b"fmt", b"t"]
    first_keys = tok.add([b"?" + k + b"=" for k in keys])
    more_keys = tok.add([b"&" + k + b"=" for k in keys])
    esc = [b"%20", b"%2F", b"%3D", b"%C3%A9", b"%E2%82%AC", b"%26"]
    vals = [w[:6] + (esc[i % len(esc)] if i % 3 == 0 else b"")
            for i, w in enumerate(words[:2000])]
    val_ids = tok.add(vals)
    utm_key = tok.add([b"?utm_source="])[0]
    utm_vals = tok.add([b"google", b"newsletter", b"twitter", b"facebook",
                        b"bing", b"partner"])
    frags = tok.add([b"#" + w for w in words[:500]])
    bad_tok = tok.add([b"/my file", b"/50%off", b"", b"/caf\xe9"])
    unclosed = tok.add([b"[2001:db8::1"])[0]
    fillers = tok.add([b"/" + rng.choice(_HEXCH, 200).tobytes()
                       for _ in range(256)])
    empty = np.full(n, -1, dtype=np.int32)

    valid = rng.random(n) >= 0.01
    invalid = np.where(valid & (rng.random(n) < 0.005),
                       rng.integers(0, 4, n), -1)
    u = rng.random(n)
    scheme = np.where(u < 0.02, 3, np.where(u < 0.46, 0, np.where(
        u < 0.95, 1, 2)))
    v = rng.random(n)
    host = np.where(v < 0.001, _pick(rng, v6_ids, n),
                    np.where(v < 0.011, _pick(rng, v4_ids, n),
                             _pick(rng, dom_ids, n, 3)))
    host = np.where(invalid == 2, unclosed, host)
    port = np.where((rng.random(n) < 0.05) & (invalid != 2),
                    _pick(rng, ports, n), -1)
    nseg = rng.integers(1, 6, n)
    seg_slots = [np.where(k < nseg, _pick(rng, segs, n, 2), -1)
                 for k in range(5)]
    bad = np.where(invalid >= 0, bad_tok[np.maximum(invalid, 0)], -1)
    utm = np.arange(n) % 3 == 0
    npairs = rng.integers(0, 7, n)
    pair_slots = []
    for k in range(6):
        ki = rng.integers(0, len(keys), n)
        # the first pair opens the query, unless utm_source did
        kid = np.where((k == 0) & ~utm, first_keys[ki], more_keys[ki])
        pair_slots.append((np.where(k < npairs, kid, -1),
                           np.where(k < npairs, _pick(rng, val_ids, n, 2),
                                    -1)))
    frag = np.where(rng.random(n) < 0.03, _pick(rng, frags, n), -1)

    tlen = tok.lengths().astype(np.int32)

    def lens(ids):  # ids -1 read the last token's length, then zeroed
        return np.where(ids >= 0, tlen[ids], 0)

    base = lens(schemes[scheme]) + lens(host) + lens(port) + lens(bad) \
        + sum(lens(s) for s in seg_slots) + lens(frag)
    utm_val = np.where(utm, _pick(rng, utm_vals, n), -1)
    base += np.where(utm, tlen[utm_key], 0) + lens(utm_val)
    # a pair stays while the row fits in 200 bytes
    cum = base
    for k, (kid, vid) in enumerate(pair_slots):
        keep = cum + lens(kid) + lens(vid) <= 200
        kid, vid = np.where(keep, kid, -1), np.where(keep, vid, -1)
        pair_slots[k] = (kid, vid)
        cum = cum + lens(kid) + lens(vid)
    target = rng.integers(60, 201, n)
    fill = np.clip(target - cum, 0, 200)
    slots = [(schemes[scheme], None), (host, None), (port, None)]
    slots += [(s, None) for s in seg_slots]
    slots += [(np.where(fill > 0, _pick(rng, fillers, n), -1), fill),
              (bad, None),
              (np.where(utm, utm_key, -1), None), (utm_val, None)]
    for kid, vid in pair_slots:
        slots += [(kid, None), (vid, None)]
    slots.append((frag, None))
    col = _assemble(tok, slots, valid, device)
    query = utm | (pair_slots[0][0] >= 0)
    return col, {"valid": valid, "invalid": invalid, "scheme": scheme != 3,
                 "query": query, "utm": utm}


# kinds of JSON event rows besides the plain ones
DOC_KINDS = ("plain", "exponent", "whitespace", "escaped", "malformed",
             "deep")


def weblog_docs(rows: int, seed: int = 0, device="cuda"):
    """A web log's JSON events, ``rows`` documents of 120-450 bytes:
    ``{"user":{"id","country"},"event":{"type","items":[{"sku","qty",
    "price"}, 0-3 of them]},"sid","ts","tags":[0-5 words],"active"}`` (the
    shape of
    benchmarks/bench_ops.py's documents, widened to events; ``sid`` is a
    hex session id whose length brings the row to a uniform target). Of
    the rows: 2.5% with ``ts`` in exponent form and 2.5% with whitespace
    after every separator (the host normalization's rows), 0.5% with
    escaped characters in ``tags[2]`` (uncertified for from_json), 0.1%
    malformed (no closing brace, or a key without its colon), 0.05% with a
    field nested 31-40 deep (past the device DFA's cap of 30, within the
    host PDA's 64), 1% null.

    Returns (STRING column on ``device``, dict of numpy per-row arrays:
    ``valid``, ``kind`` (index into ``DOC_KINDS``), ``items``,
    ``tags``)."""
    rng = np.random.default_rng(seed)
    n = rows
    tok = _Tokens()
    valid = rng.random(n) >= 0.01
    u = rng.random(n)
    kind = np.select([u < 0.025, u < 0.05, u < 0.055, u < 0.056,
                      u < 0.0565], [1, 2, 3, 4, 5], 0)
    ws = kind == 2

    def lit(compact, spaced):
        a, b = tok.add([compact, spaced])
        return np.where(ws, b, a)

    ids = tok.add([str(x).encode() for x in rng.integers(1, 10 ** 7,
                                                          100_000)])
    countries = tok.add([b"US", b"DE", b"FR", b"JP", b"BR", b"IN", b"GB",
                         b"CN", b"CA", b"MX", b"ES", b"IT", b"KR", b"NL"])
    types = tok.add([b"click", b"view", b"purchase", b"add_to_cart",
                     b"search", b"login", b"logout", b"share"])
    skus = tok.add([b"SKU-%05d" % i for i in range(100_000)])
    qtys = tok.add([b"%d" % i for i in range(1, 10)])
    prices = tok.add([b"%d.%02d" % (a, b) for a, b in
                      rng.integers(0, 1000, (2000, 2)) % [1000, 100]])
    ts_base = rng.integers(1_600_000_000_000, 1_800_000_000_000, 100_000)
    ts_ids = tok.add([str(t).encode() for t in ts_base])
    ts_exp = tok.add([b"%.9e" % t for t in ts_base[:2000]])
    tags = tok.add(_words(rng, 200, 5, 10))
    esc_tags = tok.add([b'say \\"hi\\"', b"caf\\u00e9", b"a\\\\b",
                        b"tab\\there", b"line\\nbreak", b"x\\/y"])
    deep = tok.add([b',"deep":' + b"[" * d + b"1" + b"]" * d
                    for d in range(31, 41)])
    sids = tok.add([rng.choice(_HEXCH, 400).tobytes() for _ in range(256)])

    n_items = rng.integers(0, 4, n)
    n_tags = np.where(kind == 3, rng.integers(3, 6, n),
                      rng.integers(0, 6, n))
    slots = [(lit(b'{"user":{"id":', b'{"user": {"id": '), None),
             (_pick(rng, ids, n), None),
             (lit(b',"country":"', b', "country": "'), None),
             (_pick(rng, countries, n, 2), None),
             (lit(b'"},"event":{"type":"', b'"}, "event": {"type": "'),
              None),
             (_pick(rng, types, n, 2), None),
             (lit(b'","items":[', b'", "items": ['), None)]
    brace = np.full(n, tok.add([b"}"])[0], np.int32)
    quote = np.full(n, tok.add([b'"'])[0], np.int32)
    for k in range(3):
        on = k < n_items
        opener = lit(b'{"sku":"', b'{"sku": "') if k == 0 else \
            lit(b',{"sku":"', b', {"sku": "')
        for ids_k in (opener, _pick(rng, skus, n, 2),
                      lit(b'","qty":', b'", "qty": '), _pick(rng, qtys, n),
                      lit(b',"price":', b', "price": '),
                      _pick(rng, prices, n), brace):
            slots.append((np.where(on, ids_k, -1), None))
    sid_open = lit(b']},"sid":"', b']}, "sid": "')
    slots.append((sid_open, None))
    sid_at = len(slots)
    slots.append((_pick(rng, sids, n), np.zeros(n, np.int64)))
    colon_ok = tok.add([b'","ts":', b'", "ts": '])
    no_colon = tok.add([b'","ts"'])[0]
    malformed = kind == 4
    how = rng.integers(0, 2, n)   # malformed: 0 no closing brace, 1 no ':'
    slots.append((np.where(malformed & (how == 1), no_colon,
                           np.where(ws, colon_ok[1], colon_ok[0])), None))
    slots.append((np.where(kind == 1, _pick(rng, ts_exp, n),
                           _pick(rng, ts_ids, n)), None))
    slots.append((lit(b',"tags":[', b', "tags": ['), None))
    for k in range(5):
        on = k < n_tags
        opener = quote if k == 0 else lit(b',"', b', "')
        body = np.where((kind == 3) & (k == 2), _pick(rng, esc_tags, n),
                        _pick(rng, tags, n, 2))
        for ids_k in (opener, body, quote):
            slots.append((np.where(on, ids_k, -1), None))
    slots.append((lit(b'],"active":', b'], "active": '), None))
    slots.append((_pick(rng, tok.add([b"true", b"false"]), n), None))
    slots.append((np.where(kind == 5, _pick(rng, deep, n), -1), None))
    slots.append((np.where(malformed & (how == 0), -1, brace), None))
    # the session id's length brings the row to its target
    tlen = tok.lengths().astype(np.int32)
    total = sum(np.where(i >= 0, tlen[i], 0) for i, ln in slots
                if ln is None)
    target = rng.integers(120, 451, n)
    slots[sid_at] = (slots[sid_at][0], np.clip(target - total, 0, 400))
    col = _assemble(tok, slots, valid, device)
    return col, {"valid": valid, "kind": kind, "items": n_items,
                 "tags": n_tags}
