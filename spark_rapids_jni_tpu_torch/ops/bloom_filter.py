"""Spark-compatible bloom filter over INT64 keys (the JAX package's
ops/bloom_filter.py).

Create, put, probe and merge, and ``serialize``/``deserialize`` byte for
byte as Spark's ``org.apache.spark.util.sketch.BloomFilterImpl`` version 1
writes them. This is the filter of Spark's runtime filter
(``InjectRuntimeFilter``): ``BloomFilterAggregate(XxHash64(key))`` puts the
build side's key hashes, ``BloomFilterMightContain`` probes the other
side's.

Hash schedule (BloomFilterImpl.putLong/mightContainLong):
h1 = murmur3_32(long, seed=0), h2 = murmur3_32(long, seed=h1); probe i in
[1..num_hashes]: combined = h1 + i*h2 (int32 wrap), ~combined where it is
negative, bit = combined % num_bits. h1 is kernel B1's row hash of the
key column ``[k]`` from seed 0, and h2 its row hash of ``[k, k]``: the
row hash chains the seed across columns, so its second column hashes k
from seed h1 (``kernels.murmur3_fixed_rows``; the plain version for a CPU
tensor).

As in the JAX package, the filter lives as a dense ``bool[num_longs*64]``
bit vector on its device: put scatters True into it, probe gathers
``num_hashes`` bits a key, merge ORs; Spark's big-endian long words are
formed only at the serialize/deserialize boundary. Put and probe are
torch ops, one pass per hash, so no ``[n, num_hashes]`` index matrix is
held. Null keys are not put; probe returns the keys' validity.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, resolve_device
from . import kernels

SPARK_BLOOM_FILTER_VERSION = 1
HEADER_SIZE = 12  # 3 big-endian int32: version, num_hashes, num_longs


@dataclass
class BloomFilter:
    num_hashes: int
    num_longs: int
    bits: torch.Tensor  # bool[num_longs * 64]

    @property
    def num_bits(self) -> int:
        return self.num_longs * 64


def bloom_filter_create(num_hashes: int, num_longs: int,
                        device="cuda") -> BloomFilter:
    """New empty filter on ``device``."""
    if num_hashes <= 0 or num_longs <= 0:
        raise ValueError("bloom filter needs positive num_hashes/num_longs")
    return BloomFilter(num_hashes, num_longs,
                       torch.zeros(num_longs * 64, dtype=torch.bool,
                                   device=resolve_device(device)))


def _key_hashes(col: Column):
    """(h1, h2) as int64 lanes holding int32 values: B1's row hashes of
    ``[k]`` and ``[k, k]`` from seed 0."""
    if col.dtype.id is not dt.TypeId.INT64:
        raise TypeError("bloom filter input must be INT64")
    k = ("u64", col.data, None)
    h1 = kernels.murmur3_fixed_rows([k], 0, col.size)
    h2 = kernels.murmur3_fixed_rows([k, k], 0, col.size)
    return h1.to(torch.int64), h2.to(torch.int64)


def _probe_bit(h1: torch.Tensor, h2: torch.Tensor, i: int,
               num_bits: int) -> torch.Tensor:
    """int64 bit index of probe ``i`` for every key."""
    c = (h1 + i * h2) & 0xFFFFFFFF
    c = torch.where(c >= 1 << 31, c - (1 << 32), c)  # int32 wrap
    c = torch.where(c < 0, ~c, c)
    return c % num_bits


def bloom_filter_put(bf: BloomFilter, col: Column) -> BloomFilter:
    """Insert an INT64 column's non-null values; returns the updated filter
    (functional, as the JAX package's)."""
    h1, h2 = _key_hashes(col)
    # null keys write to a sink slot past the end, so the scatter needs no
    # host read of the valid count
    bits = torch.cat([bf.bits, bf.bits.new_zeros(1)])
    one = torch.ones((), dtype=torch.bool, device=bits.device)
    for i in range(1, bf.num_hashes + 1):
        idx = _probe_bit(h1, h2, i, bf.num_bits)
        if col.validity is not None:
            idx = torch.where(col.validity, idx, bf.num_bits)
        bits.index_put_((idx,), one)
    return BloomFilter(bf.num_hashes, bf.num_longs, bits[:bf.num_bits])


def bloom_filter_probe(col: Column, bf: BloomFilter) -> Column:
    """BOOL8 column: might-contain for each key; nulls propagate."""
    h1, h2 = _key_hashes(col)
    hit = torch.ones(col.size, dtype=torch.bool, device=col.device)
    for i in range(1, bf.num_hashes + 1):
        hit &= bf.bits.index_select(0, _probe_bit(h1, h2, i, bf.num_bits))
    return Column(dt.BOOL8, col.size, data=hit.to(torch.uint8),
                  validity=col.validity)


def bloom_filter_merge(filters) -> BloomFilter:
    """OR-merge filters with identical parameters."""
    filters = list(filters)
    if not filters:
        raise ValueError("need at least one filter")
    first = filters[0]
    for f in filters[1:]:
        if (f.num_hashes != first.num_hashes
                or f.num_longs != first.num_longs):
            raise ValueError("Mismatch of bloom filter parameters")
    bits = first.bits
    for f in filters[1:]:
        bits = bits | f.bits
    return BloomFilter(first.num_hashes, first.num_longs, bits)


# ---------------------------------------------------------------------------
# Spark serialized form (big-endian header + big-endian long words)
# ---------------------------------------------------------------------------

def serialize(bf: BloomFilter) -> bytes:
    """Bytes identical to BloomFilterImpl.writeTo (version 1)."""
    header = struct.pack(">iii", SPARK_BLOOM_FILTER_VERSION, bf.num_hashes,
                         bf.num_longs)
    # bit j of long w is bits[64 w + j]; distinct powers of two add as OR
    shifts = torch.arange(64, dtype=torch.int64, device=bf.bits.device)
    longs = (bf.bits.view(bf.num_longs, 64).to(torch.int64) << shifts).sum(1)
    return header + longs.cpu().numpy().view(np.uint64).astype(
        ">u8").tobytes()


def deserialize(buf: bytes, device="cuda") -> BloomFilter:
    """Parse BloomFilterImpl.readFrom bytes into a filter on ``device``
    (version and shape enforced as the JAX package does)."""
    if len(buf) < HEADER_SIZE:
        raise ValueError("Encountered truncated bloom filter")
    version, num_hashes, num_longs = struct.unpack(">iii", buf[:HEADER_SIZE])
    if version != SPARK_BLOOM_FILTER_VERSION:
        raise ValueError("Unexpected bloom filter version")
    if num_longs <= 0:
        raise ValueError("Invalid empty bloom filter size")
    if len(buf) != HEADER_SIZE + num_longs * 8:
        raise ValueError("Encountered invalid/mismatched bloom filter "
                         "buffer data")
    longs = np.frombuffer(buf, dtype=">u8", offset=HEADER_SIZE,
                          count=num_longs).astype(np.uint64).view(np.int64)
    words = torch.from_numpy(longs.copy()).to(resolve_device(device))
    shifts = torch.arange(64, dtype=torch.int64, device=words.device)
    bits = ((words[:, None] >> shifts) & 1).to(torch.bool)
    return BloomFilter(num_hashes, num_longs, bits.reshape(-1))
