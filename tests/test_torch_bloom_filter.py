"""Port parity: the bloom filter (spark_rapids_jni_tpu_torch.ops
.bloom_filter) against the JAX package's ops/bloom_filter.py and the
scalar model of Spark's BloomFilterImpl in tests/test_bloom_filter.py,
bit-exact: serialized bytes and probe columns."""

import numpy as np
import pytest

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import bloom_filter as JB
from spark_rapids_jni_tpu_torch.ops import bloom_filter as B

from tests.test_bloom_filter import KEYS, PyBloomFilter
from torch_parity import assert_col_equal, to_port

N = 400  # one key count for the seeded draws: the JAX package compiles once


def _keys(seed, null_frac=0.0):
    r = np.random.default_rng(seed)
    vals = r.integers(-(2**63), 2**63 - 1, N, dtype=np.int64)
    vals[:len(KEYS)] = KEYS
    v = r.random(N) >= null_frac if null_frac else None
    return JColumn.from_numpy(vals, jdt.INT64, validity=v)


def _both_put(num_hashes, num_longs, jcol):
    jbf = JB.bloom_filter_put(JB.bloom_filter_create(num_hashes, num_longs),
                              jcol)
    pbf = B.bloom_filter_put(
        B.bloom_filter_create(num_hashes, num_longs, device="cpu"),
        to_port(jcol))
    return jbf, pbf


@pytest.mark.parametrize("num_hashes,num_longs",
                         [(3, 16), (5, 8), (1, 4), (7, 64)])
def test_put_serializes_as_jax_and_spark(num_hashes, num_longs):
    """The reference's parameter pairs (test_bloom_filter.py): the port's
    bytes equal the JAX package's and the scalar BloomFilterImpl's."""
    jcol = _keys(1)
    jbf, pbf = _both_put(num_hashes, num_longs, jcol)
    ref = PyBloomFilter(num_hashes, num_longs)
    for k in np.asarray(jcol.data).tolist():
        ref.put_long(k)
    assert B.serialize(pbf) == JB.serialize(jbf) == ref.serialize()


def test_nulls_skipped_and_probe_matches():
    """Null keys are not put; probes of put keys, other keys and nulls
    equal the JAX package's column (values and validity)."""
    jcol = _keys(2, null_frac=0.2)
    jbf, pbf = _both_put(4, 32, jcol)
    assert B.serialize(pbf) == JB.serialize(jbf)
    probe = _keys(3, null_frac=0.1)
    for c in (jcol, probe):
        assert_col_equal(JB.bloom_filter_probe(c, jbf),
                         B.bloom_filter_probe(to_port(c), pbf))
    hits = B.bloom_filter_probe(to_port(jcol), pbf)
    assert hits.data[hits.validity].all()


def test_merge_and_spark_bytes_round_trip():
    """Partial filters OR-merged equal one filter put with all keys;
    Spark's serialized bytes (the scalar model's) deserialize to a filter
    that probes as the model does, and serialize back unchanged."""
    jcol = _keys(4)
    halves = [to_port(JColumn.from_numpy(np.asarray(jcol.data)[s],
                                         jdt.INT64))
              for s in (slice(0, N // 2), slice(N // 2, N))]
    parts = [B.bloom_filter_put(B.bloom_filter_create(3, 32, device="cpu"),
                                h) for h in halves]
    whole = _both_put(3, 32, jcol)
    assert B.serialize(B.bloom_filter_merge(parts)) == \
        B.serialize(whole[1]) == JB.serialize(whole[0])
    ref = PyBloomFilter(4, 16)
    for k in KEYS:
        ref.put_long(k)
    buf = ref.serialize()
    pbf = B.deserialize(buf, device="cpu")
    assert B.serialize(pbf) == buf
    probes = JColumn.from_pylist(list(range(-50, 50)) + KEYS, jdt.INT64)
    got = B.bloom_filter_probe(to_port(probes), pbf).to_pylist()
    assert got == [ref.might_contain(p) for p in probes.to_pylist()]
    assert_col_equal(JB.bloom_filter_probe(probes, JB.deserialize(buf)),
                     B.bloom_filter_probe(to_port(probes), pbf))


def test_errors_match():
    import struct
    cases = [
        lambda m: m.bloom_filter_merge([m.bloom_filter_create(3, 32),
                                        m.bloom_filter_create(4, 32)]),
        lambda m: m.deserialize(b"\x00" * 4),
        lambda m: m.deserialize(struct.pack(">iii", 2, 3, 1) + b"\0" * 8),
        lambda m: m.deserialize(struct.pack(">iii", 1, 3, 2) + b"\0" * 8),
        lambda m: m.deserialize(struct.pack(">iii", 1, 3, 0)),
        lambda m: m.bloom_filter_create(0, 4),
    ]
    for case in cases:
        with pytest.raises(ValueError) as want:
            case(JB)
        with pytest.raises(ValueError) as got:
            case(_CpuB)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="INT64"):
        B.bloom_filter_put(B.bloom_filter_create(3, 4, device="cpu"),
                           to_port(JColumn.from_pylist([1], jdt.INT32)))


class _CpuB:
    """The port's module with its entry points on the CPU."""
    bloom_filter_merge = staticmethod(B.bloom_filter_merge)

    @staticmethod
    def bloom_filter_create(h, n):
        return B.bloom_filter_create(h, n, device="cpu")

    @staticmethod
    def deserialize(buf):
        return B.deserialize(buf, device="cpu")
