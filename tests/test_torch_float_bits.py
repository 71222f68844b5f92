"""The port's decimal -> binary float assembly (``ops/float_bits.py``)
held alone against the exact oracles of ``tests/test_float_bits.py`` (a
correctly rounded binary64 from CPython; binary32 rounded ONCE from the
exact rational, as Java's Float.parseFloat does) over its boundary corpus,
its 20,000-case random corpus and its exact-tie cases, then against the
JAX package's ``float_bits`` on 4,096 of those cases. The comparison is of
bit patterns, tolerance 0. Also: the FLOAT64 view casts keep every bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from spark_rapids_jni_tpu.ops import float_bits as JFB
from spark_rapids_jni_tpu_torch.ops import float_bits as PFB
from test_float_bits import BOUNDARY, _oracle32, _oracle64


def _port(d, e, neg):
    """(f64 bits, f32 bits) of the port as uint64 arrays."""
    D = torch.from_numpy(np.asarray(d, np.uint64).view(np.int64).copy())
    E = torch.from_numpy(np.asarray(e, np.int64))
    N = torch.from_numpy(np.asarray(neg, bool))
    return (PFB.decimal_to_f64_bits(D, E, N).numpy().view(np.uint64),
            PFB.decimal_to_f32_bits(D, E, N).numpy().view(np.uint64))


def _random_corpus():
    """test_float_bits.py::test_random_corpus_bit_exact's cases."""
    rng = np.random.default_rng(0)
    n = 20000
    d = rng.integers(0, 2**64, n, dtype=np.uint64)
    d[: n // 2] = rng.integers(0, 10 ** rng.integers(1, 19), n // 2,
                               dtype=np.uint64)
    e = rng.integers(-360, 330, n).astype(np.int32)
    ng = rng.integers(0, 2, n).astype(bool)
    return d, e, ng


def _boundary(neg):
    d = np.array([c[0] for c in BOUNDARY], dtype=np.uint64)
    e = np.array([c[1] for c in BOUNDARY], dtype=np.int32)
    return d, e, np.full(d.shape, neg)


def _assert_oracles(d, e, ng):
    got64, got32 = _port(d, e, ng)
    bad = [i for i in range(len(d))
           if got64[i] != _oracle64(d[i], e[i], ng[i])
           or got32[i] != _oracle32(d[i], e[i], ng[i])]
    assert not bad, [(int(d[i]), int(e[i]), bool(ng[i]), hex(got64[i]),
                      hex(got32[i])) for i in bad[:5]]


def test_boundary_corpus_matches_the_oracles():
    for neg in (False, True):
        _assert_oracles(*_boundary(neg))


def test_random_corpus_matches_the_oracles():
    _assert_oracles(*_random_corpus())


def test_exact_ties_round_to_even():
    """test_float_bits.py's exact ties with q < 0, where an up-rounded
    reciprocal would read "above half"."""
    cases = [(3540205410719687400, -2), (12209032421260881000, -3)]
    rng = np.random.default_rng(5)
    for m in rng.integers(2**52, 2**53, 200, dtype=np.uint64):
        cases.append((int((2 * m + 1) * 25), -2))
    d = np.array([c[0] for c in cases], np.uint64)
    e = np.array([c[1] for c in cases], np.int32)
    got64, _ = _port(d, e, np.zeros(len(cases), bool))
    want = [np.float64(float(f"{w}e{q}")).view(np.uint64) for w, q in cases]
    assert got64.tolist() == [int(w) for w in want]


def test_matches_the_jax_package_on_4096_cases():
    d, e, ng = _random_corpus()
    bd, be, bn = _boundary(True)
    pick = np.random.default_rng(3).choice(len(d), 4096 - len(bd),
                                           replace=False)
    d = np.concatenate([bd, d[pick]])
    e = np.concatenate([be, e[pick]])
    ng = np.concatenate([bn, ng[pick]])
    got64, got32 = _port(d, e, ng)
    # both widths in one jit: one compile, where eager dispatch compiles
    # each of the assembly's operations
    both = jax.jit(lambda *a: (JFB.decimal_to_f64_bits(*a),
                               JFB.decimal_to_f32_bits(*a)))
    want64, want32 = both(jnp.asarray(d), jnp.asarray(e), jnp.asarray(ng))
    np.testing.assert_array_equal(got64, np.asarray(want64))
    np.testing.assert_array_equal(got32, np.asarray(want32))


def test_f64_views_keep_every_bit():
    bits = np.array([0, 1 << 63, 1, 0x7FF0000000000000, 0xFFF0000000000000,
                     0x7FF8000000000001, 0xFFF4000000000123,
                     0x000FFFFFFFFFFFFF, 0x3FF0000000000000], np.uint64)
    t = torch.from_numpy(bits.view(np.int64).copy())
    vals = PFB.f64_value_from_bits(t)
    assert vals.dtype is torch.float64
    np.testing.assert_array_equal(
        PFB.f64_bits_from_value(vals).numpy().view(np.uint64), bits)
    f32 = PFB.f32_value_from_bits(torch.tensor([1, 0x80000000, 0x7FC00001,
                                                0xFF800000]))
    assert f32.numpy().view(np.uint32).tolist() == [1, 0x80000000,
                                                    0x7FC00001, 0xFF800000]
