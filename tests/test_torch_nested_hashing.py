"""Port parity: Spark's murmur3 of nested columns
(``spark_rapids_jni_tpu_torch/ops/hashing.py``: STRUCT flattening, LIST
units as kernel B1's "list" schema entry) against the JAX package's
ops/hashing.py, bit for bit, and the repair of B1/B2's 64-entry limit.

The Spark vectors are tests/test_hashing.py's (hash.cpp's StructOfListValues
and ListValues, the struct and combined rows); the seeded columns, drawn
with numpy, put nulls at every level and every leaf kind B1's list entry
reads (u32, u64 and bytes: INT32, INT64, STRING, DECIMAL128). On
the CPU the kernels' plain versions run (``kernels.murmur3_fixed_rows_plain``
is the definition the card's kernel is held to).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import hashing as JH
from spark_rapids_jni_tpu_torch.ops import hashing as H
from spark_rapids_jni_tpu_torch.ops import kernels

from torch_parity import quick_jax_reference, to_port  # noqa: F401

pytestmark = pytest.mark.usefixtures("quick_jax_reference")

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def _both(jcols, seed=42):
    want = JH.murmur_hash3_32(jcols, seed).to_pylist()
    got = H.murmur_hash3_32([to_port(c) for c in jcols], seed).to_pylist()
    assert got == want
    return got


def _structs_col():
    a = JColumn.from_pylist([0, 100, -100, 0x12345678, -0x76543210],
                            jdt.INT32)
    b = JColumn.from_pylist(["a", "bc", "def", "ghij", "klmno"], jdt.STRING)
    x = JColumn.from_pylist([0.0, 100.0, -100.0, float("inf"),
                             float("-inf")], jdt.FLOAT32)
    y = JColumn.from_pylist([0, 100, -100, 0x0123456789ABCDEF,
                             -0x0123456789ABCDEF], jdt.INT64)
    return JColumn.struct_of([a, b, JColumn.struct_of([x, y])])


def test_spark_struct_vector():
    assert _both([_structs_col()]) == [
        -105406170, 90479889, -678041645, 1667387937, 301478567]


def test_spark_combined_row_vector():
    """A STRUCT beside flat columns of many types: one row hash."""
    cols = [
        _structs_col(),
        JColumn.from_pylist([0, 100, -100, -9223372036854, 9223372036854],
                            jdt.TIMESTAMP_MILLISECONDS),
        JColumn.from_pylist([0, 100, -100, I64_MIN, I64_MAX], jdt.INT64),
        JColumn.from_pylist([0, 100, -100, I32_MIN, I32_MAX], jdt.INT32),
        JColumn.from_pylist([0, 100, -100, -32768, 32767], jdt.INT16),
        JColumn.from_pylist([0, 100, -100, -128, 127], jdt.INT8),
    ]
    _both(cols)


def test_spark_list_values_vector():
    """hash.cpp ListValues: LIST<LIST<INT32>> with null rows, null inner
    lists and null elements."""
    leaf = JColumn.from_pylist(
        [1, 1, 2, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, None, 2, 3, 1, 2, 3, None,
         1, 2, 3], jdt.INT32)
    inner_valid = np.ones(16, dtype=bool)
    inner_valid[[0, 14]] = False
    inner = JColumn.list_of(leaf, np.array(
        [0, 0, 1, 3, 6, 8, 9, 10, 12, 13, 16, 18, 19, 20, 22, 22, 23],
        dtype=np.int32), validity=jnp.asarray(inner_valid))
    outer_valid = np.ones(11, dtype=bool)
    outer_valid[0] = False
    outer = JColumn.list_of(inner, np.array(
        [0, 0, 0, 1, 2, 3, 4, 6, 8, 10, 13, 16], dtype=np.int32),
        validity=jnp.asarray(outer_valid))
    assert _both([outer]) == [
        42, 42, 42, -559580957, -222940379, -912918097, -912918097,
        -912918097, -912918097, -912918097, -912918097]


def test_spark_struct_of_list_vector():
    """hash.cpp StructOfListValues."""
    col1 = JColumn.list_of(
        JColumn.from_pylist([0, 1, None, 1, None, 2, 3], jdt.INT32),
        np.array([0, 0, 1, 3, 5, 5, 5, 7], dtype=np.int32),
        validity=jnp.asarray(np.array([1, 1, 1, 1, 1, 0, 1], dtype=bool)))
    col2 = JColumn.list_of(
        JColumn.from_pylist([0, None, 1, 1, 4, 5], jdt.INT32),
        np.array([0, 0, 1, 1, 1, 3, 4, 6], dtype=np.int32),
        validity=jnp.asarray(np.array([1, 1, 0, 1, 1, 1, 1], dtype=bool)))
    assert _both([JColumn.struct_of([col1, col2])]) == [
        42, 59727262, -559580957, -559580957, -559580957, -559580957,
        170038658]


N = 96


def _offsets(rng, n, most):
    lens = rng.integers(0, most + 1, n)
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _list(rng, leaf, n, most=6):
    o = _offsets(rng, n, most)
    assert int(o[-1]) <= leaf.size
    return JColumn.list_of(leaf, jnp.asarray(o),
                           jnp.asarray(rng.random(n) > 0.15))


def _leaf(rng, m, kind):
    valid = rng.random(m) > 0.2
    if kind == "i64":
        return JColumn.from_numpy(rng.integers(I64_MIN, I64_MAX, m,
                                               dtype=np.int64), jdt.INT64,
                                  validity=valid)
    if kind == "i32":
        return JColumn.from_numpy(rng.integers(I32_MIN, I32_MAX, m,
                                               dtype=np.int64)
                                  .astype(np.int32), jdt.INT32,
                                  validity=valid)
    if kind == "f32":
        v = rng.standard_normal(m).astype(np.float32)
        v[::9] = np.nan
        v[1::11] = -0.0
        return JColumn.from_numpy(v, jdt.FLOAT32, validity=valid)
    if kind == "str":
        return JColumn.from_pylist(
            [None if not ok else "x" * int(rng.integers(0, 13))
             + str(int(rng.integers(0, 1 << 20))) for ok in valid],
            jdt.STRING)
    if kind == "dec128":
        return JColumn.from_pylist(
            [None if not ok else int(rng.integers(-10 ** 15, 10 ** 15))
             * 10 ** int(rng.integers(0, 20)) for ok in valid],
            jdt.decimal128(3))
    raise ValueError(kind)


def test_seeded_nested_columns_match():
    """One row hash over LIST units of u64 and byte leaves, a
    LIST<LIST<INT32>> (u32), a STRUCT<LIST, STRING, FLOAT32> with nulls at
    its own level: the units chain in order, each element the seed of the
    next."""
    rng = np.random.default_rng(21)
    cols = [_list(rng, _leaf(rng, 6 * N, k), N)
            for k in ("i64", "str", "dec128")]
    m = 4 * N
    cols.append(JColumn.list_of(_list(rng, _leaf(rng, 6 * m, "i32"), m),
                                jnp.asarray(_offsets(rng, N, 4)),
                                jnp.asarray(rng.random(N) > 0.1)))
    cols.append(JColumn.struct_of(
        [_list(rng, _leaf(rng, 6 * N, "i64"), N), _leaf(rng, N, "str"),
         _leaf(rng, N, "f32")], jnp.asarray(rng.random(N) > 0.2)))
    _both(cols, seed=7)


def _wide(rng, n, width):
    return [JColumn.from_numpy(rng.integers(-1000, 1000, n).astype(np.int32),
                               jdt.INT32, validity=rng.random(n) > 0.1)
            for _ in range(width)]


@pytest.mark.parametrize("shape", ["flat", "struct"])
def test_more_than_64_hash_units_match(shape):
    """70 units: 70 flat columns, or one STRUCT of 70 fields (the flattened
    row a kernel launch once refused past 64 entries)."""
    rng = np.random.default_rng(3)
    cols = _wide(rng, 32, 70)
    if shape == "struct":
        cols = [JColumn.struct_of(cols, jnp.asarray(rng.random(32) > 0.2))]
    _both(cols)
    if shape == "flat":
        pcols = [to_port(c) for c in cols]
        assert H.xxhash64(pcols).to_pylist() == \
            JH.xxhash64(cols).to_pylist()


def test_per_row_seeds_chain_a_split_schema():
    """A schema split at any entry, the second part seeded per row by the
    first part's hashes, hashes as the whole schema (the rule the card's
    successive launches follow), for both plain versions."""
    rng = np.random.default_rng(4)
    n = 50
    words = [torch.from_numpy(rng.integers(-5, 5, n).astype(np.int64))
             for _ in range(6)]
    valid = torch.from_numpy(rng.random(n) > 0.3)
    offs = torch.from_numpy(_offsets(rng, n, 5))
    leaf = torch.from_numpy(rng.integers(0, 9, int(offs[-1])).astype(
        np.int32))
    mm = [("u64", w, valid if i % 2 else None) for i, w in
          enumerate(words)]
    mm.insert(3, ("list", (offs[:-1], offs[1:], "u32", leaf, None), valid))
    whole = kernels.murmur3_fixed_rows_plain(mm, 42, n)
    for cut in (1, 3, 4, 6):
        first = kernels.murmur3_fixed_rows_plain(mm[:cut], 42, n)
        assert torch.equal(kernels.murmur3_fixed_rows_plain(
            mm[cut:], 42, n, seeds=first), whole)
    xx = [e for e in mm if e[0] != "list"]
    whole = kernels.xxhash64_fixed_rows_plain(xx, 42, n)
    first = kernels.xxhash64_fixed_rows_plain(xx[:2], 42, n)
    assert torch.equal(kernels.xxhash64_fixed_rows_plain(
        xx[2:], 42, n, seeds=first), whole)
    with pytest.raises(ValueError, match="no LIST schema entry"):
        kernels.xxhash64_fixed_rows(mm, 42, n)


def test_list_entry_plain_is_an_element_fold():
    """B1's "list" entry, plain: the longest-first walk equals folding
    each row's non-null elements into its running hash one by one."""
    rng = np.random.default_rng(5)
    n = 40
    offs = _offsets(rng, n, 9)
    leaf = rng.integers(-(1 << 40), 1 << 40, int(offs[-1]))
    lvalid = rng.random(leaf.size) > 0.25
    rvalid = rng.random(n) > 0.2
    entry = ("list", (torch.from_numpy(offs[:-1]),
                      torch.from_numpy(offs[1:]), "u64",
                      torch.from_numpy(leaf), torch.from_numpy(lvalid)),
             torch.from_numpy(rvalid))
    got = kernels.murmur3_fixed_rows_plain([entry], 42, n).tolist()
    for i in range(n):
        h = torch.tensor([42], dtype=torch.int64)
        for k in range(offs[i], offs[i + 1]):
            if rvalid[i] and lvalid[k]:
                h = H._mm_u64(h, torch.tensor([int(leaf[k])]))
        assert got[i] == int(h.to(torch.int32))


def test_nesting_past_max_stack_depth_raises_as_the_jax_package():
    """STRUCTs nested past Hash.java's MAX_STACK_DEPTH (8) raise the same
    ValueError in both packages; at the limit both hash."""
    def deep(levels):
        c = JColumn.from_pylist([1, None, 3], jdt.INT32)
        for _ in range(levels):
            c = JColumn.struct_of([c])
        return c

    with pytest.raises(ValueError) as want:
        JH.murmur_hash3_32([deep(10)])
    with pytest.raises(ValueError) as got:
        H.murmur_hash3_32([to_port(deep(10))])
    assert str(got.value) == str(want.value)
    _both([deep(8)])


def test_b1_byte_bound_reads_shared_offsets_once():
    """chip_smoke's byte bound of a B1 schema: a LIST entry whose ends are
    its starts shifted by one (views of one offsets tensor) reads n + 1
    offsets, not 2n; separate starts and ends are read each."""
    import chip_smoke
    n = 5
    offs = torch.tensor([0, 2, 2, 5, 9, 10], dtype=torch.int32)
    leaf = torch.arange(10, dtype=torch.int64)
    out_and_leaf = 4 * n + 8 * 10
    shared = [("list", (offs[:-1], offs[1:], "u64", leaf, None), None)]
    assert chip_smoke._b1_bytes(shared, n) == out_and_leaf + 4 * (n + 1)
    apart = [("list", (offs[:-1].clone(), offs[1:].clone(), "u64", leaf,
                       torch.ones(10, dtype=torch.bool)),
              torch.ones(n, dtype=torch.bool))]
    assert chip_smoke._b1_bytes(apart, n) == (out_and_leaf + 8 * n + 10
                                              + n)
