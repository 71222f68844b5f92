"""Port parity: STRING columns in the column model (columnar/column.py,
interop.py, strings.py, table_ops.py), ops/bitmask.py and
utils/datagen.py, against the JAX package on the CPU, bit for bit
(characters, offsets, validity)."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import bridge
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar import strings as JS
from spark_rapids_jni_tpu.columnar import table_ops as JTO
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.ops import bitmask as JB
from spark_rapids_jni_tpu.utils import datagen as JG
from spark_rapids_jni_tpu_torch.columnar import dtype as dt
from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.columnar import strings as S
from spark_rapids_jni_tpu_torch.columnar import table_ops as TO
from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
from spark_rapids_jni_tpu_torch.ops import bitmask as B
from spark_rapids_jni_tpu_torch.utils import datagen as G

from torch_parity import assert_col_equal, assert_table_equal, to_port
from torch_parity import quick_jax_reference  # noqa: F401

pytestmark = pytest.mark.usefixtures("quick_jax_reference")

EDGE = ["", "a", "ab", "abc", "abcd", None, "The quick brown fox",
        "héllo wörld ✓ 휠휡", b"\x00", b"ab\x00", b"\xff\xfe\x80\x7f", None,
        "x" * 33, ""]


def random_strings(n, seed, max_len=40, p_null=0.1):
    """n random byte strings (bytes 0-255, lengths 0..max_len), some
    None."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = bytes(rng.integers(0, 256, int(rng.integers(0, max_len + 1)),
                               dtype=np.uint8))
        out.append(None if rng.random() < p_null else s)
    return out


def both(vals):
    return (JColumn.from_pylist(vals, jdt.STRING),
            Column.from_pylist(vals, dt.STRING, device="cpu"))


@pytest.mark.parametrize("vals", [EDGE, [None, None], [], [""] * 3,
                                  random_strings(300, 1)],
                         ids=["edge", "all_null", "empty", "empties",
                              "random"])
def test_from_pylist_and_back_match(vals):
    jc, pc = both(vals)
    assert_col_equal(jc, pc)
    assert pc.to_pylist() == jc.to_pylist()
    assert pc.device_nbytes() == jc.device_nbytes()
    np.testing.assert_array_equal(pc.host_offsets(), jc.host_offsets())
    assert not pc.host_offsets().flags.writeable


def test_wire_tuple_both_ways():
    jc, pc = both(EDGE)
    assert interop.col_to_wire(pc) == bridge.col_to_wire(jc)
    back = interop.wire_to_col(bridge.col_to_wire(jc), "cpu")
    assert_col_equal(jc, back)
    assert back.offsets.dtype == torch.int32


@pytest.mark.parametrize("multiple", [1, 8, 16])
def test_pad_width_matches(multiple):
    for m in (0, 1, 7, 8, 9, 31, 32, 33, 100, 1000, 70000):
        assert S.pad_width(m, multiple) == JS.pad_width(m, multiple)


@pytest.mark.parametrize("chunk", [None, 64])
def test_padded_bytes_and_densify_match(chunk, monkeypatch):
    if chunk:  # several row chunks
        monkeypatch.setattr(S, "_DENSIFY_CHUNK", chunk)
    vals = random_strings(200, 2)
    jc, pc = both(vals)
    jm, jl = JS.padded_bytes(jc)
    pm, pl = S.padded_bytes(pc)
    np.testing.assert_array_equal(np.asarray(jm), pm.numpy())
    np.testing.assert_array_equal(np.asarray(jl), pl.numpy())
    assert S.padded_bytes(pc)[0] is pm  # memoized
    for L in (4, 16):  # shorter than the longest string: cut at L
        jm, jl = JS.densify_offsets(jc.data, jc.offsets, L)
        pm, pl = S.densify_offsets(pc.data, pc.offsets, L)
        np.testing.assert_array_equal(np.asarray(jm), pm.numpy())
        np.testing.assert_array_equal(np.asarray(jl), pl.numpy())


def test_unflatten_from_padded_and_pack_match():
    vals = [v or b"" for v in random_strings(200, 2)]  # the bytes above
    jc, pc = both(vals)
    jm, jl = JS.padded_bytes(jc)
    flat, offs = S.unflatten_padded(*S.padded_bytes(pc))
    jflat, joffs = JS.unflatten_padded(jm, jl)
    np.testing.assert_array_equal(jflat, flat.numpy())
    np.testing.assert_array_equal(joffs, offs.numpy())
    valid = np.arange(200) % 7 != 0
    assert_col_equal(JS.from_padded_bytes(np.asarray(jm), np.asarray(jl),
                                          valid),
                     S.from_padded_bytes(*S.padded_bytes(pc), valid))
    assert_col_equal(JS.pack_byte_rows(vals, valid),
                     S.pack_byte_rows(vals, valid, device="cpu"))


@pytest.mark.parametrize("with_validity", [False, True])
def test_gather_spans_matches(with_validity):
    rng = np.random.default_rng(4)
    src = rng.integers(0, 256, 500, dtype=np.uint8)
    starts = rng.integers(0, 450, 80).astype(np.int32)
    lengths = rng.integers(0, 50, 80).astype(np.int32)
    valid = rng.random(80) > 0.3 if with_validity else None
    import jax.numpy as jnp
    want = JS.gather_spans(jnp.asarray(src), jnp.asarray(starts),
                           jnp.asarray(lengths),
                           None if valid is None else jnp.asarray(valid))
    got = S.gather_spans(torch.from_numpy(src), torch.from_numpy(starts),
                         torch.from_numpy(lengths),
                         None if valid is None else torch.from_numpy(valid))
    assert_col_equal(want, got)


@pytest.mark.parametrize("oob_null", [False, True])
def test_gather_column_strings_matches(oob_null):
    jc, pc = both(random_strings(200, 2))
    idx = np.random.default_rng(6).integers(-3 if oob_null else 0,
                                            200 + 3 * oob_null, 300)
    assert_col_equal(JTO.gather_column(jc, idx, out_of_bounds_null=oob_null),
                     TO.gather_column(pc, idx, out_of_bounds_null=oob_null))


def test_concat_tables_matches():
    rng = np.random.default_rng(7)
    parts_j, parts_p = [], []
    for i, n in enumerate((30, 0, 45, 12)):
        vals = random_strings(n, 10 + i, p_null=0.2 if i % 2 else 0.0)
        ints = rng.integers(-2**40, 2**40, n)
        valid = rng.random(n) > 0.2 if i == 2 else None
        jt = JTable((JColumn.from_pylist(vals, jdt.STRING),
                     JColumn.from_numpy(ints, jdt.INT64, validity=valid)))
        parts_j.append(jt)
        parts_p.append(Table(tuple(to_port(c) for c in jt.columns)))
    assert_table_equal(JTO.concat_tables(parts_j), TO.concat_tables(parts_p))
    with pytest.raises(TypeError, match="dtype mismatch"):
        TO.concat_columns([parts_p[0][0], parts_p[0][1]])


def test_bitmask_matches():
    rng = np.random.default_rng(8)
    masks = [rng.random(77) > 0.5 for _ in range(3)]
    import jax.numpy as jnp
    want = JB.bitmask_bitwise_or([jnp.asarray(m) for m in masks])
    got = B.bitmask_bitwise_or([torch.from_numpy(m) for m in masks])
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    words = B.pack_bool_mask(got)
    np.testing.assert_array_equal(
        np.asarray(JB.pack_bool_mask(want)).astype(np.int64), words.numpy())
    np.testing.assert_array_equal(B.unpack_bool_mask(words, 77).numpy(),
                                  masks[0] | masks[1] | masks[2])
    with pytest.raises(ValueError, match="mismatched"):
        B.bitmask_bitwise_or([got, got[:5]])


_PROFILES = {
    "bench_strings": lambda d, D: d.ColumnProfile(
        D.STRING, string_len=d.Dist("normal", 0, 32), cardinality=1000,
        null_frequency=None),
    "strings_default": lambda d, D: d.ColumnProfile(D.STRING),
    "strings_unpooled": lambda d, D: d.ColumnProfile(
        D.STRING, cardinality=0, avg_run_length=1,
        string_len=d.Dist("geometric", 0, 100)),
    "int32": lambda d, D: d.ColumnProfile(D.INT32),
    "uint16": lambda d, D: d.ColumnProfile(D.UINT16),
    "float64": lambda d, D: d.ColumnProfile(D.FLOAT64),
    "bool8": lambda d, D: d.ColumnProfile(D.BOOL8),
    "timestamp_us": lambda d, D: d.ColumnProfile(
        D.DType(D.TypeId.TIMESTAMP_MICROSECONDS)),
}


@pytest.mark.parametrize("name", sorted(_PROFILES))
def test_generate_column_matches_jax(name):
    want = JG.generate_column(10_000, _PROFILES[name](JG, jdt), seed=3)
    got = G.generate_column(10_000, _PROFILES[name](G, dt), seed=3,
                            device="cpu")
    assert_col_equal(want, got)


def test_string_rows_table_is_the_bench_table():
    """utils/datagen.string_rows_table is benchmarks/bench_ops.py's string
    row-conversion table (its lines 109-137), built here with the JAX
    package's own constructors."""
    rows = 10_000
    rng = np.random.default_rng(0)
    want = JTable((
        JColumn.from_numpy(rng.integers(-2**31, 2**31, rows), jdt.INT64),
        JColumn.from_numpy(rng.integers(0, 100, rows).astype(np.int32),
                           jdt.INT32),
        JColumn.from_numpy(rng.standard_normal(rows), jdt.FLOAT64),
        JColumn.from_numpy(rng.integers(0, 2, rows).astype(np.uint8),
                           jdt.BOOL8),
        JG.generate_column(rows, JG.ColumnProfile(
            jdt.STRING, string_len=JG.Dist("normal", 0, 32),
            cardinality=1000, null_frequency=None), seed=0)))
    got = G.string_rows_table(rows, 0, device="cpu")
    assert_table_equal(want, got)
    d = G.string_draws(rows, G.STRING_ROWS_PROFILE,
                       np.random.default_rng(0), None)
    pool = d.pool_strings()
    assert got[4].to_pylist() == [pool[i].decode() for i in d.index]
