"""Port parity: Spark row hashes, the partition route, and kernels B1/B2
(spark_rapids_jni_tpu_torch.ops.hashing, ops.kernels, parallel.exchange)
against the JAX package. Bit-exact: hashes are integers.

The JAX package's Pallas kernels run in interpret mode on the CPU
(``hashing.pallas=on``), as its own test_pallas_kernels.py runs them, at
n <= 4095 rows; its XLA path (``off``) is held at every seed."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.ops import hashing as JH
from spark_rapids_jni_tpu.ops import pallas_kernels as PK
from spark_rapids_jni_tpu.parallel import exchange as jex
from spark_rapids_jni_tpu.utils import config
from spark_rapids_jni_tpu_torch.columnar import dtype as dt
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.ops import hashing as H
from spark_rapids_jni_tpu_torch.ops import kernels
from spark_rapids_jni_tpu_torch.parallel.exchange import partition_ids

from torch_parity import table_to_port


def _mixed_table(n=4095, seed=0, with_nulls=True):
    """The mixed schema of test_pallas_kernels.py, with -0.0 and NaN in
    both float columns."""
    rng = np.random.default_rng(seed)
    v = (lambda: rng.random(n) > 0.25) if with_nulls else (lambda: None)
    f32 = rng.standard_normal(n).astype(np.float32)
    f64 = rng.standard_normal(n)
    for f in (f32, f64):
        f[:6] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
    f64[6] = np.frombuffer(np.uint64(0x7FF8000000000123).tobytes(),
                           np.float64)[0]  # a NaN with a payload
    cols = (
        JColumn.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32),
                           validity=v()),
        JColumn.from_numpy(rng.integers(-2**62, 2**62, n), validity=v()),
        JColumn.from_numpy(f32, validity=v()),
        JColumn.from_numpy(f64, jdt.FLOAT64, validity=v()),
        JColumn.from_numpy(rng.integers(0, 3, n).astype(np.uint8), jdt.BOOL8,
                           validity=v()),
        JColumn.from_numpy(rng.integers(-128, 127, n).astype(np.int8),
                           validity=v()),
    )
    return JTable(cols)


@pytest.fixture(scope="module")
def mixed():
    return {nulls: _mixed_table(4095 if nulls else 257, with_nulls=nulls)
            for nulls in (True, False)}


@pytest.mark.parametrize("algo", ["murmur3", "xxhash64"])
@pytest.mark.parametrize("nulls", [True, False])
@pytest.mark.parametrize("seed", [0, 42, -1])
def test_row_hash_matches_pallas_and_xla(mixed, algo, nulls, seed):
    jt = mixed[nulls]
    jfn = JH.murmur_hash3_32 if algo == "murmur3" else JH.xxhash64
    pfn = H.murmur_hash3_32 if algo == "murmur3" else H.xxhash64
    got = pfn(table_to_port(jt), seed=seed)
    assert got.data.dtype == (torch.int32 if algo == "murmur3"
                              else torch.int64)
    # the XLA path at every seed; the Pallas kernel (interpreted, one
    # compile per seed) at seed 42 — the JAX package's own
    # test_pallas_kernels.py pins the two to each other
    for mode in ("off", "on") if seed == 42 else ("off",):
        with config.override("hashing.pallas", mode):
            want = np.asarray(jfn(jt, seed=seed).data)
        np.testing.assert_array_equal(got.data.numpy(), want, err_msg=mode)


def _neg_nan(width):
    if width == 32:
        return np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]
    return np.frombuffer(np.uint64(0xFFF8000000000000).tobytes(),
                         np.float64)[0]


I32_MIN, I32_MAX = -(2**31), 2**31 - 1
I64_MIN, I64_MAX = -(2**63), 2**63 - 1
F32 = np.finfo(np.float32)
F64 = np.finfo(np.float64)

# Spark's golden vectors (tests/test_hashing.py; the reference's
# hash.cpp MultiValueWithSeeds), fixed-width types
MURMUR_GOLDEN = [
    ("doubles", [0.0, -0.0, _neg_nan(64), float(F64.min), float(F64.max)],
     jdt.FLOAT64, [-1670924195, -853646085, -1281358385, 1897734433,
                   -508695674]),
    ("timestamps", [0, 100, -100, -9223372036854, 9223372036854],
     jdt.TIMESTAMP_MILLISECONDS, [-1670924195, 1114849490, 904948192,
                                  -1832979433, 1752430209]),
    ("longs", [0, 100, -100, I64_MIN, I64_MAX], jdt.INT64,
     [-1670924195, 1114849490, 904948192, -853646085, -1604625029]),
    ("floats", [0.0, -0.0, _neg_nan(32), float(F32.min), float(F32.max)],
     jdt.FLOAT32, [933211791, 723455942, -349261430, -1225560532,
                   -338752985]),
    ("dates", [0, 100, -100, -21474836, 21474836], jdt.TIMESTAMP_DAYS,
     [933211791, 751823303, -1080202046, -1906567553, -1503850410]),
    ("decimal32", [0, 100, -100, -999999999, 999999999], jdt.decimal32(3),
     [-1670924195, 1114849490, 904948192, -1454351396, -193774131]),
    ("ints", [0, 100, -100, I32_MIN, I32_MAX], jdt.INT32,
     [933211791, 751823303, -1080202046, 723455942, 133916647]),
    ("shorts", [0, 100, -100, -32768, 32767], jdt.INT16,
     [933211791, 751823303, -1080202046, -1871935946, 1249274084]),
    ("bytes", [0, 100, -100, -128, 127], jdt.INT8,
     [933211791, 751823303, -1080202046, 1110053733, 1135925485]),
    ("bools", [0, 1, 2, 255, 0], jdt.BOOL8,
     [933211791, -559580957, -559580957, -559580957, 933211791]),
]

NULLS8 = [True, True, True, True, True, False, True, True]
XX_GOLDEN = [
    ("doubles", [0.0, -0.0, _neg_nan(64), float(F64.min), float(F64.max),
                 0.0, 100.0, 200.0], jdt.FLOAT64,
     [-5252525462095825812, -5252525462095825812, -3127944061524951246,
      9065082843545458248, -4222314252576420879, 42,
      -7996023612001835843, -8838535416664833914]),
    ("longs", [0, 100, -100, I64_MIN, I64_MAX, 0, 0x123456789ABCDEF,
               -0x123456789ABCDEF], jdt.INT64,
     [-5252525462095825812, 8713583529807266080, 5675770457807661948,
      -8619748838626508300, -3246596055638297850, 42,
      1941233597257011502, -1318946533059658749]),
    ("floats", [0.0, -0.0, _neg_nan(32), float(F32.min), float(F32.max),
                0.0, float("inf"), float("-inf")], jdt.FLOAT32,
     [3614696996920510707, 3614696996920510707, 2692338816207849720,
      -8545425418825163117, -1065250890878313112, 42,
      -5940311692336719973, -7580553461823983095]),
    ("decimal64", [0, 100, -100, -999999999999999999, 999999999999999999,
                   0, 123, 432], jdt.decimal64(7),
     [-5252525462095825812, 8713583529807266080, 5675770457807661948,
      4265531446127695490, 2162198894918931945, 42,
      -3178482946328430151, 4788666723486520022]),
    ("dates", [0, 100, -100, -21474836, 21474836, 0, -200, -300],
     jdt.TIMESTAMP_DAYS,
     [3614696996920510707, -7987742665087449293, 8990748234399402673,
      -8442426365007754391, -1447590449373190349, 42,
      -953008374380745918, 2895908635257747121]),
    ("decimal32", [0, 100, -100, -999999999, 999999999, 0, -200, -300],
     jdt.decimal32(3),
     [-5252525462095825812, 8713583529807266080, 5675770457807661948,
      8670643431269007867, 6810183316718625826, 42,
      7277994511003214036, 6264187449999859617]),
    ("shorts", [0, 100, -100, -32768, 32767, 0, -200, -300], jdt.INT16,
     [3614696996920510707, -7987742665087449293, 8990748234399402673,
      -904511417458573795, 8952525448871805501, 42,
      -953008374380745918, 2895908635257747121]),
    ("bytes", [0, 100, -100, -128, 127, 0, -90, -80], jdt.INT8,
     [3614696996920510707, -7987742665087449293, 8990748234399402673,
      4160238337661960656, 8632298611707923906, 42,
      -4008061843281999337, 6690883199412647955]),
    ("bools", [0, 1, 2, 255, 0, 0, 0, 0], jdt.BOOL8,
     [3614696996920510707, -6698625589789238999, -6698625589789238999,
      -6698625589789238999, 3614696996920510707, 42,
      3614696996920510707, 3614696996920510707]),
]


def _golden_col(vals, jd, validity=None):
    arr = np.array(vals, dtype=jd.np_dtype)
    return JColumn.from_numpy(arr, jd, validity=validity)


@pytest.mark.parametrize("case", MURMUR_GOLDEN, ids=lambda c: c[0])
def test_murmur3_golden_vectors(case):
    _, vals, jd, want = case
    jc = _golden_col(vals, jd)
    port = H.murmur_hash3_32(table_to_port(JTable((jc,))), 42)
    assert port.to_pylist() == want
    assert JH.murmur_hash3_32([jc], 42).to_pylist() == want


@pytest.mark.parametrize("case", XX_GOLDEN, ids=lambda c: c[0])
def test_xxhash64_golden_vectors(case):
    _, vals, jd, want = case
    jc = _golden_col(vals, jd, validity=np.array(NULLS8))
    port = H.xxhash64(table_to_port(JTable((jc,))), 42)
    assert port.to_pylist() == want
    assert JH.xxhash64([jc], 42).to_pylist() == want


def test_combined_golden_chain_matches_jax():
    """All fixed-width golden columns chained in one row hash."""
    mm = JTable(tuple(_golden_col(v, d) for _, v, d, _ in MURMUR_GOLDEN))
    xx = JTable(tuple(_golden_col(v, d, np.array(NULLS8))
                      for _, v, d, _ in XX_GOLDEN))
    np.testing.assert_array_equal(
        H.murmur_hash3_32(table_to_port(mm)).data.numpy(),
        np.asarray(JH.murmur_hash3_32(mm).data))
    np.testing.assert_array_equal(
        H.xxhash64(table_to_port(xx)).data.numpy(),
        np.asarray(JH.xxhash64(xx).data))


@pytest.mark.parametrize("keys", [[0], [1, 3]])
def test_partition_ids_200_match(mixed, keys):
    jt = mixed[True]
    got = partition_ids(table_to_port(jt), keys, 200)
    want = np.asarray(jex.partition_ids(jt, keys, 200))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 <= int(got.min()) and int(got.max()) < 200


def _kernel_schema(jt, for_xx):
    """The same columns as the port's hash schema and the JAX package's
    pre-split u32 lanes + (kind, has_mask) schema."""
    lanes, jschema, schema = [], [], []
    for jc in jt.columns:
        kind, words = JH._fixed_element_words(jc.dtype, jc.data, for_xx)
        if kind == "u64":
            lanes.extend(PK.split_u64_lanes(words))
        else:
            lanes.append(words)
        if jc.validity is not None:
            lanes.append(jc.validity.astype(np.uint32))
        jschema.append((kind, jc.validity is not None))
    pt = table_to_port(jt)
    for c in pt.columns:
        kind, words = H._fixed_element_words(c.dtype, c.data, for_xx)
        schema.append((kind, words, c.validity))
    return lanes, tuple(jschema), schema


@pytest.mark.parametrize("algo", ["murmur3", "xxhash64"])
def test_kernel_plain_versions_match_pallas_kernels(mixed, algo):
    """ops/kernels.py's CPU path against the Pallas kernels it replaces,
    called directly (interpret mode; seed 42 reuses the kernels the row
    hash test above compiled)."""
    jt = mixed[True]
    n = jt.num_rows
    lanes, jschema, schema = _kernel_schema(jt, algo == "xxhash64")
    if algo == "murmur3":
        got = kernels.murmur3_fixed_rows(schema, 42, n)
        want = PK.murmur3_fixed_rows(lanes, jschema, 42, n, interpret=True)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
    else:
        got = kernels.xxhash64_fixed_rows(schema, 42, n)
        want = PK.xxhash64_fixed_rows(lanes, jschema, 42, n, interpret=True)
        np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                      np.asarray(want))
    assert kernels.murmur3_fixed_rows.launches == 0  # CPU: no launch


def test_kernel_wrappers_compute_plain_only_on_the_cpu():
    """A wrapper takes its plain version for CPU tensors only: tensors on
    any other device, or split across devices, raise (no fallback)."""
    meta = torch.empty(4, dtype=torch.int64, device="meta")
    cpu = torch.zeros(4, dtype=torch.int64)
    for fn in (kernels.murmur3_fixed_rows, kernels.xxhash64_fixed_rows):
        with pytest.raises(ValueError, match="unsupported device"):
            fn([("u64", meta, None)], 42, 4)
        with pytest.raises(ValueError, match="span devices"):
            fn([("u64", cpu, torch.ones(4, dtype=torch.bool,
                                        device="meta"))], 42, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.rowconv_fixed_words([meta], [None], [(0, 0, 3, 0)], 2, 4)


def test_unported_hash_inputs_raise():
    s = Column(dt.DType(dt.TypeId.STRING), 0)
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        H.murmur_hash3_32([s])
    assert H.xxhash64([]).size == 0
