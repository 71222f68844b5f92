"""The port's Parquet read path against the JAX package's, on the CPU.

Files are written with pyarrow and with the port's own writer
(utils/datagen_parquet.py, parquet-mr's defaults) at a few thousand rows,
several row groups and small pages. Each goes through both packages'
``read_parquet`` on both tiers: the host tier (native decode) and the
device tier (``parquet.device_decode=device``: the JAX package's XLA ops
on the CPU, the port's torch ops on ``device="cpu"``). Values, validity
(presence included), dictionaries, chunk boundaries and pushdown counters
must agree bit for bit. The crash-containment sandbox, the page-checksum
re-read, the footer filter and the not-ported column types are checked
the same way, and the port's modules import with JAX refused.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from spark_rapids_jni_tpu.faultinj import breaker as jbreaker  # noqa: E402
from spark_rapids_jni_tpu.faultinj import guard as jguard  # noqa: E402
from spark_rapids_jni_tpu.faultinj import injector as jinjector  # noqa: E402
from spark_rapids_jni_tpu.faultinj import sandbox as jsandbox  # noqa: E402
from spark_rapids_jni_tpu.parquet import SchemaBuilder as JSchemaBuilder  # noqa: E402
from spark_rapids_jni_tpu.parquet import read_and_filter as j_read_and_filter  # noqa: E402
from spark_rapids_jni_tpu.parquet import reader as jreader  # noqa: E402
from spark_rapids_jni_tpu.plan import expr as jex  # noqa: E402
from spark_rapids_jni_tpu.utils import config as jconfig  # noqa: E402
from spark_rapids_jni_tpu_torch.columnar import dictionary as D  # noqa: E402
from spark_rapids_jni_tpu_torch.columnar import encodings as E  # noqa: E402
from spark_rapids_jni_tpu_torch.faultinj import breaker as pbreaker  # noqa: E402
from spark_rapids_jni_tpu_torch.faultinj import guard as pguard  # noqa: E402
from spark_rapids_jni_tpu_torch.faultinj import injector as pinjector  # noqa: E402
from spark_rapids_jni_tpu_torch.faultinj import sandbox as psandbox  # noqa: E402
from spark_rapids_jni_tpu_torch.parquet import SchemaBuilder, read_and_filter  # noqa: E402
from spark_rapids_jni_tpu_torch.parquet import reader as preader  # noqa: E402
from spark_rapids_jni_tpu_torch.plan import expr as pex  # noqa: E402
from spark_rapids_jni_tpu_torch.utils import config as pconfig  # noqa: E402
from spark_rapids_jni_tpu_torch.utils import datagen_parquet as W  # noqa: E402
from torch_parity import assert_table_equal  # noqa: E402

TIERS = ("host", "device")
_TIER_VALUE = {"host": "native", "device": "device"}


@pytest.fixture(autouse=True)
def _clean():
    def reset():
        for inj in (jinjector, pinjector):
            inj.uninstall()
        for sb in (jsandbox, psandbox):
            sb.shutdown_all()
            sb.reset_quarantine()
        for br in (jbreaker, pbreaker):
            br.reset_all()
        for g in (jguard, pguard):
            g.metrics.reset()
        for m in (jreader.reader_metrics, preader.reader_metrics,
                  preader.route_metrics):
            m.reset()
    reset()
    yield
    reset()


class _both:
    """One config override on both packages."""

    def __init__(self, key, value):
        self._ctx = [jconfig.override(key, value),
                     pconfig.override(key, value)]

    def __enter__(self):
        for c in self._ctx:
            c.__enter__()

    def __exit__(self, *a):
        for c in reversed(self._ctx):
            c.__exit__(*a)


def read_both(path, tier, predicate=None, **kw):
    """(JAX table, port table) of one file on one tier; ``predicate``
    builds the pushdown expression from a package's plan.expr module."""
    with _both("parquet.device_decode", _TIER_VALUE[tier]):
        jt = jreader.read_parquet(
            path, predicate=predicate and predicate(jex), **kw)
        pt = preader.read_parquet(
            path, predicate=predicate and predicate(pex), device="cpu",
            **kw)
    return jt, pt


def assert_parity(path, tiers=TIERS, **kw):
    out = {}
    for tier in tiers:
        jt, pt = read_both(path, tier, **kw)
        assert_table_equal(jt, pt)
        out[tier] = pt
    return out


def _valid_rows_equal(a, b, where):
    """Same validity bits, and the same value bits on the valid rows (the
    tiers differ on what a null row holds)."""
    va, vb = a.valid_mask(), b.valid_mask()
    assert torch.equal(va, vb), where
    if a.dtype.id.value == "string":
        assert a.to_pylist() == b.to_pylist(), where
        return
    w = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    bits = w[a.data.element_size()]
    assert torch.equal(a.data.view(bits)[va], b.data.view(bits)[vb]), where


def assert_port_tiers(path, **kw):
    """The port's two tiers against the JAX package's host tier (no XLA
    compiles): the port's host tier bit for bit; its device tier on the
    valid rows (a null row of a dictionary column holds entry 0 there)."""
    with jconfig.override("parquet.device_decode", "native"):
        jt = jreader.read_parquet(path, **kw)
    out = {}
    for tier in TIERS:
        with pconfig.override("parquet.device_decode", _TIER_VALUE[tier]):
            out[tier] = preader.read_parquet(path, device="cpu", **kw)
    assert_table_equal(jt, out["host"])
    for i, (a, b) in enumerate(zip(out["host"], out["device"])):
        _valid_rows_equal(a, b, f"column {i}")
    return out


def _nulls(n, every, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random(n) < 1.0 / every


def _edge_f64(n, seed=0):
    """float64 values with NaN payloads, +-0, +-inf and subnormals."""
    rng = np.random.default_rng(seed)
    bits = rng.standard_normal(n).view(np.uint64).copy()
    specials = np.array([0x7FF8000000000001, 0xFFF8DEADBEEF0001,
                         0x7FF0000000000123, 0x8000000000000000, 0,
                         0x7FF0000000000000, 0xFFF0000000000000, 1,
                         0x800FFFFFFFFFFFFF], np.uint64)
    bits[rng.integers(0, n, 4 * specials.size)] = np.tile(specials, 4)
    return bits.view(np.float64)


def _types_table(n=2400, seed=0):
    rng = np.random.default_rng(seed)
    m = _nulls(n, 6, seed)

    def arr(v, typ=None, mask=m):
        return pa.array(v, type=typ, mask=mask)

    strings = rng.choice(np.array(["AIR", "RAIL", "", "SHIP", "TRUCK"]), n)
    return pa.table({
        "i32": arr(rng.integers(-2**31, 2**31, n, dtype=np.int32)),
        "i64": arr(rng.integers(-2**62, 2**62, n, dtype=np.int64)),
        "f32": arr(rng.standard_normal(n).astype(np.float32)),
        "f64": arr(_edge_f64(n, seed), mask=None),
        "b": arr(rng.random(n) > 0.5),
        "date": arr(rng.integers(-1000, 20000, n).astype(np.int32),
                    pa.date32()),
        "ts_ms": arr(rng.integers(0, 2**40, n), pa.timestamp("ms")),
        "ts_us": arr(rng.integers(0, 2**50, n), pa.timestamp("us")),
        "d32": pa.array([None if x else __import__("decimal").Decimal(v)
                         .scaleb(-2) for x, v in
                         zip(m, rng.integers(-10**8, 10**8, n).tolist())],
                        pa.decimal128(9, 2)),
        "d64": pa.array([None if x else __import__("decimal").Decimal(v)
                         .scaleb(-4) for x, v in
                         zip(m, rng.integers(-10**17, 10**17, n).tolist())],
                        pa.decimal128(18, 4)),
        "s": arr(strings),
        "s_dict": arr(rng.choice(np.array(["k0", "k1", "", "k3"]), n)),
    })


@pytest.fixture(scope="module")
def types_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pq") / "types.parquet")
    # one page per chunk, 800 rows: the JAX package's device tier compiles
    # one program per page shape, so the tests share this one
    pq.write_table(_types_table(), path, row_group_size=800,
                   data_page_size=1 << 20, store_decimal_as_integer=True,
                   use_dictionary=["i32", "date", "s_dict", "d32"])
    return path


def test_types_bit_for_bit(types_file):
    """Every flat type on both tiers: the port == the JAX package, and
    the FLOAT64 bits (NaN payloads included) == the written ones."""
    out = assert_parity(types_file)
    want = pq.read_table(types_file)
    for tier, t in out.items():
        f64 = t[3].data.numpy().view(np.uint64)
        src = want.column("f64").to_numpy().view(np.uint64)
        np.testing.assert_array_equal(f64, src, err_msg=tier)
        assert t[11].to_pylist() == want.column("s_dict").to_pylist()


def test_int96_timestamps(tmp_path):
    path = str(tmp_path / "int96.parquet")
    ts = pa.array(np.arange(1000, dtype=np.int64) * 10**9 + 123_456_000,
                  pa.timestamp("ns"), mask=_nulls(1000, 5))
    pq.write_table(pa.table({"t": ts}), path,
                   use_deprecated_int96_timestamps=True, row_group_size=400)
    out = assert_parity(path)
    # INT96 is never the device tier's: both tiers decode it natively
    assert out["device"][0].dtype.id.value == "timestamp_us"


@pytest.mark.parametrize("version,codec", [
    ("1.0", "NONE"), ("1.0", "SNAPPY"), ("1.0", "GZIP"),
    ("2.0", "NONE"), ("2.0", "SNAPPY"), ("2.0", "GZIP")])
def test_page_versions_and_codecs(tmp_path, version, codec):
    n = 1600
    rng = np.random.default_rng(1)
    m = _nulls(n, 4, 1)
    t = pa.table({
        "k": pa.array(rng.integers(0, 40, n), mask=m),
        "v": pa.array(rng.standard_normal(n), mask=m),
        "s": pa.array(rng.choice(np.array(["a", "bb", "", "dddd"]), n),
                      mask=m),
    })
    path = str(tmp_path / "v.parquet")
    pq.write_table(t, path, data_page_version=version, compression=codec,
                   row_group_size=800, data_page_size=4096)
    if (version, codec) == ("1.0", "NONE"):
        assert_parity(path)
    else:  # the same page shapes: the JAX host tier is the reference
        assert_port_tiers(path)


def test_plain_and_dictionary_fallback(tmp_path):
    """PLAIN chunks take the device tier; a chunk whose dictionary
    overflowed mid-chunk (index pages, then PLAIN pages) takes the host
    tier in both packages."""
    n = 3000
    rng = np.random.default_rng(2)
    t = pa.table({
        "plain": pa.array(rng.integers(0, 10, n)),
        "fallback": pa.array(np.concatenate([
            rng.integers(0, 8, n // 2), np.arange(n - n // 2) + 1000])),
    })
    path = str(tmp_path / "fb.parquet")
    pq.write_table(t, path, use_dictionary=["fallback"],
                   dictionary_pagesize_limit=256, data_page_size=512,
                   row_group_size=n)
    before = preader.route_metrics.snapshot()
    assert_parity(path, tiers=("device",))
    after = preader.route_metrics.snapshot()
    assert after["device_columns"] - before["device_columns"] == 1
    assert after["host_columns_unsupported"] \
        - before["host_columns_unsupported"] == 1
    assert_parity(path, tiers=("host",))


def test_encoded_strings_and_ints(tmp_path):
    """parquet.encoded_strings / encoded_ints: DICT32 from a dictionary
    string chunk, RLE from all-RLE index runs, FOR from a bit-packed page
    over a dense dictionary; the same dictionaries, runs and packed bytes
    in both packages."""
    n = 4096
    rng = np.random.default_rng(3)
    t = pa.table({
        "s": pa.array(np.repeat(np.array(["x", "yy", "", "zzz"]), n // 4),
                      mask=_nulls(n, 9, 3)),
        "rle": pa.array(np.repeat(np.arange(64, dtype=np.int64) * 5, 64)),
        "for": pa.array(1000 + np.arange(n, dtype=np.int32) % 32),
        "plain": pa.array(rng.integers(0, 2**40, n)),
    })
    path = str(tmp_path / "enc.parquet")
    pq.write_table(t, path, row_group_size=n, use_dictionary=["s", "rle",
                                                              "for"])
    with _both("parquet.encoded_strings", True), \
            _both("parquet.encoded_ints", True):
        out = assert_parity(path, tiers=("device",))["device"]
    assert D.is_dict(out[0])
    assert E.is_rle(out[1]) and E.is_for(out[2])
    assert D.materialize(out[0]).to_pylist() == t.column("s").to_pylist()
    assert out[1].to_pylist() == t.column("rle").to_pylist()


def test_dict32_across_row_groups(tmp_path):
    """DICT32 chunks of several row groups with different dictionaries
    concatenate onto the union (first-seen order) in both packages."""
    n = 3000
    vals = np.array([f"v{i % 7 if i < 1500 else i % 11}" for i in range(n)])
    path = str(tmp_path / "d.parquet")
    pq.write_table(pa.table({"s": pa.array(vals, mask=_nulls(n, 13))}),
                   path, row_group_size=1000)
    with _both("parquet.encoded_strings", True):
        out = assert_parity(path, tiers=("device",))["device"]
    assert D.is_dict(out[0]) and D.dict_values(out[0]).size == 11


def test_iter_chunks_boundaries(tmp_path):
    n = 4000
    rng = np.random.default_rng(4)
    t = pa.table({"a": pa.array(rng.integers(0, 100, n)),
                  "b": pa.array(rng.standard_normal(n), mask=_nulls(n, 5))})
    path = str(tmp_path / "c.parquet")
    pq.write_table(t, path, row_group_size=800)
    for tier in TIERS:
        with _both("parquet.device_decode", _TIER_VALUE[tier]):
            with jreader.ParquetReader(path) as r:
                jchunks = list(r.iter_chunks(byte_budget=15000))
            with preader.ParquetReader(path, device="cpu") as r:
                pchunks = list(r.iter_chunks(byte_budget=15000))
        assert [c.num_rows for c in jchunks] == \
            [c.num_rows for c in pchunks]
        assert len(pchunks) > 1
        for a, b in zip(jchunks, pchunks):
            assert_table_equal(a, b)


def _pushdown_file(tmp_path):
    rng = np.random.default_rng(5)
    n = 4096
    pool = np.array([f"key_{i:03d}" for i in range(50)])
    vals = pool[rng.integers(0, 50, n)].astype(object)
    vals[4000] = "needle"
    path = str(tmp_path / "push.parquet")
    pq.write_table(pa.table({"k": pa.array(vals),
                             "i": pa.array(np.arange(n, dtype=np.int64))}),
                   path, row_group_size=512)
    return path


@pytest.mark.parametrize("case", ["membership", "in_shape", "stat",
                                  "stat_and_membership", "off"])
def test_pushdown_same_groups_and_counters(tmp_path, case):
    path = _pushdown_file(tmp_path)
    preds = {
        "membership": lambda x: x.col(0) == "needle",
        "in_shape": lambda x: (x.col(0) == "needle")
        | (x.col(0) == "absent"),
        "stat": lambda x: x.col(1) >= 3000,
        "stat_and_membership": lambda x: (x.col(1) < 2000)
        & (x.col(0) == "needle"),
        "off": lambda x: x.col(0) == "needle",
    }
    with _both("parquet.predicate_pushdown", case != "off"):
        for tier in TIERS:
            jreader.reader_metrics.reset()
            preader.reader_metrics.reset()
            jt, pt = read_both(path, tier, predicate=preds[case])
            assert jreader.reader_metrics.snapshot() == \
                preader.reader_metrics.snapshot()
            assert_table_equal(jt, pt)
    skipped = preader.reader_metrics.snapshot()["row_groups_skipped"]
    assert skipped == {"membership": 7, "in_shape": 7, "stat": 5,
                       "stat_and_membership": 8, "off": 0}[case]


def _footer_of(data: bytes) -> bytes:
    flen = int.from_bytes(data[-8:-4], "little")
    return data[-8 - flen:-8]


def _pq_bytes(table, **kw) -> bytes:
    import io
    buf = io.BytesIO()
    pq.write_table(table, buf, **kw)
    return buf.getvalue()


def _footer_cases():
    flat = pa.table({"a": pa.array(np.arange(100, dtype=np.int64)),
                     "b": pa.array(np.arange(100, dtype=np.float64)),
                     "c": pa.array([f"s{i}" for i in range(100)])})
    nested = pa.table({
        "s": pa.array([{"x": 1, "y": "a"}, {"x": 2, "y": "b"}],
                      type=pa.struct([("x", pa.int64()),
                                      ("y", pa.string())])),
        "l": pa.array([[1, 2], [3]], type=pa.list_(pa.int64())),
        "m": pa.array([[("k1", 1)], [("k2", 2)]],
                      type=pa.map_(pa.string(), pa.int64())),
        "v": pa.array([1, 2], type=pa.int64())})
    split = pa.table({"a": pa.array(np.arange(1000, dtype=np.int64))})
    return [
        ("flat", _pq_bytes(flat), lambda B: B().add_value("a")
         .add_value("c").build(), False, None),
        ("ignore_case", _pq_bytes(flat), lambda B: B().add_value("A")
         .add_value("C").build(), True, None),
        ("missing", _pq_bytes(flat), lambda B: B().add_value("a")
         .add_value("zz").build(), False, None),
        ("struct", _pq_bytes(nested), lambda B: B().start_struct("s")
         .add_value("x").end_struct().build(), False, None),
        ("list_map", _pq_bytes(nested), lambda B: B().start_list("l")
         .add_value("element").end_list().start_map("m").add_value("key")
         .add_value("value").end_map().build(), False, None),
        ("split_half", _pq_bytes(split, row_group_size=100),
         lambda B: B().add_value("a").build(), False, 0.5),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _footer_cases()])
def test_read_and_filter_matches(case):
    name, data, schema, ignore_case, split = next(
        c for c in _footer_cases() if c[0] == case)
    off, length = (0, 1 << 40) if split is None else \
        (0, int(len(data) * split))
    with j_read_and_filter(_footer_of(data), off, length,
                           schema(JSchemaBuilder), ignore_case) as jf, \
            read_and_filter(_footer_of(data), off, length,
                            schema(SchemaBuilder), ignore_case) as pf:
        assert (pf.num_rows(), pf.num_columns()) == \
            (jf.num_rows(), jf.num_columns())
        assert pf.serialize_thrift_file() == jf.serialize_thrift_file()


def _fault_cfg(tmp_path, api, rule):
    p = tmp_path / f"{api}.json"
    p.write_text(json.dumps({"xlaRuntimeFaults": {api: rule}}))
    return str(p)


@pytest.fixture
def crc_file(tmp_path):
    path = str(tmp_path / "crc.parquet")
    rng = np.random.default_rng(11)
    pq.write_table(pa.table({"v": pa.array(rng.integers(-10**9, 10**9,
                                                        4000))}),
                   path, write_page_checksum=True, compression="snappy")
    return path


@pytest.mark.parametrize("tier", TIERS)
def test_page_flip_recovered(tmp_path, crc_file, tier):
    """One flipped bit at ``parquet_page``: the page checksum catches it,
    the chunk is re-read from source (on the host tier), the answer is
    bit-identical and the detection counted, in both packages (the JAX
    package's device tier reads around the flip surface)."""
    cfg = _fault_cfg(tmp_path, "parquet_page",
                     {"percent": 100, "injectionType": 3,
                      "interceptionCount": 1})
    clean = read_both(crc_file, tier)
    jinjector.install(cfg, seed=3)
    pinjector.install(cfg, seed=3)
    jt, pt = read_both(crc_file, tier)
    # the port's device tier re-reads the flipped chunk on the host tier,
    # whose column carries no validity when no row is null: the bits agree
    assert_table_equal(jt, pt, presence=tier == "host")
    assert_table_equal(clean[0], pt, presence=tier == "host")
    assert pguard.metrics.snapshot()["corruption_detected"] == 1
    if tier == "host":
        assert jguard.metrics.snapshot()["corruption_detected"] == 1
    else:
        assert preader.route_metrics.snapshot()[
            "host_columns_corruption"] == 1


def test_sandboxed_decode_equals_in_process(crc_file):
    with pconfig.override("parquet.device_decode", "native"):
        want = preader.read_parquet(crc_file, device="cpu")
        with pconfig.override("sandbox.enabled", True):
            got = preader.read_parquet(crc_file, device="cpu")
            pid = psandbox.get_worker().pid()
            again = preader.read_parquet(crc_file, device="cpu")
            assert psandbox.get_worker().pid() == pid  # one worker reused
    assert pid is not None
    assert_table_equal(want, got)
    assert_table_equal(want, again)
    m = pguard.metrics.snapshot()
    assert (m["crash_detected"], m["worker_respawns"]) == (0, 0)


def _crash(tmp_path, count):
    return _fault_cfg(tmp_path, "parquet_page_decode",
                      {"percent": 100, "injectionType": 5,
                       "interceptionCount": count, "crashMode": "abort"})


def test_injected_crash_raises_and_replays(tmp_path, crc_file):
    with pconfig.override("parquet.device_decode", "native"):
        want = preader.read_parquet(crc_file, device="cpu")
        pinjector.install(_crash(tmp_path, 1), seed=0)
        with pconfig.override("sandbox.enabled", True):
            with pytest.raises(psandbox.WorkerCrashError) as ei:
                preader.read_parquet(crc_file, device="cpu")
            assert ei.value.signum == 6  # SIGABRT, inside the worker
            got = preader.read_parquet(crc_file, device="cpu")  # replay
    assert_table_equal(want, got)
    m = pguard.metrics.snapshot()
    assert (m["injected_crashes"], m["crash_detected"],
            m["worker_respawns"]) == (1, 1, 1)


def test_quarantine_after_max_replays(tmp_path, crc_file):
    pinjector.install(_crash(tmp_path, 100), seed=0)
    with pconfig.override("parquet.device_decode", "native"), \
            pconfig.override("sandbox.enabled", True), \
            pconfig.override("sandbox.max_replays", 2), \
            pconfig.override("breaker.threshold", 100):
        for _ in range(2):
            with pytest.raises(psandbox.WorkerCrashError):
                preader.read_parquet(crc_file, device="cpu")
        with pytest.raises(psandbox.QuarantinedInputError):
            preader.read_parquet(crc_file, device="cpu")
    m = pguard.metrics.snapshot()
    assert (m["quarantined_inputs"], m["crash_detected"]) == (1, 2)


def test_breaker_opens_and_routes_in_process(tmp_path, crc_file):
    with pconfig.override("parquet.device_decode", "native"):
        want = preader.read_parquet(crc_file, device="cpu")
        pinjector.install(_crash(tmp_path, 100), seed=0)
        with pconfig.override("sandbox.enabled", True), \
                pconfig.override("breaker.threshold", 2), \
                pconfig.override("breaker.cooldown_s", 300.0):
            for _ in range(2):
                with pytest.raises(psandbox.WorkerCrashError):
                    preader.read_parquet(crc_file, device="cpu")
            assert pbreaker.lookup("parquet_page_decode").state() == "open"
            got = preader.read_parquet(crc_file, device="cpu")
    assert_table_equal(want, got)
    m = pguard.metrics.snapshot()
    assert m["breaker_opened"] == 1 and m["breaker_short_circuits"] >= 1


@pytest.mark.parametrize("kind,item", [("list", "A1"), ("struct", "A1"),
                                       ("decimal128", "A12")])
def test_not_ported_columns_raise(tmp_path, kind, item):
    import decimal
    col = {"list": pa.array([[1, 2], [3]], pa.list_(pa.int64())),
           "struct": pa.array([{"x": 1}, {"x": 2}],
                              pa.struct([("x", pa.int64())])),
           "decimal128": pa.array([decimal.Decimal("1.5"), None],
                                  pa.decimal128(30, 1))}[kind]
    path = str(tmp_path / f"{kind}.parquet")
    pq.write_table(pa.table({"c": col, "v": pa.array([1, 2])}), path)
    got = preader.read_parquet(path, device="cpu")[0]
    if kind == "decimal128":  # ported by A12: FLBA reads on the host tier
        assert got.dtype.id.value == "decimal128" and got.dtype.scale == 1
        assert got.to_pylist() == col.to_pylist()
    else:  # ported by A1: nested columns
        assert got.dtype.id.value == kind
        want = col.to_pylist()
        if kind == "struct":
            want = [tuple(v.values()) for v in want]
        assert got.to_pylist() == want
    # the flat column beside it still reads
    assert preader.read_parquet(path, columns=["v"],
                                device="cpu")[0].to_pylist() == [1, 2]


def _writer_columns(n=6000, seed=7):
    rng = np.random.default_rng(seed)
    m = ~_nulls(n, 7, seed)
    entries = [f"e{i}".encode() for i in range(40)] + [b""]
    return [
        W.ParquetColumn("i32", values=rng.integers(0, 50, n)
                        .astype(np.int32), valid=m),
        W.ParquetColumn("i64", values=rng.integers(-2**60, 2**60, n)),
        W.ParquetColumn("f32", values=rng.standard_normal(n)
                        .astype(np.float32), valid=m),
        W.ParquetColumn("f64", values=_edge_f64(n, seed)),
        W.ParquetColumn("b", values=rng.random(n) > 0.5, valid=m),
        W.ParquetColumn("date", values=rng.integers(0, 20000, n)
                        .astype(np.int32), converted=W.DATE),
        # each chunk's first page repeats 10 values, the rest are new: the
        # dictionary passes its cap on the second page
        W.ParquetColumn("fallback", values=np.where(
            np.arange(n) % 2500 < 1000, rng.integers(0, 10, n),
            np.arange(n) * 7).astype(np.int64)),
        W.string_codes("key", np.repeat(rng.integers(0, 41, n // 6), 6),
                       entries, valid=m),
        W.string_column("s", [None if i % 11 == 0 else "x" * (i % 23)
                              for i in range(n)]),
    ]


def _want(c, i):
    if c.valid is not None and not c.valid[i]:
        return None
    if c.values is not None:
        return c.values[i].item()
    if c.codes is not None:
        return c.entries[c.codes[i]].decode()
    return c.chars[c.offsets[i]:c.offsets[i + 1]].tobytes().decode()


def test_writer_reads_back_through_pyarrow_and_both_packages(tmp_path):
    cols = _writer_columns()
    path = str(tmp_path / "w.parquet")
    info = W.write_parquet(path, cols, row_group_rows=2500, page_rows=1000,
                           dict_page_bytes=2048)
    assert info["row_groups"] == [2500, 2500, 1000]
    assert info["encodings"]["fallback"][0] == ["PLAIN", "PLAIN_DICTIONARY"]
    assert info["encodings"]["key"][0] == ["PLAIN_DICTIONARY"]
    assert info["encodings"]["i64"][0] == ["PLAIN"]
    t = pq.read_table(path)
    md = pq.ParquetFile(path).metadata
    for c in cols:
        got = t.column(c.name).to_pylist()
        if c.name == "f64":
            np.testing.assert_array_equal(
                t.column(c.name).to_numpy().view(np.uint64),
                c.values.view(np.uint64))
        elif c.name == "date":
            assert [x.toordinal() - 719163 for x in got] == \
                c.values.tolist()
        else:
            assert got == [_want(c, i) for i in range(c.rows)], c.name
    st = md.row_group(0).column(0).statistics
    live = cols[0].values[:2500][cols[0].valid[:2500]]
    assert (st.min, st.max, st.null_count) == \
        (live.min(), live.max(), 2500 - live.size)
    before = preader.route_metrics.snapshot()
    out = assert_port_tiers(path)
    after = preader.route_metrics.snapshot()
    # the device tier takes every column but the mid-chunk fallback
    assert after["device_columns"] - before["device_columns"] == 8
    assert after["host_columns_unsupported"] \
        - before["host_columns_unsupported"] == 1
    assert out["device"][7].to_pylist() == t.column("key").to_pylist()
    # the handed dictionary reads back as DICT32 in the order given
    with pconfig.override("parquet.encoded_strings", True), \
            pconfig.override("parquet.device_decode", "device"):
        dkey = preader.read_parquet(path, columns=["key"], device="cpu")[0]
    assert list(D._entries(D.dict_values(dkey))) == cols[7].entries
    np.testing.assert_array_equal(dkey.data.numpy()[cols[7].valid],
                                  cols[7].codes[cols[7].valid])


def test_writer_hybrid_matches_parquet_mr_runs():
    """The encoder's run layout: an RLE run only where 8 values from a
    group boundary repeat, bit-packed runs of at most 63 groups."""
    v = np.concatenate([np.arange(5) % 2, np.zeros(20, np.int64),
                        np.arange(1100) % 3]).astype(np.int64)
    enc = W.hybrid_encode(v, 2)
    from spark_rapids_jni_tpu_torch.parquet import device_decode as dd
    kinds, counts, values, _ = dd._walk_runs(
        np.frombuffer(enc, np.uint8), 0, len(enc), v.size, 2)
    # 5 + 21 zeros: the group at 0 is mixed, the one at 8 is all zero ->
    # bit-packed [0, 8), RLE [8, 26), then 63 + 63 + 12 groups bit-packed
    assert kinds[:3] == [1, 0, 1] and counts[:2] == [8, 18]
    assert counts[2] == 63 * 8 and kinds[3] == 1
    expanded = dd._Runs()
    expanded.add_page((kinds, counts, values, _), 0, v.size, 2)
    got = expanded.expand(dd._device_blob(np.frombuffer(enc, np.uint8)
                                          .copy(), torch.device("cpu")),
                          v.size)
    np.testing.assert_array_equal(got.numpy(), v)


def test_port_imports_without_jax(tmp_path):
    """The port's parquet, faultinj and writer modules import, and a file
    reads on both tiers, in a process that refuses to import jax or the
    JAX package."""
    path = str(tmp_path / "x.parquet")
    W.write_parquet(path, _writer_columns(300), page_rows=100)
    script = textwrap.dedent(f"""
        import importlib.abc, sys
        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("jax", "jaxlib",
                                          "spark_rapids_jni_tpu"):
                    raise ImportError("refused: " + name)
        sys.meta_path.insert(0, Refuse())
        from spark_rapids_jni_tpu_torch import parquet, faultinj
        from spark_rapids_jni_tpu_torch.faultinj import sandbox, breaker
        from spark_rapids_jni_tpu_torch.utils import config, datagen_parquet
        for tier in ("native", "device"):
            with config.override("parquet.device_decode", tier):
                t = parquet.read_parquet({path!r}, device="cpu")
            assert t.num_rows == 300
        print("ok")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_hung_worker_killed_and_classified_crash():
    """A worker that stops answering is not waited on: the caller's
    Deadline escalates, the worker is killed and the failure classifies
    CRASH."""
    from spark_rapids_jni_tpu_torch.faultinj import watchdog
    with pconfig.override("watchdog.poll_period_s", 0.02):
        with pytest.raises(psandbox.WorkerCrashError) as ei:
            with watchdog.Deadline(0.3, "sandbox-hang"):
                psandbox.sandbox_call(
                    "probe_hang", psandbox.file_target("sleep_target"), 30.0)
    assert "hung worker" in str(ei.value)
    assert pguard.classify(ei.value) == pguard.CRASH
    assert not psandbox.get_worker().alive()
    assert psandbox.sandbox_call(
        "probe", psandbox.file_target("probe_target"), 7) == 7  # respawned


def test_chip_smoke_file_b_is_the_string_table():
    """chip_smoke.py's phase 10 writes file B from numpy arrays it draws
    itself: they are phase 7's string table, the generator's draws."""
    import chip_smoke
    from spark_rapids_jni_tpu_torch.utils import datagen
    n = 20_000
    fixed, keys, gid = chip_smoke.strings_arrays(n)
    table = datagen.string_rows_table(n, 0, device="cpu")
    for col, arr in zip(table.columns[:4], fixed.values()):
        np.testing.assert_array_equal(col.to_numpy(), arr)
    assert table[4].to_pylist() == [keys[g].decode() for g in gid]
