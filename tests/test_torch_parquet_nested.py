"""Port parity: nested Parquet columns (``spark_rapids_jni_tpu_torch``'s
parquet/nested.py, parquet/reader.py's simple/nested split and
parquet/device_decode.py's one-level LIST) against the JAX package's
reader, and the writer's nested output (utils/datagen_parquet.py) against
pyarrow.

The pyarrow-written tables are tests/test_parquet_decode.py's: STRUCT,
LIST<LIST>, LIST<STRUCT>, STRUCT<LIST> and MAP with nulls at every level,
over several row groups, v1 and v2 pages, projected and read in chunks.
The port's host tier is held to the JAX package's host tier bit for bit;
its device tier, which takes the one-level LISTs, to the same values and
offsets. The nested reads also run through the crash-containment sandbox,
whose workers return the level streams.
"""

import datetime
import os

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from spark_rapids_jni_tpu.parquet import reader as jreader  # noqa: E402
from spark_rapids_jni_tpu.utils import config as jconfig  # noqa: E402
from spark_rapids_jni_tpu_torch.faultinj import sandbox as psandbox  # noqa: E402
from spark_rapids_jni_tpu_torch.parquet import reader as preader  # noqa: E402
from spark_rapids_jni_tpu_torch.utils import config as pconfig  # noqa: E402
from spark_rapids_jni_tpu_torch.utils import datagen_parquet as W  # noqa: E402
from test_parquet_decode import _nested_table, _norm  # noqa: E402
from torch_parity import assert_col_equal, col_offsets  # noqa: E402

TIERS = {"host": "native", "device": "device"}


def _jax_host(path, **kw):
    with jconfig.override("parquet.device_decode", "native"):
        return jreader.read_parquet(path, **kw)


def _port(path, tier, **kw):
    with pconfig.override("parquet.device_decode", TIERS[tier]):
        return preader.read_parquet(path, device="cpu", **kw)


def _same_values(a, b, where):
    """Same rows, validity bits and LIST offsets down the tree (the tiers
    differ on whether an all-valid mask is present)."""
    assert a.to_pylist() == b.to_pylist(), where
    assert a.valid_mask().tolist() == b.valid_mask().tolist(), where
    if a.dtype.id.value == "list":
        assert np.array_equal(col_offsets(a), col_offsets(b)), where
    for i, (x, y) in enumerate(zip(a.children, b.children)):
        if x.dtype.is_nested:
            _same_values(x, y, f"{where} child {i}")


@pytest.fixture(scope="module")
def nested_file(tmp_path_factory):
    t = _nested_table(300, seed=7)
    path = str(tmp_path_factory.mktemp("nested") / "nested.parquet")
    pq.write_table(t, path, row_group_size=100)
    return t, path


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_nested_tables_match_pyarrow_and_jax(nested_file, tier):
    t, path = nested_file
    want = _jax_host(path)
    got = _port(path, tier)
    assert got.num_columns == 6
    for i, name in enumerate(t.column_names):
        assert got[i].to_pylist() == [_norm(v) for v in
                                      t.column(name).to_pylist()], name
        if tier == "host":
            assert_col_equal(want[i], got[i], name)
        else:
            _same_values(want[i], got[i], name)


def test_nested_projection_and_chunks(nested_file):
    t, path = nested_file
    got = _port(path, "host", columns=["ll", "flat"])
    assert got.num_columns == 2
    assert_col_equal(_jax_host(path, columns=["ll"])[0], got[0])
    with preader.ParquetReader(path, columns=["s", "ls"],
                               device="cpu") as r:
        chunks = list(r.iter_chunks(byte_budget=1))  # a row group each
    assert [c.num_rows for c in chunks] == [100, 100, 100]
    from spark_rapids_jni_tpu_torch.columnar.table_ops import concat_tables
    whole = concat_tables(chunks)
    for i, name in enumerate(["s", "ls"]):
        assert whole[i].to_pylist() == [_norm(v) for v in
                                        t.column(name).to_pylist()]


def test_one_level_lists_on_both_tiers(tmp_path):
    """LIST<INT64> and LIST<STRING> with null rows, empty rows and null
    elements: dictionary pages (snappy) and PLAIN pages; the device tier
    takes LIST<INT64> always and LIST<STRING> where it is
    dictionary-encoded."""
    rng = np.random.default_rng(3)
    ints, strs = [], []
    for i in range(500):
        r = rng.random()
        if r < 0.1:
            ints.append(None)
            strs.append(None)
        elif r < 0.25:
            ints.append([])
            strs.append([])
        else:
            k = int(rng.integers(1, 6))
            ints.append([None if rng.random() < 0.2 else
                         int(rng.integers(-10 ** 9, 10 ** 9))
                         for _ in range(k)])
            strs.append([None if rng.random() < 0.2 else f"w{i}-{j}"
                         for j in range(k)])
    t = pa.table({"li": pa.array(ints, type=pa.list_(pa.int64())),
                  "ls": pa.array(strs, type=pa.list_(pa.string()))})
    for kw in ({"compression": "snappy"},
               {"compression": "none", "use_dictionary": False}):
        path = str(tmp_path / f"lists_{kw['compression']}.parquet")
        pq.write_table(t, path, row_group_size=128, **kw)
        want = _jax_host(path)
        with pconfig.override("parquet.device_decode", "device"):
            r = preader.ParquetReader(path, device="cpu")
            got = r.read_all()
        assert r.routes["li"]["tier"] == "device"
        host = _port(path, "host")
        for i in range(2):
            assert_col_equal(want[i], host[i], f"host {i}")
            _same_values(want[i], got[i], f"device {i}")


def test_nested_data_page_v2_matches(tmp_path):
    t = _nested_table(120, seed=13)
    path = str(tmp_path / "nested_v2.parquet")
    pq.write_table(t, path, data_page_version="2.0")
    want = _jax_host(path)
    got = _port(path, "host")
    for i in range(t.num_columns):
        assert_col_equal(want[i], got[i], t.column_names[i])


def test_nested_read_through_the_sandbox(nested_file):
    """The sandbox worker's decode hands the level streams back: the
    nested columns equal the in-process read."""
    _, path = nested_file
    want = _port(path, "host", columns=["ls", "sl"])
    try:
        with pconfig.override("sandbox.enabled", True):
            got = _port(path, "host", columns=["ls", "sl"])
            assert psandbox.get_worker().pid() is not None
    finally:
        psandbox.shutdown_all()
    for a, b in zip(want, got):
        assert_col_equal(a, b)


def _orders(n, seed):
    """A small draw of chip_smoke's phase-14 orders table: a STRUCT key, a
    LIST<INT64> and a LIST<STRUCT> with nulls at the row, element and
    struct levels."""
    rng = np.random.default_rng(seed)
    lens = rng.poisson(4, n)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    m = int(offs[-1])
    d = dict(
        keys=rng.integers(0, 10 ** 9, m), q=rng.integers(1, 51, m)
        .astype(np.int32), qv=rng.random(m) > 0.01,
        price=rng.integers(0, 10 ** 7, m), ship=rng.integers(8000, 11000, m)
        .astype(np.int32), lv=rng.random(n) > 0.01, kv=rng.random(n) > 0.01,
        cust=rng.integers(0, 10 ** 6, n), od=rng.integers(8000, 11000, n)
        .astype(np.int32), offs=offs)
    cols = [
        W.ParquetColumn("o_orderkey", values=np.arange(n, dtype=np.int64)),
        W.StructField("o_key", [
            W.ParquetColumn("o_custkey", values=d["cust"]),
            W.ParquetColumn("o_orderdate", values=d["od"],
                            converted=W.DATE)], valid=d["kv"]),
        W.ListField("o_linekeys", offs,
                    W.ParquetColumn("l_orderkey", values=d["keys"])),
        W.ListField("o_lines", offs, W.StructField("line", [
            W.ParquetColumn("l_quantity", values=d["q"], valid=d["qv"]),
            W.ParquetColumn("l_extendedprice", values=d["price"]),
            W.ParquetColumn("l_shipdate", values=d["ship"],
                            converted=W.DATE)]), valid=d["lv"]),
    ]
    return cols, d


def _days(v):
    if isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    if isinstance(v, dict):
        return tuple(_days(x) for x in v.values())
    if isinstance(v, list):
        return [_days(x) for x in v]
    return v


def test_writer_nested_output_read_by_pyarrow_and_both_readers(tmp_path):
    """The writer's STRUCT, LIST and LIST<STRUCT> layouts (repetition and
    definition levels in the hybrid, pages cut where rows end) read back
    by pyarrow as the draws, and by both packages' readers alike."""
    n = 3000
    cols, d = _orders(n, 5)
    path = str(tmp_path / "orders.parquet")
    info = W.write_parquet(path, cols, page_rows=1000, row_group_rows=1100)
    assert info["row_groups"] == [1100, 1100, 800]
    t = pq.read_table(path)
    offs = d["offs"]
    assert t.column("o_linekeys").to_pylist() == [
        d["keys"][offs[i]:offs[i + 1]].tolist() for i in range(n)]
    assert [_days(v) for v in t.column("o_key").to_pylist()] == [
        (int(d["cust"][i]), int(d["od"][i])) if d["kv"][i] else None
        for i in range(n)]
    assert [_days(v) for v in t.column("o_lines").to_pylist()] == [
        [(int(d["q"][j]) if d["qv"][j] else None, int(d["price"][j]),
          int(d["ship"][j])) for j in range(offs[i], offs[i + 1])]
        if d["lv"][i] else None for i in range(n)]
    want = _jax_host(path)
    for tier in sorted(TIERS):
        got = _port(path, tier)
        for i in range(4):
            assert got[i].to_pylist() == want[i].to_pylist(), (tier, i)
    assert os.path.getsize(path) == info["bytes"]
