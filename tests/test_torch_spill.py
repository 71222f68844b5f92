"""The port's spill store and integrity layer against the JAX package's:
one table gives one fingerprint in both packages; host and disk spill
round trips; a spill file written by either package reads back in the
other; an injected bit flip on promotion raises the same CorruptionError
(same seed, same flipped bit) and quarantines the table;
``rollback_all_stores`` releases every registered table.
"""

import json

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu.faultinj import guard as JGD
from spark_rapids_jni_tpu.faultinj import injector as JI
from spark_rapids_jni_tpu.memory import integrity as JIN
from spark_rapids_jni_tpu.memory import transport as JT
from spark_rapids_jni_tpu_torch.faultinj import guard as PGD
from spark_rapids_jni_tpu_torch.faultinj import injector as PI
from spark_rapids_jni_tpu_torch.memory import integrity as PIN
from spark_rapids_jni_tpu_torch.memory import transport as PT

from torch_parity import assert_col_equal, table_to_port


@pytest.fixture(autouse=True)
def _clean():
    JGD.metrics.reset()
    PGD.metrics.reset()
    yield
    JI.uninstall()
    PI.uninstall()
    JGD.metrics.reset()
    PGD.metrics.reset()


def _jax_table(n=257, seed=3):
    """Every stored type of the port, nulls, NaN payloads, -0.0 and a
    STRING column."""
    rng = np.random.default_rng(seed)
    f64 = rng.standard_normal(n)
    f64[:4] = [np.nan, -0.0, np.inf, 5e-324]
    f64.view(np.uint64)[4] = 0x7FF8_0000_DEAD_BEEF  # a NaN payload
    cols = [
        JColumn.from_numpy(rng.integers(-128, 127, n).astype(np.int8),
                           jdt.INT8),
        JColumn.from_numpy(rng.integers(0, 2, n).astype(np.uint8),
                           jdt.BOOL8, validity=rng.random(n) > 0.3),
        JColumn.from_numpy(rng.integers(0, 2**16, n).astype(np.uint16),
                           jdt.UINT16),
        JColumn.from_numpy(rng.integers(0, 2**32, n).astype(np.uint32),
                           jdt.UINT32, validity=rng.random(n) > 0.2),
        JColumn.from_numpy(rng.integers(0, 2**63, n).astype(np.uint64),
                           jdt.UINT64),
        JColumn.from_numpy(rng.integers(-2**62, 2**62, n), jdt.INT64),
        JColumn.from_numpy(rng.standard_normal(n).astype(np.float32),
                           jdt.FLOAT32),
        JColumn.from_numpy(f64, jdt.FLOAT64, validity=rng.random(n) > 0.1),
        JColumn.from_numpy(rng.integers(0, 9000, n).astype(np.int32),
                           jdt.TIMESTAMP_DAYS),
        JColumn.from_pylist(
            [None if i % 7 == 0 else "s" * (i % 13) + str(i)
             for i in range(n)], jdt.STRING),
    ]
    return JTable(tuple(cols))


def test_one_table_one_fingerprint_in_both_packages():
    jt = _jax_table()
    pt = table_to_port(jt)
    jfp = JIN.table_fingerprint(JT.to_host(jt))
    pfp = PIN.table_fingerprint(PT.to_host(pt))
    assert pfp == jfp
    PIN.verify_table(PT.to_host(pt), jfp, context="cross")


def _assert_tables(a, b):
    assert a.num_rows == b.num_rows and a.num_columns == b.num_columns
    for x, y in zip(a.columns, b.columns):
        assert x.dtype == y.dtype and x.size == y.size
        for s in ("data", "validity", "offsets"):
            u, v = getattr(x, s), getattr(y, s)
            assert (u is None) == (v is None), s
            if u is not None:
                assert u.dtype == v.dtype and torch.equal(
                    u.view(torch.uint8), v.view(torch.uint8)), s


def test_host_spill_round_trip():
    pt = table_to_port(_jax_table())
    store = PT.SpillStore()
    st = store.register(pt)
    nbytes = pt.device_nbytes()
    assert store.device_bytes() == nbytes
    assert st.spill() == nbytes and st.spill() == 0
    assert st.is_spilled and st.host_nbytes == nbytes
    assert store.device_bytes() == 0
    back = st.get()
    assert not st.is_spilled and back.device == pt.device
    _assert_tables(back, pt)


def test_disk_tier_round_trip_and_cross_package_files(tmp_path):
    jt = _jax_table()
    pt = table_to_port(jt)
    store = PT.SpillStore(disk_dir=str(tmp_path / "tier"),
                          host_limit_bytes=1)
    st = store.register(pt)
    st.spill()
    assert st.is_on_disk and store.state()["tiers"]["disk"] == 1
    _assert_tables(st.get(), pt)
    assert not list((tmp_path / "tier").iterdir())  # promoted: file gone
    # a spill file of either package reads back in the other
    pfile, jfile = str(tmp_path / "p.spill"), str(tmp_path / "j.spill")
    PIN.write_table_file(pfile, PT.to_host(pt))
    JIN.write_table_file(jfile, JT.to_host(jt))
    assert open(pfile, "rb").read() == open(jfile, "rb").read()
    _assert_tables(PIN.read_table_file(jfile), PT.to_host(pt))
    for a, b in zip(JIN.read_table_file(pfile).columns, pt.columns):
        assert_col_equal(a, b)


def test_injected_unspill_flip_raises_the_same_corruption(tmp_path):
    cfg = tmp_path / "flip.json"
    cfg.write_text(json.dumps({"xlaRuntimeFaults": {"unspill": {
        "percent": 100, "injectionType": 3, "interceptionCount": 1}}}))
    jt = _jax_table()
    msgs, counts = [], []
    for table, I, T, G in ((jt, JI, JT, JGD),
                           (table_to_port(jt), PI, PT, PGD)):
        st = T.SpillStore().register(table)
        st.spill()
        I.install(str(cfg), seed=42)
        with pytest.raises(Exception) as ei:
            st.get()
        I.uninstall()
        assert type(ei.value).__name__ == "CorruptionError"
        assert st.is_quarantined
        with pytest.raises(Exception, match="quarantined"):
            st.get()
        msgs.append(str(ei.value))
        m = G.metrics.snapshot()
        counts.append((m["corruption_detected"], m["quarantined_buffers"]))
    assert msgs[0] == msgs[1] and "fingerprint mismatch" in msgs[1]
    assert counts[0] == counts[1] == (1, 1)


def test_rollback_all_stores_spills_every_registered_table():
    pt = table_to_port(_jax_table(64))
    stores = [PT.SpillStore(), PT.SpillStore()]
    sts = [s.register(pt) for s in stores]
    freed = PT.rollback_all_stores()
    assert freed >= 2 * pt.device_nbytes()
    assert all(st.is_spilled for st in sts)
    assert PT.rollback_all_stores() == 0
    for st in sts:
        _assert_tables(st.get(), pt)
