"""Port parity: calendar rebasing (ops/datetime_rebase.py) and time zone
conversion (ops/timezones.py) of spark_rapids_jni_tpu_torch against the
JAX package's, bit-exact, on the golden vectors of
tests/test_datetime_rebase.py and tests/test_timezones.py and on seeded
values over years 0001-2100."""

import datetime

import numpy as np
import pytest

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import datetime_rebase as JR
from spark_rapids_jni_tpu.ops import timezones as JT
from spark_rapids_jni_tpu_torch.ops import datetime_rebase as R
from spark_rapids_jni_tpu_torch.ops import timezones as T

from tests.test_datetime_rebase import (GREG_DAYS, GREG_MICROS,
                                        JULIAN_DAYS, JULIAN_MICROS)
from tests.test_timezones import (OFFSETS, TS_LOCAL, TS_UTC, TZ_INSTANTS,
                                  UTC_INSTANTS)
from torch_parity import assert_col_equal, to_port

N = 1000  # one row count for the seeded draws
DAY_LO = (datetime.date(1, 1, 1) - datetime.date(1970, 1, 1)).days
DAY_HI = (datetime.date(2100, 12, 31) - datetime.date(1970, 1, 1)).days
US_PER_DAY = 86_400_000_000


def _seeded(seed, unit):
    """Days or microseconds spread over 0001-01-01 .. 2100-12-31, with the
    cutover's edges, extreme values and 5% nulls."""
    r = np.random.default_rng(seed)
    if unit is jdt.TIMESTAMP_DAYS:
        v = r.integers(DAY_LO, DAY_HI + 1, N).astype(np.int32)
        v[:len(GREG_DAYS)] = GREG_DAYS
        v[-2:] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    else:
        v = r.integers(DAY_LO * US_PER_DAY, DAY_HI * US_PER_DAY, N)
        v[:len(GREG_MICROS)] = GREG_MICROS
        v[-3:] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1]
    return JColumn.from_numpy(v, unit, validity=r.random(N) >= 0.05)


@pytest.mark.parametrize("unit", ["days", "micros"])
def test_rebase_both_ways_matches(unit):
    jdtype = jdt.TIMESTAMP_DAYS if unit == "days" else \
        jdt.TIMESTAMP_MICROSECONDS
    golden = ((GREG_DAYS, JULIAN_DAYS) if unit == "days"
              else (GREG_MICROS, JULIAN_MICROS))
    jg = JColumn.from_pylist(golden[0], jdtype)
    assert R.rebase_gregorian_to_julian(to_port(jg)).to_pylist() == \
        golden[1]
    for jc in (jg, JColumn.from_pylist(golden[1], jdtype),
               _seeded(5 if unit == "days" else 6, jdtype)):
        for jfn, pfn in ((JR.rebase_gregorian_to_julian,
                          R.rebase_gregorian_to_julian),
                         (JR.rebase_julian_to_gregorian,
                          R.rebase_julian_to_gregorian)):
            assert_col_equal(jfn(jc), pfn(to_port(jc)))
    with pytest.raises(TypeError):
        R.rebase_gregorian_to_julian(to_port(JColumn.from_pylist(
            [1], jdt.INT64)))


@pytest.fixture(scope="module")
def tables():
    zones = [[(T.INT64_MIN, T.INT64_MIN, 18000)],
             list(zip(UTC_INSTANTS, TZ_INSTANTS, OFFSETS))]
    ids = ["Fixed5", "TestZone"]
    return (JT.make_transition_table(zones, ids),
            T.make_transition_table(zones, ids))


UNITS = [jdt.TIMESTAMP_SECONDS, jdt.TIMESTAMP_MILLISECONDS,
         jdt.TIMESTAMP_MICROSECONDS]


@pytest.mark.parametrize("unit", UNITS, ids=["s", "ms", "us"])
def test_convert_both_ways_matches(tables, unit):
    """The reference's two-zone table (zone 1 after Asia/Shanghai's
    history): its golden instants, and seeded values at sub-second
    precision around every transition."""
    jtab, ptab = tables
    factor = {"timestamp_s": 1, "timestamp_ms": 1000,
              "timestamp_us": 1000000}[unit.id.value]
    r = np.random.default_rng(7)
    near = np.array(UTC_INSTANTS[1:] + TZ_INSTANTS[1:], np.int64)
    secs = np.concatenate([TS_LOCAL, TS_UTC, near - 1, near, near + 1,
                           r.integers(-2**34, 2**34, N)])
    vals = secs * factor + r.integers(-factor + 1, factor, secs.size)
    vals[-1] = np.iinfo(np.int64).min
    jc = JColumn.from_numpy(vals, unit, validity=r.random(vals.size) > .05)
    for zone in (0, 1):
        assert_col_equal(JT.convert_timestamp_to_utc(jc, jtab, zone),
                         T.convert_timestamp_to_utc(to_port(jc), ptab, zone))
        assert_col_equal(
            JT.convert_utc_timestamp_to_timezone(jc, jtab, zone),
            T.convert_utc_timestamp_to_timezone(to_port(jc), ptab, zone))
    golden = JColumn.from_pylist([v * factor for v in TS_LOCAL], unit)
    assert T.convert_timestamp_to_utc(to_port(golden), ptab, 1) \
        .to_pylist() == [v * factor for v in TS_UTC]


def test_system_zones_load_as_jax():
    """Histories from the system database (Asia/Kolkata's +5:53:20 era,
    Asia/Kathmandu's overlap), the DST and sentinel refusals."""
    ids = ["UTC", "Asia/Kolkata", "Asia/Kathmandu", "Asia/Shanghai"]
    jtab, ptab = JT.load_zones(ids), T.load_zones(ids)
    for f in ("zone_offsets", "utc_instants", "tz_instants", "utc_offsets"):
        np.testing.assert_array_equal(np.asarray(getattr(jtab, f)),
                                      getattr(ptab, f))
    assert ptab.zone_ids == jtab.zone_ids
    jc = JColumn.from_numpy(np.arange(-2**33, 2**33, 2**24, dtype=np.int64),
                            jdt.TIMESTAMP_SECONDS)
    for z in range(len(ids)):
        assert_col_equal(JT.convert_timestamp_to_utc(jc, jtab, z),
                         T.convert_timestamp_to_utc(to_port(jc), ptab, z))
    with pytest.raises(ValueError, match="recurring"):
        T.load_fixed_offset_zones(["America/New_York"])
    with pytest.raises(ValueError, match="sentinel"):
        T.make_transition_table([[(0, 0, 3600)]])


class TestTimeZoneDBCache:
    """The cache protocol of tests/test_timezones.py (GpuTimeZoneDB)."""

    def setup_method(self):
        T.TimeZoneDB._reset_for_tests()

    teardown_method = setup_method

    def test_blocking_async_and_concurrent_loads(self):
        import threading
        import time
        zones = ["Asia/Kolkata"]
        T.TimeZoneDB.cache_async(zones)
        deadline = time.monotonic() + 10
        while not T.TimeZoneDB.is_loaded(zones):
            assert time.monotonic() < deadline, "async load never finished"
            time.sleep(0.005)
        assert T.TimeZoneDB.table_for(zones) is T.TimeZoneDB.table_for(zones)
        T.TimeZoneDB._reset_for_tests()
        errs = []

        def worker():
            try:
                T.TimeZoneDB.cache(zones)
            except BaseException as e:  # noqa: BLE001 - the record
                errs.append(e)

        threads = [threading.Thread(target=worker) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errs and not any(t.is_alive() for t in threads)
        col = to_port(JColumn.from_pylist([1_600_000_000],
                                          jdt.TIMESTAMP_SECONDS))
        out = T.convert_utc_timestamp_to_timezone(
            col, T.TimeZoneDB.table_for(zones), 0)
        assert out.to_pylist() == [1_600_000_000 + 19800]

    def test_shutdown_disables_cache(self):
        T.TimeZoneDB.cache(["Asia/Kolkata"])
        T.TimeZoneDB.shutdown()
        assert not T.TimeZoneDB.is_loaded(["Asia/Kolkata"])
        with pytest.raises(RuntimeError, match="shut down"):
            T.TimeZoneDB.cache(["Asia/Kolkata"])
        T.TimeZoneDB.cache_async(["Asia/Kolkata"])
        assert not T.TimeZoneDB.is_loaded(["Asia/Kolkata"])
