"""Julian <-> Proleptic Gregorian calendar rebasing (the JAX package's
ops/datetime_rebase.py): Spark's localRebaseGregorianToJulianDays /
rebaseJulianToGregorianMicros in UTC, as Parquet's LEGACY rebase mode
applies them to files written by Spark 2.x and Hive.

Whole-column int64 ops on the column's device: the civil-date conversions
(Howard Hinnant's algorithms) as elementwise integer math with floor
division, and the hybrid calendar's cutover as selects on the day
thresholds (1582-10-04, the Julian calendar's last day = Gregorian day
-141438; 1582-10-15, the Gregorian calendar's first = day -141427).
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..columnar.dtype import TypeId

GREGORIAN_START_DAYS = -141427          # 1582-10-15
JULIAN_END_DAYS = -141438               # 1582-10-04 (in Gregorian day count)
GREGORIAN_START_MICROS = -12219292800000000  # 1582-10-15T00:00:00Z
MICROS_PER_SECOND = 1_000_000
SECONDS_PER_DAY = 86_400


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


# ---- civil-date conversions (Hinnant's algorithms) -------------------------

def _civil_from_days_gregorian(days):
    z = days + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    return y + (m <= 2).to(torch.int64), m, d


def _days_from_civil_gregorian(y, m, d):
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    doy = _fdiv(153 * (m + torch.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _days_from_julian(y, m, d):
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(y, 4)
    yoe = y - era * 4
    doy = _fdiv(153 * (m + torch.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + doy
    return era * 1461 + doe - 719470


def _julian_from_days(days):
    z = days + 719470
    era = _fdiv(z, 1461)
    doe = z - era * 1461
    yoe = _fdiv(doe - _fdiv(doe, 1460), 365)
    y = yoe + era * 4
    doy = doe - 365 * yoe
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    return y + (m <= 2).to(torch.int64), m, d


# ---- day-level rebasing ----------------------------------------------------

def _greg_to_julian_days(days):
    days = days.to(torch.int64)
    rebased = _days_from_julian(*_civil_from_days_gregorian(days))
    out = torch.where(days >= GREGORIAN_START_DAYS, days,
                      torch.where(days > JULIAN_END_DAYS,
                                  GREGORIAN_START_DAYS, rebased))
    return out.to(torch.int32)


def _julian_to_greg_days(days):
    days = days.to(torch.int64)
    rebased = _days_from_civil_gregorian(*_julian_from_days(days))
    return torch.where(days >= GREGORIAN_START_DAYS, days,
                       rebased).to(torch.int32)


# ---- microsecond-level rebasing -------------------------------------------

def _split_micros(micros):
    """(days, second of the day, microseconds of the second), by floor
    division as the JAX package splits a negative instant."""
    days = _fdiv(micros, SECONDS_PER_DAY * MICROS_PER_SECOND)
    subsecond = torch.remainder(micros, MICROS_PER_SECOND)
    second_of_day = torch.remainder(_fdiv(micros, MICROS_PER_SECOND),
                                    SECONDS_PER_DAY)
    return days, second_of_day, subsecond


def _assemble_micros(days, second_of_day, subsecond):
    return (days * SECONDS_PER_DAY + second_of_day) * MICROS_PER_SECOND \
        + subsecond


def _greg_to_julian_micros(micros):
    days, sod, sub = _split_micros(micros)
    julian_days = torch.where(
        days > JULIAN_END_DAYS, GREGORIAN_START_DAYS,
        _days_from_julian(*_civil_from_days_gregorian(days)))
    rebased = _assemble_micros(julian_days, sod, sub)
    return torch.where(micros >= GREGORIAN_START_MICROS, micros, rebased)


def _julian_to_greg_micros(micros):
    days, sod, sub = _split_micros(micros)
    rebased = _assemble_micros(
        _days_from_civil_gregorian(*_julian_from_days(days)), sod, sub)
    return torch.where(micros >= GREGORIAN_START_MICROS, micros, rebased)


# ---- public API ------------------------------------------------------------

def _rebase(col: Column, day_fn, micros_fn) -> Column:
    if col.dtype.id is TypeId.TIMESTAMP_DAYS:
        return Column(col.dtype, col.size, data=day_fn(col.data),
                      validity=col.validity)
    if col.dtype.id is TypeId.TIMESTAMP_MICROSECONDS:
        return Column(col.dtype, col.size,
                      data=micros_fn(col.data.to(torch.int64)),
                      validity=col.validity)
    raise TypeError(
        "The input must be either day or microsecond timestamps to rebase.")


def rebase_gregorian_to_julian(col: Column) -> Column:
    """DateTimeRebase.java:38-47."""
    return _rebase(col, _greg_to_julian_days, _greg_to_julian_micros)


def rebase_julian_to_gregorian(col: Column) -> Column:
    """DateTimeRebase.java:49-58."""
    return _rebase(col, _julian_to_greg_days, _julian_to_greg_micros)
