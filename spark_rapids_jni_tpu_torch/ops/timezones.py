"""Time zone conversion via transition tables (the JAX package's
ops/timezones.py): Spark's ``convert_timestamp_to_utc`` and
``convert_utc_timestamp_to_timezone`` over a zone's transition history,
and the ``GpuTimeZoneDB`` cache that loads the histories.

A conversion is one ``torch.searchsorted`` (upper bound) of each row's
epoch seconds in the zone's transition instants, on the column's device,
then a gather of the offset in force. The transition table is host
metadata (a few hundred entries at most a zone); a conversion copies
its zone's slice to the column's device.

As in the JAX package, only zones without recurring (DST rule-based)
transitions load from the system tz database (``zoneinfo.TZPATH``);
arbitrary transition lists can be given to ``make_transition_table``.
"""

from __future__ import annotations

import threading as _threading
from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.dtype import TypeId

INT64_MIN = -(2**63)

_FACTOR = {
    TypeId.TIMESTAMP_SECONDS: 1,
    TypeId.TIMESTAMP_MILLISECONDS: 1_000,
    TypeId.TIMESTAMP_MICROSECONDS: 1_000_000,
}


@dataclass
class TransitionTable:
    """Dense form of the LIST<STRUCT<int64,int64,int32>> transitions column.

    Each zone's transition list starts with a sentinel entry whose
    instants are INT64_MIN (GpuTimeZoneDB builds it that way), so the
    upper_bound - 1 lookup is always in range.
    """

    zone_offsets: np.ndarray        # int64[num_zones + 1]
    utc_instants: np.ndarray        # int64[total] (seconds; from-UTC search)
    tz_instants: np.ndarray         # int64[total] (seconds; to-UTC search)
    utc_offsets: np.ndarray         # int32[total] (seconds to add from UTC)
    zone_ids: Dict[str, int] = field(default_factory=dict)

    @property
    def num_zones(self) -> int:
        return len(self.zone_offsets) - 1

    def index_of(self, zone_id: str) -> int:
        return self.zone_ids[zone_id]

    def zone_arrays(self, tz_index: int, to_utc: bool,
                    device: torch.device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """(instants int64, offsets int64) of one zone on ``device``: the
        tz instants for a to-UTC search, the UTC instants otherwise."""
        lo = int(self.zone_offsets[tz_index])
        hi = int(self.zone_offsets[tz_index + 1])
        inst = (self.tz_instants if to_utc else self.utc_instants)[lo:hi]
        return (torch.from_numpy(inst.copy()).to(device),
                torch.from_numpy(self.utc_offsets[lo:hi].astype(
                    np.int64)).to(device))


def make_transition_table(
        zones: Sequence[Sequence[Tuple[int, int, int]]],
        zone_ids: Sequence[str] = ()) -> TransitionTable:
    """Build from per-zone lists of (utc_instant_s, tz_instant_s, offset_s)."""
    offsets = np.zeros(len(zones) + 1, dtype=np.int64)
    utc, tz, off = [], [], []
    for i, z in enumerate(zones):
        if not z or z[0][0] != INT64_MIN:
            raise ValueError(
                "each zone needs a leading INT64_MIN sentinel transition")
        offsets[i + 1] = offsets[i] + len(z)
        for u, t, o in z:
            utc.append(u)
            tz.append(t)
            off.append(o)
    ids = {zid: i for i, zid in enumerate(zone_ids)}
    return TransitionTable(offsets, np.array(utc, dtype=np.int64),
                           np.array(tz, dtype=np.int64),
                           np.array(off, dtype=np.int32), ids)


def _parse_tzif(path: str):
    """Minimal TZif (RFC 8536) reader -> (transitions, footer_tz_string).

    transitions = [(utc_instant_s, offset_after_s), ...] plus the implied
    initial offset as a leading (None, offset) entry.
    """
    import struct as _struct

    with open(path, "rb") as f:
        data = f.read()

    def read_block(off, time_size, fmt):
        magic, version = data[off:off + 4], data[off + 4:off + 5]
        if magic != b"TZif":
            raise ValueError("not a TZif file")
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt,
         charcnt) = _struct.unpack(">6I", data[off + 20:off + 44])
        p = off + 44
        times = _struct.unpack(f">{timecnt}{fmt}",
                               data[p:p + timecnt * time_size])
        p += timecnt * time_size
        type_idx = data[p:p + timecnt]
        p += timecnt
        types = []
        for i in range(typecnt):
            utoff, isdst, _abbr = _struct.unpack(
                ">ibB", data[p + i * 6:p + i * 6 + 6])
            types.append((utoff, bool(isdst)))
        p += typecnt * 6 + charcnt + leapcnt * (time_size + 4) \
            + isstdcnt + isutcnt
        return version, times, type_idx, types, p

    version, times, idx, types, end = read_block(0, 4, "i")
    footer = ""
    if version >= b"2":
        # v2+: a second 64-bit block follows, then the POSIX-TZ footer
        _, times, idx, types, end = read_block(end, 8, "q")
        nl1 = data.index(b"\n", end)
        nl2 = data.index(b"\n", nl1 + 1)
        footer = data[nl1 + 1:nl2].decode()

    first_std = next((t[0] for t in types if not t[1]),
                     types[0][0] if types else 0)
    transitions = [(None, first_std)]
    for t, ti in zip(times, idx):
        transitions.append((t, types[ti][0]))
    return transitions, footer


def _zone_transitions(zone_id: str):
    """One zone's (utc_instant_s, tz_instant_s, offset_s) history from the
    system tz database, sentinel first; a zone with recurring rules
    raises, as GpuTimeZoneDB.java:236-240 does."""
    import os
    import zoneinfo

    path = next((os.path.join(root, zone_id) for root in zoneinfo.TZPATH
                 if os.path.exists(os.path.join(root, zone_id))), None)
    if path is None:
        raise KeyError(f"unknown zone id {zone_id}")
    transitions, footer = _parse_tzif(path)
    if "," in footer:
        raise ValueError(f"zone {zone_id} has recurring rules; unsupported "
                         "(matches GpuTimeZoneDB.java:236-240)")
    entries = [(INT64_MIN, INT64_MIN, transitions[0][1])]
    # For the to-UTC search instant, a gap transition compares against
    # instant + offset_after, but an overlap has two valid local ranges
    # and compares against instant + offset_before; the offset applied is
    # always offset_after (GpuTimeZoneDB.java:296-316).
    offset_before = transitions[0][1]
    for utc_instant, offset in transitions[1:]:
        is_gap = offset > offset_before
        local = utc_instant + (offset if is_gap else offset_before)
        entries.append((utc_instant, local, offset))
        offset_before = offset
    return entries


def load_zones(zone_ids: Sequence[str]) -> TransitionTable:
    """GpuTimeZoneDB equivalent: the full transition histories of zones
    without recurring (rule-based DST) transitions."""
    return make_transition_table([_zone_transitions(z) for z in zone_ids],
                                 zone_ids)


# kept for callers that only need the modern fixed offset
load_fixed_offset_zones = load_zones


class TimeZoneDB:
    """Lazy transition-table cache with async loading.

    Protocol of GpuTimeZoneDB.java:88-176: ``cache_async`` starts a daemon
    loader thread (a no-op if a load of the key is in flight or shutdown
    was ever called); ``cache`` blocks, waiting on an in-flight load
    instead of loading twice; ``shutdown`` waits for in-flight loads and
    disables the cache for good. ``table_for`` is the consumer entry: a
    cache hit, or a blocking load. Keyed by the sorted zone-id tuple.
    """

    _cond = _threading.Condition()
    _loading_keys: set = set()          # keys with a load in flight
    _shutdown = False
    _tables: Dict[Tuple[str, ...], TransitionTable] = {}

    @classmethod
    def _load_and_publish(cls, key: Tuple[str, ...], swallow: bool = False):
        try:
            table = load_zones(list(key))
            with cls._cond:
                cls._tables[key] = table
        except Exception:
            if not swallow:
                raise
            # the async loader logs and ends quietly (GpuTimeZoneDB :107)
            import logging
            logging.getLogger(__name__).exception(
                "timezone transition cache load failed for %s", key)
        finally:
            with cls._cond:
                cls._loading_keys.discard(key)
                cls._cond.notify_all()

    @classmethod
    def cache_async(cls, zone_ids: Sequence[str]) -> None:
        """GpuTimeZoneDB.cacheDatabaseAsync:88-122, with the in-flight
        guard per key."""
        key = tuple(sorted(zone_ids))
        with cls._cond:
            if cls._shutdown or key in cls._loading_keys \
                    or key in cls._tables:
                return
            cls._loading_keys.add(key)
        t = _threading.Thread(target=cls._load_and_publish, args=(key, True),
                              name="timezone-database-0", daemon=True)
        t.start()

    @classmethod
    def cache(cls, zone_ids: Sequence[str]) -> None:
        """GpuTimeZoneDB.cacheDatabase:124-156: blocking; joins an
        in-flight load of the same key rather than loading twice."""
        key = tuple(sorted(zone_ids))
        with cls._cond:
            while key in cls._loading_keys:
                cls._cond.wait()
            if cls._shutdown:
                raise RuntimeError("TimeZoneDB was shut down")
            if key in cls._tables:
                return
            cls._loading_keys.add(key)
        cls._load_and_publish(key)

    @classmethod
    def table_for(cls, zone_ids: Sequence[str]) -> TransitionTable:
        """Consumer entry: the cached table or a blocking load."""
        key = tuple(sorted(zone_ids))
        with cls._cond:
            t = cls._tables.get(key)
        if t is not None:
            return t
        cls.cache(zone_ids)
        with cls._cond:
            t = cls._tables.get(key)
            if t is None:
                # a concurrent shutdown() cleared the cache between the
                # load and this read
                raise RuntimeError("TimeZoneDB was shut down")
            return t

    @classmethod
    def is_loaded(cls, zone_ids: Sequence[str]) -> bool:
        with cls._cond:
            return tuple(sorted(zone_ids)) in cls._tables

    @classmethod
    def shutdown(cls) -> None:
        """GpuTimeZoneDB.shutdown:158-176: wait for in-flight loads, then
        disable and drop the cache for good."""
        with cls._cond:
            cls._shutdown = True
            while cls._loading_keys:
                cls._cond.wait()
            cls._tables.clear()
            cls._cond.notify_all()

    @classmethod
    def _reset_for_tests(cls) -> None:
        with cls._cond:
            cls._shutdown = False
            cls._loading_keys.clear()
            cls._tables.clear()


def _convert(col: Column, table: TransitionTable, tz_index: int,
             to_utc: bool) -> Column:
    tid = col.dtype.id
    if tid not in _FACTOR:
        raise TypeError("Unsupported timestamp unit for timezone conversion")
    factor = _FACTOR[tid]
    ts = col.data.to(torch.int64)
    # duration_cast to seconds truncates toward zero (the JAX package's
    # form, which INT64_MIN also follows)
    epoch_seconds = torch.where(
        ts >= 0, torch.div(ts, factor, rounding_mode="floor"),
        -torch.div(-ts, factor, rounding_mode="floor"))
    instants, offsets = table.zone_arrays(tz_index, to_utc, ts.device)
    idx = torch.searchsorted(instants, epoch_seconds, right=True)
    off = offsets.index_select(0, idx - 1) * factor
    out = ts - off if to_utc else ts + off
    return Column(col.dtype, col.size, data=out, validity=col.validity)


def convert_timestamp_to_utc(col: Column, table: TransitionTable,
                             tz_index: int) -> Column:
    """Local timestamps of zone ``tz_index`` -> UTC (timezones.cu:148)."""
    return _convert(col, table, tz_index, to_utc=True)


def convert_utc_timestamp_to_timezone(col: Column, table: TransitionTable,
                                      tz_index: int) -> Column:
    """UTC timestamps -> local timestamps of zone ``tz_index``
    (timezones.cu:157)."""
    return _convert(col, table, tz_index, to_utc=False)
