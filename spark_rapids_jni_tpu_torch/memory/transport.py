"""Host<->device transport + spillable buffer store (the JAX package's
memory/transport.py).

Capability parity with two reference-side layers:

  * the explicit transfer layer (SURVEY §2.3.4: HostColumnVector <->
    device copies around every JNI kernel) — here ``to_device`` /
    ``to_host`` with tracing spans, one transfer per buffer, each under
    the fault-domain guard ("h2d", "d2h");
  * the spillable-buffer model the reference plugin builds on RMM
    (SpillableColumnarBatch / RapidsBufferCatalog): device data that can
    be demoted to host memory under pressure and promoted back on access,
    wired to the retry protocol — a rollback spills registered tables,
    which is precisely what "roll back to a spillable state" (TpuRetryOOM
    contract) means.

Host-resident tables are Columns of CPU tensors; device->host is exact
for every dtype (a copy of the bits). A spilled table remembers its
device, and promotion re-uploads to it. Spilling frees the device memory
only when the store holds the last reference to the device table: a
caller that keeps its own reference keeps the memory.

Integrity: spilled tables are crc32-fingerprinted at demotion and
re-verified at promote (``spill.verify_fingerprints``); a mismatch
quarantines the buffer and raises ``CorruptionError`` so the owner
re-materializes from upstream instead of returning poisoned rows. Past
``spill.host_limit_bytes`` the store demotes least-recently-used host
tables to a checksummed disk tier (``spill.disk_dir``): files are written
atomically (tmp + fsync + rename), verified buffer-by-buffer on promote,
and torn/orphaned files are cleaned at store construction.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..columnar.column import Column, Table
from ..faultinj import watchdog
from ..utils.tracing import trace_range
from .integrity import (
    CorruptionError,
    clean_spill_dir,
    maybe_flip_table,
    read_table_file,
    table_fingerprint,
    verify_table,
    write_table_file,
)


def _guarded(api: str, fn):
    """Per-transfer fault-domain guard (faultinj/guard.py): a JSON fault
    config naming "h2d"/"d2h"/"spill"/"unspill" fires on the transfer it
    names; real link failures classify into the same recovery domains."""
    from ..faultinj.guard import guarded_dispatch
    return guarded_dispatch(api, fn)


def _move(c: Column, children, device) -> Column:
    def mv(t):
        return None if t is None else t.to(device)
    return Column(c.dtype, c.size, data=mv(c.data), validity=mv(c.validity),
                  offsets=mv(c.offsets), children=children)


def to_device(obj, device="cuda"):
    """Host Column/Table -> ``device`` (one transfer per buffer).

    Columns built by ``Column.from_numpy``/``from_pylist`` are already on
    their device; this is the explicit entry for buffers that were spilled
    or arrived from IO.
    """
    device = torch.device(device)
    if isinstance(obj, Table):
        cols = []
        for c in obj.columns:
            # per-column chunk boundary: a cancelled/expired deadline
            # stops a multi-column upload between columns, not mid-copy
            watchdog.checkpoint()
            cols.append(to_device(c, device))
        return Table(tuple(cols))
    c: Column = obj
    # children upload (and guard) individually, BEFORE this column's own
    # guarded transfer — a retry re-runs one column's upload, not a subtree
    children = tuple(to_device(ch, device) for ch in c.children)

    def _upload():
        with trace_range("h2d"):
            return _move(c, children, device)
    return _guarded("h2d", _upload)


def to_host(obj):
    """Device Column/Table -> host tensors (exact bytes, one D2H per
    buffer). The result is still a Column/Table on the CPU; use this only
    at spill/IO boundaries."""
    if isinstance(obj, Table):
        cols = []
        for c in obj.columns:
            watchdog.checkpoint()  # chunk boundary, same as to_device
            cols.append(to_host(c))
        return Table(tuple(cols))
    c: Column = obj
    children = tuple(to_host(ch) for ch in c.children)

    def _download():
        with trace_range("d2h"):
            return _move(c, children, "cpu")
    return _guarded("d2h", _download)


def _verify_enabled() -> bool:
    from ..utils import config
    return bool(config.get("spill.verify_fingerprints"))


class SpillableTable:
    """A Table that can be demoted to host memory (and on to disk) and
    promoted back.

    States: DEVICE (get() is free) ⇄ HOST (get() re-uploads) ⇄ DISK
    (get() reads + verifies the checksummed spill file first), plus the
    terminal QUARANTINED state a failed integrity check leaves behind —
    its bytes are gone on purpose; the owner must rebuild from source.
    Thread-safe; spill() is idempotent.

    Integrity: at spill time the host table is crc32-fingerprinted
    (memory/integrity.py); ``get()`` re-verifies before re-upload. A
    mismatch — real bit rot or an ``injectionType: 3`` chaos flip on the
    "spill"/"unspill" surfaces — quarantines this table, bumps the
    ``corruption_detected``/``quarantined_buffers`` counters, and raises
    :class:`CorruptionError`.
    """

    DEVICE, HOST, DISK, QUARANTINED = "device", "host", "disk", "quarantined"

    def __init__(self, table: Table):
        self._lock = threading.Lock()
        # state-transition fence: transfers (d2h/h2d/disk IO) run OUTSIDE
        # the lock so a stalled or fault-injected transfer can never wedge
        # readers of the state properties (srjt-race SRJTR02); _busy marks
        # a transition in flight and _cond wakes its waiters
        self._cond = threading.Condition(self._lock)
        self._busy = False
        self._table: Optional[Table] = table
        self._device = table.device if table.columns else None
        self._state = self.DEVICE
        self._fingerprint = None
        self._disk_path: Optional[str] = None
        self._on_promote = None  # set by SpillStore.register (LRU touch)
        self._on_spill = None    # set by SpillStore.register (host limit)
        # an event on the stream that wrote the device copy (set at
        # SpillStore.register and at promote): a spill from another
        # thread, whose current stream is another task's, waits on it
        # before its copy (parallel/task_executor.py)
        self._written: Optional[torch.cuda.Event] = None

    def _mark_written(self) -> None:
        """Record ``_written`` on the current stream of the table's
        device (nothing on the CPU)."""
        if self._device is not None and self._device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self._device))
            self._written = ev

    def _await_settled_locked(self) -> None:
        """Wait (bounded, cancellable) for an in-flight transition to
        finish. Caller holds ``self._lock``."""
        while self._busy:
            watchdog.checkpoint()  # honor deadline/cancel while waiting
            self._cond.wait(0.05)

    def _settle(self) -> None:
        """Clear the busy flag and wake waiters (transition epilogue)."""
        with self._lock:
            self._busy = False
            self._cond.notify_all()

    @property
    def device_nbytes(self) -> int:
        """Bytes currently occupying device memory (0 when spilled)."""
        with self._lock:
            return (self._table.device_nbytes()
                    if self._state == self.DEVICE else 0)

    @property
    def host_nbytes(self) -> int:
        """Bytes currently occupying host RAM (0 unless host-resident;
        ``device_nbytes`` counts a table's tensor bytes wherever they
        are)."""
        with self._lock:
            return (self._table.device_nbytes()
                    if self._state == self.HOST else 0)

    @property
    def is_spilled(self) -> bool:
        with self._lock:
            return self._state != self.DEVICE

    @property
    def is_on_disk(self) -> bool:
        with self._lock:
            return self._state == self.DISK

    @property
    def is_quarantined(self) -> bool:
        with self._lock:
            return self._state == self.QUARANTINED

    def _quarantine(self) -> None:
        """Discard this table's bytes after a failed integrity check (the
        corrupted copy must never be promotable) and count it. Caller
        holds no locks; the CorruptionError that got us here propagates."""
        from ..faultinj.guard import metrics
        with self._lock:
            if self._state == self.QUARANTINED:
                return  # idempotent: count each table's quarantine once
            self._table = None
            self._fingerprint = None
            path, self._disk_path = self._disk_path, None
            self._state = self.QUARANTINED
        if path is not None:
            try:
                os.unlink(path)
            except OSError:
                pass
        metrics.bump("quarantined_buffers")

    def spill(self) -> int:
        """Demote to host; returns device bytes released (0 if not device-
        resident). Fingerprints the host bytes for promote-time verify."""
        with self._lock:
            self._await_settled_locked()
            if self._state != self.DEVICE:
                return 0
            freed = self._table.device_nbytes()
            table = self._table
            written = self._written
            self._busy = True
        try:
            if written is not None:
                torch.cuda.current_stream(self._device).wait_event(written)
            with trace_range("spill"):
                host = _guarded("spill", lambda: to_host(table))
                fp = table_fingerprint(host) if _verify_enabled() else None
                # chaos surface "spill": a flip landing after the
                # fingerprint models bit rot while the table sits in host
                # RAM — caught by the verify in get()
                host, _ = maybe_flip_table("spill", host)
        except BaseException:
            self._settle()
            raise
        with self._lock:
            self._table = host
            self._fingerprint = fp
            self._state = self.HOST
            self._busy = False
            self._cond.notify_all()
        if self._on_spill is not None:
            self._on_spill(self)  # outside the lock: store takes its own
        return freed

    def spill_to_disk(self, path: str) -> int:
        """Demote a host-resident table to a checksummed disk file
        (atomic tmp + fsync + rename); returns host bytes released.
        Device-resident tables spill to host first."""
        self.spill()
        with self._lock:
            self._await_settled_locked()
            if self._state != self.HOST:
                return 0
            freed = self._table.device_nbytes()
            table = self._table
            self._busy = True
        try:
            with trace_range("spill_disk"):
                _guarded("spill_disk", lambda: write_table_file(path, table))
        except BaseException:
            self._settle()
            raise
        with self._lock:
            self._disk_path = path
            self._table = None
            self._state = self.DISK
            self._busy = False
            self._cond.notify_all()
        return freed

    def _promote(self) -> Table:
        """DISK/HOST → DEVICE. Entered owning the busy flag (lock NOT
        held); transfers run unlocked, each state step commits under the
        lock, and the flag is always cleared. Raises CorruptionError
        (after the guard counted the detection) on any integrity failure;
        the caller quarantines."""
        try:
            with self._lock:
                state = self._state
                path = self._disk_path
                fp = self._fingerprint
                table = self._table
            if state == self.DISK:
                with trace_range("unspill_disk"):
                    # the disk surface's chaos flip ("disk_promote") lands
                    # on the raw payload inside read_table_file, before
                    # the per-buffer crc verify
                    table = _guarded(
                        "unspill_disk",
                        lambda: read_table_file(path,
                                                inject_api="disk_promote"))
                with self._lock:
                    self._table = table
                    self._disk_path = None
                    self._state = self.HOST
                try:
                    os.unlink(path)
                except OSError:
                    pass
                state = self.HOST
            if state == self.HOST:
                def _verified_upload():
                    t, _ = maybe_flip_table("unspill", table)
                    if fp is not None:
                        verify_table(t, fp, context="unspill")
                    return to_device(t, self._device)

                with trace_range("unspill"):
                    dev = _guarded("unspill", _verified_upload)
                with self._lock:
                    self._table = dev
                    self._fingerprint = None
                    self._state = self.DEVICE
                    self._mark_written()
            with self._lock:
                return self._table
        finally:
            self._settle()

    def get(self) -> Table:
        """The device-resident table, promoting (re-uploading) if spilled.

        Raises :class:`CorruptionError` when promote-time verification
        fails (the table is then quarantined) or when this table was
        already quarantined by an earlier failure."""
        try:
            with self._lock:
                self._await_settled_locked()
                if self._state == self.QUARANTINED:
                    raise CorruptionError(
                        "spillable table is quarantined (a previous "
                        "integrity check failed); rebuild from source")
                if self._state == self.DEVICE:
                    table = self._table
                else:
                    self._busy = True
                    table = None
            if table is None:
                table = self._promote()
        except CorruptionError:
            self._quarantine()
            raise
        if self._on_promote is not None:
            self._on_promote(self)  # outside the lock: store takes its own
        return table


class SpillStore:
    """Registry of spillable tables with a spill-to-fit policy and an
    optional checksummed disk tier.

    The reference's RapidsBufferCatalog equivalent at reservation
    granularity: when the retry protocol demands rollback, the task's
    store spills least-recently-promoted buffers first (every ``get()``
    refreshes a table's recency) until the requested bytes are released.
    ``rollback_cb`` plugs directly into
    ``memory.retry.with_retry(rollback=...)``.

    Disk tier (the plugin's host→disk spill store analog): when
    ``disk_dir`` is set (default: config ``spill.disk_dir``) and the bytes
    held by host-resident spilled tables exceed ``host_limit_bytes``
    (config ``spill.host_limit_bytes``; 0 = unlimited), the store demotes
    least-recently-used host tables to atomically-written, per-buffer
    crc32-checksummed spill files. Construction sweeps the directory for
    orphaned spill files and torn ``.tmp`` leftovers from a crashed
    predecessor (``recovered_files`` counts them).
    """

    def __init__(self, disk_dir: Optional[str] = None,
                 host_limit_bytes: Optional[int] = None):
        from ..utils import config
        self._lock = threading.Lock()
        self._seq = 0
        self._file_seq = 0
        self._entries: Dict[int, Tuple[int, SpillableTable]] = {}
        if disk_dir is None:
            disk_dir = config.get("spill.disk_dir") or None
        if host_limit_bytes is None:
            host_limit_bytes = int(config.get("spill.host_limit_bytes"))
        self._disk_dir = disk_dir
        self._host_limit = host_limit_bytes
        self.recovered_files = 0
        if self._disk_dir:
            os.makedirs(self._disk_dir, exist_ok=True)
            # startup recovery: a crash mid-write leaves *.tmp (torn) and a
            # crash mid-run leaves complete-but-ownerless spill files; both
            # are dead weight — their tables re-materialize from upstream
            self.recovered_files = clean_spill_dir(self._disk_dir)
        _STORES.add(self)  # weak: the watchdog's stall bundles snapshot us

    def _touch(self, st: SpillableTable) -> None:
        with self._lock:
            if id(st) in self._entries:
                self._seq += 1
                self._entries[id(st)] = (self._seq, st)

    def register(self, table) -> SpillableTable:
        st = table if isinstance(table, SpillableTable) \
            else SpillableTable(table)
        st._mark_written()
        with self._lock:
            self._seq += 1
            self._entries[id(st)] = (self._seq, st)
        st._on_promote = self._touch
        st._on_spill = self._host_pressure
        return st

    def unregister(self, st: SpillableTable) -> None:
        with self._lock:
            self._entries.pop(id(st), None)

    def device_bytes(self) -> int:
        with self._lock:
            entries = list(self._entries.values())
        return sum(st.device_nbytes for _, st in entries)

    def host_bytes(self) -> int:
        """Bytes held by host-resident (spilled, not yet disk) tables."""
        with self._lock:
            entries = list(self._entries.values())
        return sum(st.host_nbytes for _, st in entries)

    def _next_path(self) -> str:
        with self._lock:
            self._file_seq += 1
            seq = self._file_seq
        return os.path.join(self._disk_dir,
                            f"srjt-spill-{os.getpid()}-{seq}.spill")

    def _host_pressure(self, _st: SpillableTable) -> None:
        """Post-spill hook: demote LRU host tables to disk while the host
        tier is over budget (no-op unless both knobs are configured)."""
        if not self._disk_dir or self._host_limit <= 0:
            return
        while self.host_bytes() > self._host_limit:
            with self._lock:
                order = sorted(self._entries.values(), key=lambda e: e[0])
            victim = next((st for _, st in order if st.host_nbytes > 0),
                          None)
            if victim is None:
                return
            if victim.spill_to_disk(self._next_path()) <= 0:
                return  # raced to another state; avoid spinning

    def spill_to_fit(self, bytes_needed: int) -> int:
        """Spill least-recently-promoted-first until ``bytes_needed`` device
        bytes have been released (or everything is spilled). Returns freed
        bytes."""
        with self._lock:
            order = sorted(self._entries.values(), key=lambda e: e[0])
        freed = 0
        for _, st in order:
            if freed >= bytes_needed:
                break
            if st.is_quarantined:
                continue  # nothing left to release; owner must rebuild
            freed += st.spill()
        return freed

    def spill_all(self) -> int:
        return self.spill_to_fit(1 << 62)

    def rollback_cb(self):
        """Rollback callable for with_retry: spill everything registered
        ("roll back to a spillable state", GpuRetryOOM contract)."""
        def rollback():
            self.spill_all()
        return rollback

    def flush(self, fsync: bool = True) -> Dict[str, Any]:
        """Drain-time flush (the JAX package's TaskExecutor.drain step 3):
        spill everything off the device, demote every host-resident table to the
        checksummed disk tier, and fsync the spill directory so a SIGKILL
        right after the drain loses nothing that was ever spilled. A
        no-disk-tier store just spills (nothing durable to write)."""
        spilled = self.spill_all()
        demoted = 0
        fsynced = False
        if self._disk_dir:
            with self._lock:
                order = sorted(self._entries.values(), key=lambda e: e[0])
            for _, st in order:
                if st.host_nbytes > 0 and \
                        st.spill_to_disk(self._next_path()) > 0:
                    demoted += 1
            if fsync:
                # the spill files themselves fsync on write (atomic
                # rename path); the DIRECTORY entry needs its own sync
                # for the names to survive power loss
                try:
                    fd = os.open(self._disk_dir, os.O_RDONLY)
                    try:
                        os.fsync(fd)
                    finally:
                        os.close(fd)
                    fsynced = True
                except OSError:
                    fsynced = False
        return {"device_bytes_spilled": spilled,
                "demoted_to_disk": demoted, "fsynced": fsynced}

    def state(self) -> Dict[str, Any]:
        """One store's live summary for a watchdog diagnostics bundle:
        table count per tier plus byte totals — enough to tell a
        spill-storm stall from a wedged transfer at a glance.

        Runs on the watchdog thread at the moment of a stall, so it must
        NEVER block: a wedged spill/promote holds its table's lock, and a
        blocking read here would make the diagnostics join the very
        deadlock they are documenting. A table whose lock is busy is
        reported under tier "busy" with its bytes skipped."""
        with self._lock:
            entries = [st for _, st in self._entries.values()]
        tiers = {SpillableTable.DEVICE: 0, SpillableTable.HOST: 0,
                 SpillableTable.DISK: 0, SpillableTable.QUARANTINED: 0,
                 "busy": 0}
        device_bytes = host_bytes = 0
        for st in entries:
            if not st._lock.acquire(blocking=False):
                tiers["busy"] += 1
                continue
            try:
                tiers[st._state] += 1
                if st._state == SpillableTable.DEVICE:
                    device_bytes += st._table.device_nbytes()
                elif st._state == SpillableTable.HOST:
                    host_bytes += st._table.device_nbytes()
            finally:
                st._lock.release()
        return {
            "tables": len(entries),
            "tiers": tiers,
            "device_bytes": device_bytes,
            "host_bytes": host_bytes,
            "host_limit_bytes": self._host_limit,
            "disk_dir": self._disk_dir or None,
            "recovered_files": self.recovered_files,
        }


# live stores, weakly held: a stall's diagnostics bundle snapshots every
# store still alive without keeping closed ones reachable
_STORES: "weakref.WeakSet[SpillStore]" = weakref.WeakSet()


def spill_state() -> List[Dict[str, Any]]:
    """Summaries of every live SpillStore (watchdog diagnostics bundles)."""
    return [s.state() for s in list(_STORES)]


def rollback_all_stores() -> int:
    """The process-wide rollback funnel for the retry-OOM protocol: spill
    every table registered in every live SpillStore back to a spillable
    state, returning total device bytes freed. Callers that hold their own
    store pass ``store.rollback_cb()`` to ``with_retry`` instead; the
    fused plan executor — which has no task context — rolls back through
    this funnel so ANY registered state yields under pressure (the
    GpuRetryOOM contract: everything spillable is released before the
    same program re-dispatches)."""
    freed = 0
    for s in list(_STORES):
        freed += s.spill_all()
    return freed
