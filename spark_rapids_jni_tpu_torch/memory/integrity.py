"""Buffer integrity: fingerprints, checksummed spill files, bit-flip chaos
(the JAX package's memory/integrity.py, table parts).

  * **Fingerprints** — per-buffer crc32 (zlib) seeded with dtype + shape,
    composed recursively over Column trees. ``table_fingerprint`` at spill
    time, ``verify_table`` at unspill; a mismatch is a ``CorruptionError``.
    A buffer is read as the JAX package stores it (FLOAT64 as its uint64
    bits, UINT16/32/64 unsigned), so the same table has the same
    fingerprint in both packages: the bytes are the same.
  * **Checksummed spill files** — the disk spill tier's on-disk format:
    a JSON manifest (schema + per-buffer crc) followed by raw buffer
    bytes, written atomically (tmp + fsync + rename) and verified
    buffer-by-buffer on promote. The format is the JAX package's.
  * **Bit-flip injection** — the payload-aware half of the fault injector
    (``injectionType: 3``): XOR one random bit of a transiting buffer so
    every detector above is provable end to end.

Recovery for this domain is never retry-in-place: a corrupted buffer is
discarded and rebuilt from its source.

Host-resident tables here are Columns of CPU tensors (memory/transport.py
``to_host``). Not ported: the admission journal's record framing and the
exchange wire's ``bitflip_spec`` (their users, the serving fleet and the
sharded exchange, are ROADMAP A15/A16).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar.column import Column, Table


class CorruptionError(RuntimeError):
    """Checksum/fingerprint verification failed: the bytes in hand are not
    the bytes that were written. Classified as the CORRUPTION fault domain
    (faultinj/guard.py) — discard and reconstruct from source; never
    retry-in-place, the corrupted copy stays wrong."""


# ---------------------------------------------------------------------------
# host buffers, as the JAX package stores them
# ---------------------------------------------------------------------------

# the ids whose torch storage differs from the JAX package's numpy storage
# by signedness or type only (the bits are the same)
_WIRE_VIEW = {dt.TypeId.FLOAT64: np.uint64, dt.TypeId.UINT16: np.uint16,
              dt.TypeId.UINT32: np.uint32, dt.TypeId.UINT64: np.uint64}


def _host_np(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    if t is None:
        return None
    if t.device.type != "cpu":
        raise ValueError("fingerprints read host-resident tables "
                         "(memory/transport.to_host)")
    return t.contiguous().numpy()


def _col_buffers(col: Column) -> List[Tuple[str, Optional[np.ndarray]]]:
    """(slot name, host view in the JAX package's storage dtype) for this
    column's own buffers (not children)."""
    data = _host_np(col.data)
    view = _WIRE_VIEW.get(col.dtype.id)
    if data is not None and view is not None:
        data = data.view(view)
    return [("data", data), ("validity", _host_np(col.validity)),
            ("offsets", _host_np(col.offsets))]


def _to_tensor(arr: np.ndarray, col_dtype: dt.DType,
               slot: str) -> torch.Tensor:
    """A buffer in the JAX package's storage back to the port's (a fresh
    tensor: spill-file buffers are read-only views)."""
    if slot == "data" and col_dtype.id in _WIRE_VIEW:
        storage = torch.empty(0, dtype=col_dtype.torch_dtype).numpy().dtype
        arr = arr.view(storage)
    return torch.from_numpy(np.array(arr, copy=True))


def buffer_crc(arr: np.ndarray) -> int:
    """crc32 of one host buffer, seeded with dtype + shape so a truncated
    or reinterpreted buffer cannot collide with its original."""
    a = np.ascontiguousarray(arr)
    seed = zlib.crc32(f"{a.dtype.str}|{a.shape}".encode())
    return zlib.crc32(a.view(np.uint8).reshape(-1), seed) & 0xFFFFFFFF


def column_fingerprint(col: Column) -> dict:
    """Recursive per-buffer crc32 fingerprint of one host column."""
    return {
        "bufs": {k: None if v is None else buffer_crc(v)
                 for k, v in _col_buffers(col)},
        "children": [column_fingerprint(ch) for ch in col.children],
    }


def table_fingerprint(table: Table) -> Tuple[dict, ...]:
    """Fingerprint every column of a host-resident table (spill time)."""
    return tuple(column_fingerprint(c) for c in table.columns)


def _verify_col(col: Column, fp: dict, path: str, bad: List[str]) -> None:
    for k, v in _col_buffers(col):
        want = fp["bufs"].get(k)
        if v is None or want is None:
            if (v is None) != (want is None):
                bad.append(f"{path}.{k} (buffer presence changed)")
            continue
        got = buffer_crc(v)
        if got != want:
            bad.append(f"{path}.{k} (crc {got:#010x} != {want:#010x})")
    for i, (ch, cfp) in enumerate(zip(col.children, fp["children"])):
        _verify_col(ch, cfp, f"{path}.child[{i}]", bad)


def verify_table(table: Table, fp: Tuple[dict, ...],
                 context: str = "buffer") -> None:
    """Re-fingerprint ``table`` against ``fp``; raise CorruptionError
    naming every mismatching buffer."""
    bad: List[str] = []
    for i, (col, cfp) in enumerate(zip(table.columns, fp)):
        _verify_col(col, cfp, f"col[{i}]", bad)
    if bad:
        raise CorruptionError(
            f"{context}: fingerprint mismatch (corruption) in "
            f"{', '.join(bad)}")


# ---------------------------------------------------------------------------
# checksummed spill files (the disk tier's on-disk format)
# ---------------------------------------------------------------------------
#
# layout:  magic "SRJTSPL1" | u32 manifest_len | manifest JSON | buffer bytes
# manifest: {"columns": [col tree], "buffers": [{dtype, shape, crc, nbytes}]}
# buffers are concatenated in manifest order after the JSON. The tmp file is
# fsync'd before os.replace so a torn write can only ever leave a *.tmp
# orphan (cleaned at store construction), never a half-written final file.

_SPILL_MAGIC = b"SRJTSPL1"


def _ser_col(col: Column, bufs: List[np.ndarray]) -> dict:
    meta: Dict[str, object] = {
        "type_id": col.dtype.id.name, "scale": col.dtype.scale,
        "size": col.size, "bufs": {},
    }
    for k, v in _col_buffers(col):
        if v is None:
            meta["bufs"][k] = None
        else:
            meta["bufs"][k] = len(bufs)
            bufs.append(np.ascontiguousarray(v))
    meta["children"] = [_ser_col(ch, bufs) for ch in col.children]
    return meta


def _deser_col(meta: dict, bufs: List[np.ndarray]) -> Column:
    d = dt.DType(dt.TypeId[meta["type_id"]], meta["scale"])

    def pick(k):
        i = meta["bufs"][k]
        return None if i is None else _to_tensor(bufs[i], d, k)
    children = tuple(_deser_col(cm, bufs) for cm in meta["children"])
    return Column(d, meta["size"], data=pick("data"),
                  validity=pick("validity"), offsets=pick("offsets"),
                  children=children)


def write_table_file(path: str, table: Table) -> int:
    """Atomically persist a host-resident table to ``path`` with per-buffer
    crc32 in the manifest. Returns bytes written. Write protocol: tmp file
    in the same directory, flush + fsync, then rename — a crash mid-write
    leaves only a ``*.tmp`` orphan for startup cleanup."""
    bufs: List[np.ndarray] = []
    cols = [_ser_col(c, bufs) for c in table.columns]
    manifest = json.dumps({
        "columns": cols,
        "buffers": [{"dtype": b.dtype.str, "shape": list(b.shape),
                     "crc": buffer_crc(b), "nbytes": b.nbytes}
                    for b in bufs],
    }).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_SPILL_MAGIC)
        f.write(struct.pack("<I", len(manifest)))
        f.write(manifest)
        for b in bufs:
            f.write(b.view(np.uint8).reshape(-1).tobytes())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return os.path.getsize(path)


def read_table_file(path: str, inject_api: Optional[str] = None) -> Table:
    """Load + verify a spill file written by :func:`write_table_file`.

    Every buffer's crc32 is checked against the manifest; any mismatch —
    or a truncated/garbled file — raises :class:`CorruptionError` (the
    file on disk is not what was written; the caller must discard and
    re-materialize from source). ``inject_api`` names the bit-flip
    injection surface applied to the raw payload before verification
    (chaos runs prove the detector)."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise CorruptionError(f"spill file {path}: unreadable ({e})") from e
    head = len(_SPILL_MAGIC) + 4
    if len(raw) < head or raw[:len(_SPILL_MAGIC)] != _SPILL_MAGIC:
        raise CorruptionError(f"spill file {path}: bad magic (corruption)")
    (mlen,) = struct.unpack_from("<I", raw, len(_SPILL_MAGIC))
    if len(raw) < head + mlen:
        raise CorruptionError(
            f"spill file {path}: truncated manifest (corruption)")
    try:
        manifest = json.loads(raw[head:head + mlen])
        entries = manifest["buffers"]
        cols_meta = manifest["columns"]
    except (ValueError, KeyError, TypeError) as e:
        raise CorruptionError(
            f"spill file {path}: garbled manifest (corruption)") from e
    payload = bytearray(raw[head + mlen:])
    if inject_api is not None and payload:
        maybe_flip_arrays(inject_api,
                          [np.frombuffer(payload, dtype=np.uint8)])
    bufs: List[np.ndarray] = []
    pos = 0
    for ent in entries:
        nbytes = int(ent["nbytes"])
        if pos + nbytes > len(payload):
            raise CorruptionError(
                f"spill file {path}: truncated payload (corruption)")
        b = (np.frombuffer(payload, dtype=np.uint8, count=nbytes,
                           offset=pos)
             .view(ent["dtype"]).reshape(ent["shape"]))
        if buffer_crc(b) != int(ent["crc"]):
            raise CorruptionError(
                f"spill file {path}: buffer crc mismatch (corruption)")
        bufs.append(b)
        pos += nbytes
    return Table(tuple(_deser_col(cm, bufs) for cm in cols_meta))


def clean_spill_dir(disk_dir: str, prefix: str = "srjt-spill-") -> int:
    """Startup recovery for a disk spill tier directory: remove torn-write
    ``*.tmp`` files and orphaned spill files from dead processes (spill
    files never outlive their store). Returns files removed."""
    removed = 0
    try:
        names = os.listdir(disk_dir)
    except OSError:
        return 0
    for name in names:
        if not name.startswith(prefix):
            continue
        try:
            os.unlink(os.path.join(disk_dir, name))
            removed += 1
        except OSError:
            pass
    return removed


# ---------------------------------------------------------------------------
# payload bit-flip injection (faultinj injectionType 3)
# ---------------------------------------------------------------------------

def maybe_flip_arrays(api: str, arrays: List[np.ndarray]) -> int:
    """Consult the installed fault injector for an ``injectionType: 3``
    rule on ``api``; when it fires, XOR one random bit of one of the
    (writable) ``arrays`` in place. Returns the number of flips (0/1).
    Suppressed in degraded mode, like every other injection."""
    from ..faultinj.guard import degraded_mode
    from ..faultinj.injector import get_injector
    inj = get_injector()
    if inj is None or degraded_mode():
        return 0
    rng = inj.bitflip_rng(api)
    if rng is None:
        return 0
    live = [a for a in arrays if a is not None and a.nbytes > 0]
    if not live:
        return 0
    a = live[rng.randrange(len(live))]
    flat = a.view(np.uint8).reshape(-1)
    byte = rng.randrange(flat.shape[0])
    flat[byte] ^= np.uint8(1 << rng.randrange(8))
    return 1


def maybe_flip_table(api: str, table: Table) -> Tuple[Table, int]:
    """Bit-flip injection over a host-resident table: when the rule fires,
    rebuild the table with exactly one buffer's copy carrying a single
    flipped bit (the flip lands on a fresh copy; the caller's buffers are
    never changed). Returns (table, flips). The buffer, byte and bit are
    drawn as in the JAX package, so one seed flips the same bit in both."""
    from ..faultinj.guard import degraded_mode
    from ..faultinj.injector import get_injector
    inj = get_injector()
    if inj is None or degraded_mode():
        return table, 0
    rng = inj.bitflip_rng(api)
    if rng is None:
        return table, 0

    # enumerate (column path, slot) targets with non-empty buffers
    targets: List[Tuple[Tuple[int, ...], str]] = []

    def walk(col: Column, path: Tuple[int, ...]) -> None:
        for k, v in _col_buffers(col):
            if v is not None and v.nbytes > 0:
                targets.append((path, k))
        for i, ch in enumerate(col.children):
            walk(ch, path + (i,))

    for i, col in enumerate(table.columns):
        walk(col, (i,))
    if not targets:
        return table, 0
    tpath, tslot = targets[rng.randrange(len(targets))]

    def rebuild(col: Column, path: Tuple[int, ...]) -> Column:
        hit = path == tpath
        kw = {"data": col.data, "validity": col.validity,
              "offsets": col.offsets}
        for k, v in _col_buffers(col):
            if hit and k == tslot:
                flipped = np.array(v, copy=True)
                flat = flipped.view(np.uint8).reshape(-1)
                byte = rng.randrange(flat.shape[0])
                flat[byte] ^= np.uint8(1 << rng.randrange(8))
                kw[k] = _to_tensor(flipped, col.dtype, k)
        children = tuple(rebuild(ch, path + (i,))
                         for i, ch in enumerate(col.children))
        return Column(col.dtype, col.size, children=children, **kw)

    cols = tuple(rebuild(c, (i,)) if tpath[0] == i else c
                 for i, c in enumerate(table.columns))
    return Table(cols), 1
