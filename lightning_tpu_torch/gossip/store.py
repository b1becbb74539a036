"""gossip_store file I/O, format-compatible with Core Lightning.

On-disk format (common/gossip_store.h in Core Lightning):
  byte 0: version (major in the top 3 bits, must be 0; minor in the low 5)
  then records: be16 flags | be16 len | be32 crc | be32 timestamp | msg
  crc = crc32c(timestamp, msg)
  flags: DELETED 0x8000 | PUSH 0x4000 | RATELIMIT 0x2000 | DYING 0x0800.

One mmap and a native scan into flat numpy arrays; no per-record Python
objects.  Recovery after a crash (``recover_store``) truncates a torn
tail and re-checks the records whose CRC fails (counted as quarantined
store rows); ``mark_deleted`` and ``compact_store`` are Core Lightning's
flag flip and compaction.  ``StoreWriter``'s writes pass the "append"
fault seam (``resilience/faultinject.py``).
"""
from __future__ import annotations

import logging
import mmap
import os
from dataclasses import dataclass, field

import numpy as np

from ..obs import families as _f
from ..resilience import faultinject as _fault
from ..resilience import quarantine as _quarantine
from ..utils import native

log = logging.getLogger("lightning_tpu_torch.gossip.store")

VERSION_BYTE = 0x10  # major 0, minor 16
FLAG_DELETED = 0x8000
FLAG_PUSH = 0x4000       # stream to peers even before the timestamp filter
FLAG_RATELIMIT = 0x2000  # spam-flagged: kept but not relayed
FLAG_DYING = 0x0800      # funding spent; removed after 12 blocks


@dataclass
class StoreIndex:
    """Flat view of a scanned store: numpy arrays, one row per record."""

    buf: np.ndarray         # uint8 view of the whole file
    offsets: np.ndarray     # uint64, start of each message body
    lengths: np.ndarray     # uint32
    flags: np.ndarray       # uint16
    timestamps: np.ndarray  # uint32
    crcs: np.ndarray        # uint32
    types: np.ndarray       # uint16

    def alive(self) -> np.ndarray:
        return (self.flags & FLAG_DELETED) == 0

    def select(self, mask: np.ndarray) -> "StoreIndex":
        return StoreIndex(
            self.buf, self.offsets[mask], self.lengths[mask],
            self.flags[mask], self.timestamps[mask], self.crcs[mask],
            self.types[mask])

    def check_crcs(self) -> np.ndarray:
        """crc32c (timestamp-seeded) of each message; True = intact."""
        got = native.crc32c_batch(self.buf, self.offsets, self.lengths,
                                  self.timestamps)
        return got == self.crcs

    def message(self, i: int) -> bytes:
        o, n = int(self.offsets[i]), int(self.lengths[i])
        return bytes(self.buf[o:o + n])

    def __len__(self):
        return len(self.offsets)


def _empty_index() -> StoreIndex:
    return StoreIndex(
        np.frombuffer(bytes([VERSION_BYTE]), dtype=np.uint8),
        np.zeros(0, np.uint64), np.zeros(0, np.uint32),
        np.zeros(0, np.uint16), np.zeros(0, np.uint32),
        np.zeros(0, np.uint32), np.zeros(0, np.uint16))


def load_store(path: str) -> StoreIndex:
    """mmap the store and scan it natively.  A missing or empty store
    loads as a zero-record index; a torn store (a partial record at the
    end) raises."""
    if not os.path.exists(path) or os.path.getsize(path) < 1:
        return _empty_index()
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    buf = np.frombuffer(mm, dtype=np.uint8)
    if int(buf[0]) >> 5 != 0:
        raise ValueError(
            f"incompatible gossip store major version {int(buf[0]) >> 5}")
    return StoreIndex(buf, **native.gossip_store_scan(buf, start_off=1))


def scan_valid_prefix(path: str) -> int:
    """Length in bytes of the longest prefix that holds only complete
    records (the file size when the store is intact).  The native scan
    says that a store is torn, not where."""
    with open(path, "rb") as f:
        data = f.read()
    size = len(data)
    if size < 1:
        return 0
    off = 1
    while off + 12 <= size:
        ln = int.from_bytes(data[off + 2:off + 4], "big")
        if off + 12 + ln > size:
            break
        off += 12 + ln
    return off


@dataclass
class StoreRecovery:
    """What recover_store() found and did."""

    path: str
    bootstrapped: bool = False     # store was missing or empty, made fresh
    size: int = 0                  # byte size after recovery
    truncated_bytes: int = 0       # torn tail dropped (0: the tail was clean)
    crc_bad: int = 0               # records that failed check_crcs()
    requalified: int = 0           # CRC-bad records check_sigs kept
    dropped: int = 0               # CRC-bad records flagged deleted
    records: int = 0               # records in the recovered index
    dropped_rows: list = field(default_factory=list)


def _replace_atomically(path: str, data: bytes, suffix: str) -> None:
    """Write `data` to a temporary file, fsync it and rename it over
    `path`.  Never rewrite in place: a loaded StoreIndex is a live mmap
    of the old inode."""
    tmp = path + f".{suffix}.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _flag_deleted(path: str, idx: StoreIndex, rows) -> None:
    """Set FLAG_DELETED in place on `rows` and fsync.  The CRC covers the
    timestamp and the message only, so a flag write never tears a
    record."""
    with open(path, "r+b") as f:
        for i in rows:
            f.seek(int(idx.offsets[i]) - 12)
            f.write((int(idx.flags[i]) | FLAG_DELETED).to_bytes(2, "big"))
        f.flush()
        os.fsync(f.fileno())


def recover_store(path: str, *, check_sigs=None,
                  check_crc: bool = True) -> tuple[StoreIndex, StoreRecovery]:
    """Load a store that a crash may have torn.

    * a missing or empty store is created fresh (bootstrap);
    * a partial record at the end is cut off, by writing the valid
      prefix to a temporary file and renaming it over the store;
    * records whose CRC fails go to ``check_sigs(msgs) -> [bool]``: the
      ones it rejects get FLAG_DELETED set in place, the ones it accepts
      stay (the CRC covers timestamp and message, so a corrupt timestamp
      fails the CRC while the signatures still prove the message).
      ``check_sigs=None``, or a ``check_sigs`` that raises, drops every
      CRC-bad record.

    Returns (index, StoreRecovery).  Raises only on an incompatible
    version byte."""
    rep = StoreRecovery(path=path)
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        with open(path, "wb") as f:
            f.write(bytes([VERSION_BYTE]))
            f.flush()
            os.fsync(f.fileno())
        rep.bootstrapped = True
        rep.size = 1
        log.info("gossip store %s missing or empty: bootstrapped", path)
        return _empty_index(), rep

    size = os.path.getsize(path)
    valid_end = scan_valid_prefix(path)
    if valid_end < size:
        with open(path, "rb") as f:
            good = f.read(valid_end)
        _replace_atomically(path, good, "recover")
        rep.truncated_bytes = size - valid_end
        _f.RECOVERY_STORE_TRUNCATED_BYTES.inc(rep.truncated_bytes)
        log.warning("gossip store %s: torn tail (%d bytes past offset %d) "
                    "truncated", path, rep.truncated_bytes, valid_end)

    idx = load_store(path)
    rep.records = len(idx)
    rep.size = os.path.getsize(path)
    if not check_crc or len(idx) == 0:
        return idx, rep

    bad = np.flatnonzero(~idx.check_crcs())
    if len(bad) == 0:
        return idx, rep
    rep.crc_bad = int(len(bad))
    _quarantine.note("store", "crc_mismatch", rep.crc_bad)
    keep = np.zeros(len(bad), bool)
    if check_sigs is not None:
        msgs = [idx.message(int(i)) for i in bad]
        try:
            keep = np.asarray(check_sigs(msgs), bool)
        except Exception:
            log.exception("re-check of CRC-bad records failed; "
                          "dropping all %d", rep.crc_bad)
            keep = np.zeros(len(bad), bool)
    rep.requalified = int(keep.sum())
    drop = bad[~keep]
    rep.dropped = int(len(drop))
    rep.dropped_rows = [int(i) for i in drop]
    if rep.requalified:
        _f.RECOVERY_STORE_ROWS.labels("requalified").inc(rep.requalified)
    if rep.dropped:
        _f.RECOVERY_STORE_ROWS.labels("dropped").inc(rep.dropped)
        _flag_deleted(path, idx, drop)
        idx.flags[drop] |= FLAG_DELETED
    log.warning("gossip store %s: %d CRC-bad record(s): %d requalified, "
                "%d dropped", path, rep.crc_bad, rep.requalified,
                rep.dropped)
    return idx, rep


def _record(msg: bytes, timestamp: int, flags: int = 0) -> bytes:
    return (int(flags).to_bytes(2, "big") + len(msg).to_bytes(2, "big")
            + native.crc32c(timestamp, msg).to_bytes(4, "big")
            + int(timestamp).to_bytes(4, "big") + msg)


class StoreWriter:
    """Append-only store writer."""

    def __init__(self, path: str):
        self.path = path
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        self.f = open(path, "ab")
        if fresh:
            self.f.write(bytes([VERSION_BYTE]))

    def _write(self, blob: bytes) -> None:
        """One store write at the "append" fault seam.  With a crash
        armed there, the write is split so the kill lands MID-record (the
        torn tail that recover_store cuts on the next start); a raise or
        hang fires before any byte is written, so an injected error
        never corrupts the store."""
        if blob and _fault.crash_armed("append", "store"):
            half = max(1, len(blob) // 2)
            self.f.write(blob[:half])
            self.f.flush()
            _fault.fire("append", "store")
            self.f.write(blob[half:])
        else:
            _fault.fire("append", "store")
            self.f.write(blob)

    def append(self, msg: bytes, timestamp: int = 0, flags: int = 0,
               sync: bool = False):
        """Append one record; sync=True makes it durable before
        returning."""
        self._write(_record(msg, timestamp, flags))
        if sync:
            self.sync()

    def sync(self):
        self.f.flush()
        os.fsync(self.f.fileno())

    def append_many(self, msgs, timestamps=None, sync: bool = False):
        """Append a batch as one contiguous write, in argument order;
        sync=True makes the whole batch durable before returning.  A
        crash can lose only a suffix of the batch (and leave one torn
        record at the cut, which recover_store removes): it never keeps
        record i + 1 without record i."""
        self._write(b"".join(
            _record(m, int(timestamps[i]) if timestamps is not None else 0)
            for i, m in enumerate(msgs)))
        if sync:
            self.sync()

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def mark_deleted(path: str, scids: set[int]) -> int:
    """Set FLAG_DELETED in place on every channel_announcement and
    channel_update whose scid is in `scids` (Core Lightning's
    gossip_store_del).  Returns the number of records flagged."""
    from . import wire

    idx = load_store(path)
    rows = []
    for i in range(len(idx)):
        if idx.flags[i] & FLAG_DELETED:
            continue
        if idx.types[i] not in (wire.MSG_CHANNEL_ANNOUNCEMENT,
                                wire.MSG_CHANNEL_UPDATE):
            continue
        try:
            p = wire.parse_gossip(idx.message(i))
        except Exception:
            continue
        if p.short_channel_id in scids:
            rows.append(i)
    _flag_deleted(path, idx, rows)
    return len(rows)


def compact_store(src: str, dst: str) -> int:
    """Rewrite the store without its deleted records (Core Lightning's
    compactd).  Returns the record count."""
    idx = load_store(src)
    keep = idx.select(idx.alive())
    out = []
    for i in range(len(keep)):
        o, n = int(keep.offsets[i]), int(keep.lengths[i])
        out.append(int(keep.flags[i]).to_bytes(2, "big")
                   + n.to_bytes(2, "big")
                   + int(keep.crcs[i]).to_bytes(4, "big")
                   + int(keep.timestamps[i]).to_bytes(4, "big")
                   + bytes(keep.buf[o:o + n]))
    _replace_atomically(dst, bytes([VERSION_BYTE]) + b"".join(out),
                        "compact")
    return len(keep)
