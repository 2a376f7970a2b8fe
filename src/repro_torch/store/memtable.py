"""Memtable + write-ahead log.

The memtable keeps the newest version per user key, plus — only while an
MVCC snapshot bound spans the overwrite — shadowed older versions in a
per-key history list.  The ``retain`` hook (injected by the store layer,
``None`` means "never retain") decides at overwrite time whether the old
version is still readable by a registered snapshot; unretained versions
are discarded exactly as before, so with no snapshots active the
memtable behaves identically to the single-version original.  A
sorted-key cache is maintained lazily for flush and range scans.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple

from .blocks import decode_record, encode_record, encode_varint, decode_varint
from .device import BlockDevice, IOClass

Versioned = Tuple[int, int, bytes]  # (seq, vtype, payload)


class Memtable:
    def __init__(self, retain: Optional[Callable[[int, int], bool]] = None
                 ) -> None:
        self._data: Dict[bytes, Versioned] = {}
        self._hist: Dict[bytes, List[Versioned]] = {}   # newest-first
        self._sorted: Optional[List[bytes]] = None
        self.retain = retain        # retain(old_seq, new_seq) -> keep old?
        self.approx_bytes = 0

    def put(self, ukey: bytes, seq: int, vtype: int, payload: bytes) -> None:
        old = self._data.get(ukey)
        if old is None:
            self._sorted = None
            self.approx_bytes += len(ukey) + 16
        elif self.retain is not None and self.retain(old[0], seq):
            self._hist.setdefault(ukey, []).insert(0, old)
        else:
            self.approx_bytes -= len(old[2])
        self._data[ukey] = (seq, vtype, payload)
        self.approx_bytes += len(payload)

    def get(self, ukey: bytes) -> Optional[Versioned]:
        return self._data.get(ukey)

    def get_at(self, ukey: bytes, bound: int) -> Optional[Versioned]:
        """Newest version with ``seq <= bound``, or None if every version
        of the key here is newer (caller falls through to older sources —
        a key's versions are distributed monotonically across memtable →
        immutables → L0 → deeper levels, so the first source holding ANY
        version ``<= bound`` holds the visible one)."""
        v = self._data.get(ukey)
        if v is not None and v[0] <= bound:
            return v
        for h in self._hist.get(ukey, ()):
            if h[0] <= bound:
                return h
        return None

    def __len__(self) -> int:
        return len(self._data)

    def sorted_items(self) -> Iterator[Tuple[bytes, Versioned]]:
        """Newest version per key, key-ascending (history excluded)."""
        if self._sorted is None:
            self._sorted = sorted(self._data)
        for k in self._sorted:
            yield k, self._data[k]

    def sorted_entries(self) -> Iterator[Tuple[bytes, Versioned]]:
        """All resident versions in (key asc, seq desc) order — what
        flush writes out so snapshot-retained history survives the
        memtable's death."""
        if self._sorted is None:
            self._sorted = sorted(self._data)
        for k in self._sorted:
            yield k, self._data[k]
            for h in self._hist.get(k, ()):
                yield k, h


def encode_wal_record(ukey: bytes, seq: int, vtype: int,
                      payload: bytes) -> bytes:
    """One log record: ``varint(seq) varint(vtype) record(key, payload)``.
    Shared by the solo WAL and the group-commit log (which prefixes a
    shard tag — see ``core.commitlog``)."""
    return (encode_varint(seq) + encode_varint(vtype)
            + encode_record(ukey, payload))


class WAL:
    """Append-only log; one per memtable, truncated after flush."""

    def __init__(self, device: BlockDevice) -> None:
        self.device = device
        self.fid = device.create()

    def append(self, ukey: bytes, seq: int, vtype: int, payload: bytes,
               cls: IOClass = IOClass.WAL) -> int:
        """Append one record; returns its encoded size (sync accounting)."""
        rec = encode_wal_record(ukey, seq, vtype, payload)
        self.device.append(self.fid, rec, cls)
        return len(rec)

    def close(self) -> None:
        self.device.delete(self.fid)

    @staticmethod
    def replay(device: BlockDevice, fid: int
               ) -> Iterator[Tuple[bytes, int, int, bytes]]:
        """Yield (ukey, seq, vtype, payload); used on crash recovery."""
        buf = device.read_all(fid, IOClass.MANIFEST)
        pos = 0
        while pos < len(buf):
            try:
                seq, p = decode_varint(buf, pos)
                vtype, p = decode_varint(buf, p)
                ukey, payload, p = decode_record(buf, p)
            except IndexError:      # torn tail write — stop at last good rec
                return
            if p > len(buf):        # body truncated mid-key/payload
                return
            pos = p
            yield ukey, seq, vtype, payload
