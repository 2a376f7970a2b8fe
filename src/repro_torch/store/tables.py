"""SSTable formats: BTable (baseline), DTable (kSST, index/record separated),
RTable (vSST, dense per-record index) and LogTable (Titan/BlobDB blob file).

All tables share a footer layout and msgpack-encoded metadata sections::

    [sections ...][props][footer: <6Q B B magic> = props_off, props_len,
                          idx_off, idx_len, aux_off, aux_len, type, version]

Format versions (the footer's version byte; the legacy footer padded this
byte with zero, so old files decode as version 0):

* **0 — legacy**: raw blocks, single whole-table Bloom filters in the kSST
  aux section, no checksums.  Still fully readable.
* **2 — block I/O**: every block (kSST data/index-entry/meta blocks, RTable
  records + partitions, VBTable value blocks) is wrapped in a
  :mod:`~repro.store.blockio` envelope — codec tag, lengths, CRC32 — and
  tables carry partitioned per-table Bloom filters
  (:mod:`~repro.store.filter`): kSSTs in the aux section, vSSTs in the
  footer's aux slot.  A checksum failure raises
  :class:`~repro.store.blockio.BlockCorruptionError` instead of returning
  damaged bytes.  LogTable blob files stay raw: they have no footer and KA
  entries address records directly.

Readers charge every device read to the :class:`~repro.store.device.IOClass`
passed by the caller, so the same reader serves user gets (USER_READ),
compaction scans (COMPACTION_READ) and GC (GC_READ / GC_LOOKUP) with proper
attribution — that attribution is what Fig. 4's breakdown measures.
"""

from __future__ import annotations

import struct
from bisect import bisect_left
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import msgpack

from .blockio import (CODEC_NONE, CODECS, decode_block, encode_block,
                      iter_blocks)
from .blocks import BlockCache, decode_record, encode_record
from .device import BlockDevice, IOClass
from .filter import BloomFilter, build_filter, decode_filter
from .format import (VT_INDEX_KA, VT_INDEX_KF,
                     entry_value_size, entry_vsst, pack_ikey, unpack_ikey)

FOOTER = struct.Struct("<6QBBxxxxxx")
TABLE_BTABLE = 0
TABLE_DTABLE = 1
TABLE_RTABLE = 2
TABLE_LOG = 3

FMT_LEGACY = 0   # pre-block-I/O files: raw blocks, whole-table blooms
FMT_V2 = 2       # enveloped blocks (codec + CRC32), partitioned filters

Entry = Tuple[bytes, int, int, bytes]  # (ukey, seq, vtype, payload)


def _pack_entries_block(entries: List[Entry]) -> bytes:
    out = bytearray()
    for ukey, seq, vtype, payload in entries:
        out += encode_record(pack_ikey(ukey, seq, vtype), payload)
    return bytes(out)


def _unpack_entries_block(buf: bytes) -> List[Entry]:
    entries: List[Entry] = []
    pos = 0
    while pos < len(buf):
        ikey, payload, pos = decode_record(buf, pos)
        ukey, seq, vtype = unpack_ikey(ikey)
        entries.append((ukey, seq, vtype, payload))
    return entries


def _encoder(device: BlockDevice, codec: str, min_ratio: float,
             label) -> Callable[[bytes], bytes]:
    """Per-writer envelope encoder bound to the device's codec stats."""
    cid = CODECS.get(codec, CODEC_NONE)
    stats = device.block_stats

    def enc(payload: bytes) -> bytes:
        return encode_block(payload, cid, min_ratio=min_ratio, stats=stats,
                            label=label, device=device)
    return enc


class _SectionWriter:
    """Accumulates blocks for one section, building a sparse index."""

    def __init__(self, block_bytes: int) -> None:
        self.block_bytes = block_bytes
        self.blocks: List[bytes] = []
        self.index: List[Tuple[bytes, bytes, int, int]] = []  # first,last,off,len
        self._cur: List[Entry] = []
        self._cur_bytes = 0

    def add(self, e: Entry) -> None:
        self._cur.append(e)
        self._cur_bytes += len(e[0]) + len(e[3]) + 10
        if self._cur_bytes >= self.block_bytes:
            self._seal()

    def _seal(self) -> None:
        if not self._cur:
            return
        blk = _pack_entries_block(self._cur)
        self.blocks.append(blk)
        self.index.append((self._cur[0][0], self._cur[-1][0], -1, len(blk)))
        self._cur = []
        self._cur_bytes = 0

    def finish(self, base_off: int,
               enc: Optional[Callable[[bytes], bytes]] = None
               ) -> Tuple[bytes, List[Tuple[bytes, bytes, int, int]]]:
        self._seal()
        out = bytearray()
        fixed = []
        off = base_off
        for blk, (fk, lk, _, _) in zip(self.blocks, self.index):
            if enc is not None:
                blk = enc(blk)
            out += blk
            fixed.append((fk, lk, off, len(blk)))
            off += len(blk)
        return bytes(out), fixed


class TableProps(dict):
    """Table properties; notable keys:

    num_entries, raw_key_bytes, raw_value_bytes,
    compensated_bytes  — index bytes + referenced value bytes (paper III-C),
    value_refs         — {vsst_fid: [entries, bytes]} dependency map
                         (TerarkDB-style kSST→vSST dependencies),
    table_type, smallest, largest.

    Sizes other than ``file_size``/``data_bytes`` are *logical* bytes —
    compression changes the physical layout, never the accounting the
    compaction picker and placement engine see.
    """


# ==========================================================================
# Writers
# ==========================================================================

class KTableWriter:
    """Writes kSSTs — BTable (mixed blocks) or DTable (separated sections).

    DTable (paper Fig. 9a) keeps inline small-KV records in *data blocks*
    and KA/KF index entries in *index-entry blocks* so GC-Lookup touches
    only the latter.

    ``level`` labels this table's blocks in the device's codec stats (per
    tree level bytes-before/after); ``fmt_version=FMT_LEGACY`` reproduces
    the pre-block-I/O format byte for byte (upgrade tests).
    """

    def __init__(self, device: BlockDevice, block_bytes: int = 4096,
                 dtable: bool = False, bits_per_key: int = 10,
                 codec: str = "none", min_ratio: float = 1.0,
                 level: int = 0, fmt_version: int = FMT_V2) -> None:
        self.device = device
        self.dtable = dtable
        self.bits_per_key = bits_per_key
        self.fmt_version = fmt_version
        self._enc = _encoder(device, codec, min_ratio, level)
        self.data = _SectionWriter(block_bytes)
        self.idxe = _SectionWriter(block_bytes) if dtable else self.data
        self.keys_data: List[bytes] = []
        self.keys_idxe: List[bytes] = []
        self.num_entries = 0
        self.raw_key_bytes = 0
        self.raw_value_bytes = 0
        self.compensated = 0
        self.value_refs: Dict[int, List[int]] = {}
        self.smallest: Optional[bytes] = None
        self.largest: Optional[bytes] = None

    def add(self, e: Entry) -> None:
        ukey, seq, vtype, payload = e
        if self.smallest is None:
            self.smallest = ukey
        self.largest = ukey
        self.num_entries += 1
        self.raw_key_bytes += len(ukey)
        vsz = entry_value_size(vtype, payload)
        self.raw_value_bytes += vsz
        self.compensated += len(ukey) + len(payload) + vsz
        if vtype in (VT_INDEX_KA, VT_INDEX_KF):
            fid = entry_vsst(vtype, payload)
            ref = self.value_refs.setdefault(fid, [0, 0])
            ref[0] += 1
            ref[1] += vsz
            self.idxe.add(e)
            # BTable keeps one mixed bloom; DTable blooms per section.
            (self.keys_idxe if self.dtable else self.keys_data).append(ukey)
        else:
            self.data.add(e)
            self.keys_data.append(ukey)

    @property
    def estimated_bytes(self) -> int:
        return self.raw_key_bytes + self.raw_value_bytes + self.num_entries * 10

    def finish(self, cls: IOClass = IOClass.FLUSH,
               fid: Optional[int] = None) -> Tuple[int, TableProps]:
        fid = self.device.create() if fid is None else fid
        enc = self._enc if self.fmt_version else None
        data_bytes, data_idx = self.data.finish(0, enc)
        sections = bytearray(data_bytes)
        if self.dtable:
            idxe_bytes, idxe_idx = self.idxe.finish(len(sections), enc)
            sections += idxe_bytes
        else:
            idxe_idx = []
        if self.fmt_version:
            bloom_d = build_filter(self.keys_data, self.bits_per_key)
            bloom_i = build_filter(self.keys_idxe, self.bits_per_key) \
                if self.dtable else b""
        else:
            bloom_d = BloomFilter.build(self.keys_data,
                                        self.bits_per_key).encode()
            bloom_i = BloomFilter.build(self.keys_idxe,
                                        self.bits_per_key).encode() \
                if self.dtable else b""
        index_payload = msgpack.packb(
            {"data": data_idx, "idxe": idxe_idx}, use_bin_type=True)
        if enc is not None:
            index_payload = enc(index_payload)
        idx_off = len(sections)
        sections += index_payload
        aux = msgpack.packb({"bloom_d": bloom_d, "bloom_i": bloom_i},
                            use_bin_type=True)
        if enc is not None:
            aux = enc(aux)
        aux_off = len(sections)
        sections += aux
        props = TableProps(
            num_entries=self.num_entries, raw_key_bytes=self.raw_key_bytes,
            raw_value_bytes=self.raw_value_bytes, compensated_bytes=self.compensated,
            value_refs={k: tuple(v) for k, v in self.value_refs.items()},
            table_type=TABLE_DTABLE if self.dtable else TABLE_BTABLE,
            smallest=self.smallest or b"", largest=self.largest or b"")
        props_b = msgpack.packb(dict(props), use_bin_type=True)
        if enc is not None:
            props_b = enc(props_b)
        props_off = len(sections)
        sections += props_b
        sections += FOOTER.pack(props_off, len(props_b), idx_off,
                                len(index_payload), aux_off, len(aux),
                                props["table_type"], self.fmt_version)
        self.device.append(fid, bytes(sections), cls)
        props["file_size"] = len(sections)
        return fid, props


class RTableWriter:
    """vSST with a *dense* per-record index (paper Fig. 8a).

    Records are `(key, value)` laid out back to back; the index holds one
    ``(key, offset, length)`` tuple per record, split into partitions so GC
    and point reads load only the partitions they need (partitioned index,
    paper III-B.1).

    Under ``FMT_V2`` each record is individually enveloped (records stay
    individually addressable — ``add`` returns the envelope span, and
    contiguous records remain contiguous for the adaptive-readahead span
    reads), and the footer's aux slot carries a partitioned Bloom filter
    over the key set.
    """

    def __init__(self, device: BlockDevice, index_partition: int = 64,
                 codec: str = "none", min_ratio: float = 1.0,
                 bits_per_key: int = 10,
                 fmt_version: int = FMT_V2) -> None:
        self.device = device
        self.index_partition = index_partition
        self.bits_per_key = bits_per_key
        self.fmt_version = fmt_version
        self._enc = _encoder(device, codec, min_ratio, "value")
        self.buf = bytearray()
        self.dense: List[Tuple[bytes, int, int]] = []
        self.total_value_bytes = 0

    def add(self, ukey: bytes, value: bytes) -> Tuple[int, int]:
        rec = encode_record(ukey, value)
        if self.fmt_version:
            rec = self._enc(rec)
        off = len(self.buf)
        self.buf += rec
        self.dense.append((ukey, off, len(rec)))
        self.total_value_bytes += len(value)
        return off, len(rec)

    @property
    def estimated_bytes(self) -> int:
        return len(self.buf)

    @property
    def num_entries(self) -> int:
        return len(self.dense)

    def finish(self, cls: IOClass = IOClass.FLUSH,
               fid: Optional[int] = None) -> Tuple[int, TableProps]:
        fid = self.device.create() if fid is None else fid
        enc = self._enc if self.fmt_version else None
        sections = bytearray(self.buf)
        partitions: List[bytes] = []
        top: List[Tuple[bytes, int, int]] = []
        for i in range(0, len(self.dense), self.index_partition):
            part = self.dense[i:i + self.index_partition]
            pb = msgpack.packb(part, use_bin_type=True)
            if enc is not None:
                pb = enc(pb)
            partitions.append(pb)
            top.append((part[-1][0], -1, len(pb)))
        idx_off = len(sections)
        fixed_top = []
        off = idx_off
        for pb, (lk, _, ln) in zip(partitions, top):
            sections += pb
            fixed_top.append((lk, off, ln))
            off += ln
        top_b = msgpack.packb(fixed_top, use_bin_type=True)
        if enc is not None:
            top_b = enc(top_b)
        top_off = len(sections)
        sections += top_b
        if self.fmt_version:
            filt = build_filter([k for k, _, _ in self.dense],
                                self.bits_per_key)
            if filt:
                filt = enc(filt)
            aux_off, aux_len = (len(sections), len(filt)) if filt else (0, 0)
            sections += filt
        else:
            # Legacy footer reused the aux slot for the partition base.
            aux_off, aux_len = idx_off, 0
        props = TableProps(
            num_entries=len(self.dense), total_value_bytes=self.total_value_bytes,
            data_bytes=len(self.buf), table_type=TABLE_RTABLE,
            smallest=self.dense[0][0] if self.dense else b"",
            largest=self.dense[-1][0] if self.dense else b"")
        props_b = msgpack.packb(dict(props), use_bin_type=True)
        if enc is not None:
            props_b = enc(props_b)
        props_off = len(sections)
        sections += props_b
        sections += FOOTER.pack(props_off, len(props_b), top_off, len(top_b),
                                aux_off, aux_len, TABLE_RTABLE,
                                self.fmt_version)
        self.device.append(fid, bytes(sections), cls)
        props["file_size"] = len(sections)
        return fid, props


class VBTableWriter:
    """vSST in BlockBasedTable layout (TerarkDB baseline): values packed in
    blocks with a *sparse* index — GC must read whole data blocks and cannot
    lazily skip invalid values (the deficiency RTable fixes)."""

    def __init__(self, device: BlockDevice, block_bytes: int = 16384,
                 codec: str = "none", min_ratio: float = 1.0,
                 bits_per_key: int = 10,
                 fmt_version: int = FMT_V2) -> None:
        self.device = device
        self.block_bytes = block_bytes
        self.bits_per_key = bits_per_key
        self.fmt_version = fmt_version
        self._enc = _encoder(device, codec, min_ratio, "value")
        self.blocks: List[List[Tuple[bytes, bytes]]] = [[]]
        self._cur_bytes = 0
        self.total_value_bytes = 0
        self.n = 0

    def add(self, ukey: bytes, value: bytes) -> Tuple[int, int]:
        self.blocks[-1].append((ukey, value))
        self._cur_bytes += len(ukey) + len(value) + 8
        self.total_value_bytes += len(value)
        self.n += 1
        if self._cur_bytes >= self.block_bytes:
            self.blocks.append([])
            self._cur_bytes = 0
        return -1, len(ukey) + len(value) + 8   # address resolved via key

    @property
    def estimated_bytes(self) -> int:
        return self.total_value_bytes + self.n * 8

    @property
    def num_entries(self) -> int:
        return self.n

    def finish(self, cls: IOClass = IOClass.FLUSH,
               fid: Optional[int] = None) -> Tuple[int, TableProps]:
        fid = self.device.create() if fid is None else fid
        enc = self._enc if self.fmt_version else None
        sections = bytearray()
        sparse: List[Tuple[bytes, bytes, int, int]] = []
        keys: List[bytes] = []
        smallest = largest = b""
        for blk in self.blocks:
            if not blk:
                continue
            payload = bytearray()
            for k, v in blk:
                payload += encode_record(k, v)
                keys.append(k)
            payload = bytes(payload)
            if enc is not None:
                payload = enc(payload)
            sparse.append((blk[0][0], blk[-1][0], len(sections), len(payload)))
            sections += payload
            if not smallest:
                smallest = blk[0][0]
            largest = blk[-1][0]
        data_end = len(sections)
        idx_b = msgpack.packb(sparse, use_bin_type=True)
        if enc is not None:
            idx_b = enc(idx_b)
        idx_off = len(sections)
        sections += idx_b
        aux_off = aux_len = 0
        if self.fmt_version:
            filt = build_filter(keys, self.bits_per_key)
            if filt:
                filt = enc(filt)
                aux_off, aux_len = len(sections), len(filt)
                sections += filt
        props = TableProps(num_entries=self.n,
                           total_value_bytes=self.total_value_bytes,
                           data_bytes=data_end, table_type=TABLE_BTABLE,
                           smallest=smallest, largest=largest)
        props_b = msgpack.packb(dict(props), use_bin_type=True)
        if enc is not None:
            props_b = enc(props_b)
        props_off = len(sections)
        sections += props_b
        sections += FOOTER.pack(props_off, len(props_b), idx_off, len(idx_b),
                                aux_off, aux_len, TABLE_BTABLE,
                                self.fmt_version)
        self.device.append(fid, bytes(sections), cls)
        props["file_size"] = len(sections)
        return fid, props


class LogTableWriter:
    """Unordered value log (WiscKey vLog / Titan blob file): records are
    addressed by (offset, size) held in the KA index entries.

    Stays raw (no envelopes): it has no footer to version, and KA offsets
    address records directly — integrity of the inline small-value path is
    carried by the kSSTs that index it.
    """

    def __init__(self, device: BlockDevice) -> None:
        self.device = device
        self.buf = bytearray()
        self.n = 0
        self.total_value_bytes = 0

    def add(self, ukey: bytes, value: bytes) -> Tuple[int, int]:
        rec = encode_record(ukey, value)
        off = len(self.buf)
        self.buf += rec
        self.n += 1
        self.total_value_bytes += len(value)
        return off, len(rec)

    @property
    def estimated_bytes(self) -> int:
        return len(self.buf)

    @property
    def num_entries(self) -> int:
        return self.n

    def finish(self, cls: IOClass = IOClass.FLUSH,
               fid: Optional[int] = None) -> Tuple[int, TableProps]:
        fid = self.device.create() if fid is None else fid
        props = TableProps(num_entries=self.n, data_bytes=len(self.buf),
                           total_value_bytes=self.total_value_bytes,
                           table_type=TABLE_LOG, smallest=b"", largest=b"")
        self.device.append(fid, bytes(self.buf), cls)
        props["file_size"] = len(self.buf)
        return fid, props


# ==========================================================================
# Readers
# ==========================================================================

class _Footer:
    __slots__ = ("props_off", "props_len", "idx_off", "idx_len",
                 "aux_off", "aux_len", "ttype", "version")

    def __init__(self, raw: bytes) -> None:
        (self.props_off, self.props_len, self.idx_off, self.idx_len,
         self.aux_off, self.aux_len, self.ttype,
         self.version) = FOOTER.unpack(raw)


def _read_meta(device: BlockDevice, fid: int, off: int, ln: int,
               cls: IOClass, version: int) -> bytes:
    """Read + (for v2) unwrap one metadata block."""
    raw = device.read(fid, off, ln, cls)
    if version:
        raw, _ = decode_block(raw, stats=device.block_stats, fid=fid,
                              offset=off, device=device)
    return raw


class KTableReader:
    """Reader for kSSTs (BTable and DTable).

    The ``cls`` argument of each method attributes the I/O: foreground gets
    pass USER_READ, GC validity checks pass GC_LOOKUP (the paper's
    GC-Lookup step), compaction passes COMPACTION_READ.
    """

    def __init__(self, device: BlockDevice, fid: int, cache: BlockCache,
                 open_cls: IOClass = IOClass.USER_READ) -> None:
        self.device = device
        self.fid = fid
        self.cache = cache
        fsize = device.size(fid)
        foot = _Footer(device.read(fid, fsize - FOOTER.size, FOOTER.size, open_cls))
        self.ttype = foot.ttype
        self.version = foot.version
        idx = msgpack.unpackb(
            _read_meta(device, fid, foot.idx_off, foot.idx_len, open_cls,
                       self.version), raw=False, strict_map_key=False)
        self.data_idx = [(bytes(a), bytes(b), c, d) for a, b, c, d in idx["data"]]
        self.idxe_idx = [(bytes(a), bytes(b), c, d) for a, b, c, d in idx["idxe"]]
        aux = msgpack.unpackb(
            _read_meta(device, fid, foot.aux_off, foot.aux_len, open_cls,
                       self.version), raw=False, strict_map_key=False)
        self.bloom_d = decode_filter(aux["bloom_d"])
        self.bloom_i = decode_filter(aux["bloom_i"])
        self.props = msgpack.unpackb(
            _read_meta(device, fid, foot.props_off, foot.props_len, open_cls,
                       self.version), raw=False, strict_map_key=False)

    # -- block access ---------------------------------------------------
    def _load_block(self, off: int, ln: int, cls: IOClass,
                    high_priority: bool) -> List[Entry]:
        ckey = (self.fid, off)
        blk = self.cache.get(ckey)
        if blk is None:
            raw = self.device.read(self.fid, off, ln, cls)
            if self.version:
                # Cache the *decoded* block, charge the compressed size.
                blk, _ = decode_block(raw, stats=self.device.block_stats,
                                      fid=self.fid, offset=off,
                                      device=self.device)
            else:
                blk = raw
            self.cache.put(ckey, blk, high_priority=high_priority,
                           charge=len(raw))
        else:
            self.device.charge_cpu()
        return _unpack_entries_block(blk)

    @staticmethod
    def _find_block(index: List[Tuple[bytes, bytes, int, int]],
                    ukey: bytes) -> Optional[Tuple[int, int]]:
        lasts = [e[1] for e in index]
        i = bisect_left(lasts, ukey)
        if i >= len(index):
            return None
        first, _, off, ln = index[i]
        if ukey < first:
            # Key falls in the gap between block i-1's last key and block
            # i's first key: no block can contain it.  Reading block i
            # anyway would waste a device read and pollute the cache.
            return None
        return (off, ln)

    def _get_in(self, index: List[Tuple[bytes, bytes, int, int]],
                bloom, ukey: bytes, cls: IOClass,
                high_priority: bool,
                max_seq: Optional[int] = None) -> Optional[Entry]:
        bs = self.device.block_stats
        if bloom is not None:
            bs.filter_probes += 1
            if not bloom.may_contain(ukey):
                # Negative lookup answered with zero device hops.
                bs.filter_negatives += 1
                self.device.charge_cpu()
                return None
        lasts = [e[1] for e in index]
        i = bisect_left(lasts, ukey)
        if i >= len(index) or ukey < index[i][0]:
            # Gap between block i-1's last key and block i's first: no
            # block can contain the key; skip the wasted read.
            if bloom is not None and max_seq is None:
                bs.filter_false_pos += 1
            return None
        best: Optional[Entry] = None
        while True:
            _, _, off, ln = index[i]
            entries = self._load_block(off, ln, cls, high_priority)
            for e in entries:
                if e[0] == ukey and (max_seq is None or e[1] <= max_seq) \
                        and (best is None or e[1] > best[1]):
                    best = e
            if best is not None or max_seq is None:
                break
            # Snapshot probe: the bisect lands on the block holding the
            # key's NEWEST versions; with a seq bound, older (visible)
            # duplicates may spill into following blocks.
            i += 1
            if i >= len(index) or index[i][0] != ukey:
                break
        if best is None and bloom is not None and max_seq is None:
            bs.filter_false_pos += 1
        return best

    def get(self, ukey: bytes, cls: IOClass = IOClass.USER_READ,
            max_seq: Optional[int] = None) -> Optional[Entry]:
        """Newest entry for ``ukey`` (optionally with ``seq <= max_seq``
        for snapshot reads)."""
        if self.ttype == TABLE_DTABLE:
            # Index-entry section first (it holds KA/KF entries, which is
            # what both GC-Lookup and large-value foreground reads want),
            # then the small-KV data section.
            e1 = self._get_in(self.idxe_idx, self.bloom_i, ukey, cls, True,
                              max_seq)
            e2 = self._get_in(self.data_idx, self.bloom_d, ukey, cls, False,
                              max_seq)
            if e1 is None:
                return e2
            if e2 is None:
                return e1
            return e1 if e1[1] >= e2[1] else e2
        return self._get_in(self.data_idx, self.bloom_d, ukey, cls, False,
                            max_seq)

    def get_index_entry(self, ukey: bytes,
                        cls: IOClass = IOClass.GC_LOOKUP) -> Optional[Entry]:
        """GC-Lookup fast path: DTable probes only index-entry blocks
        (cached high-priority); BTable must fall back to full get —
        exactly the I/O asymmetry measured in Fig. 9/19."""
        if self.ttype == TABLE_DTABLE:
            return self._get_in(self.idxe_idx, self.bloom_i, ukey, cls, True)
        return self.get(ukey, cls)

    def iter_entries(self, cls: IOClass = IOClass.COMPACTION_READ) -> Iterator[Entry]:
        """Full-table scan with sequential readahead: the whole section is
        fetched in one device read (RocksDB compaction_readahead), charged
        to ``cls`` and bypassing the block cache."""
        if self.ttype == TABLE_DTABLE:
            a = self._scan_section(self.data_idx, cls)
            b = self._scan_section(self.idxe_idx, cls)
            yield from _merge_sorted(a, b)
        else:
            yield from self._scan_section(self.data_idx, cls)

    def _scan_section(self, index, cls: IOClass) -> Iterator[Entry]:
        if not index:
            return
        start = index[0][2]
        end = index[-1][2] + index[-1][3]
        buf = self.device.read(self.fid, start, end - start, cls)
        if self.version:
            for _, payload in iter_blocks(
                    buf, stats=self.device.block_stats, fid=self.fid,
                    base_offset=start, device=self.device):
                yield from _unpack_entries_block(payload)
        else:
            yield from _unpack_entries_block(buf)

    def _iter_section(self, index, cls: IOClass, hp: bool) -> Iterator[Entry]:
        for _, _, off, ln in index:
            yield from self._load_block(off, ln, cls, hp)

    def iter_from(self, start: bytes,
                  cls: IOClass = IOClass.USER_READ) -> Iterator[Entry]:
        """Seek-and-scan: skip blocks wholly before ``start``."""
        def section(index, hp: bool) -> Iterator[Entry]:
            lasts = [e[1] for e in index]
            i = bisect_left(lasts, start)
            for _, _, off, ln in index[i:]:
                for e in self._load_block(off, ln, cls, hp):
                    if e[0] >= start:
                        yield e
        if self.ttype == TABLE_DTABLE:
            yield from _merge_sorted(section(self.data_idx, False),
                                     section(self.idxe_idx, True))
        else:
            yield from section(self.data_idx, False)


def _merge_sorted(a: Iterator[Entry], b: Iterator[Entry]) -> Iterator[Entry]:
    """Merge two per-table sorted entry streams (ukey asc, seq desc)."""
    ea = next(a, None)
    eb = next(b, None)
    while ea is not None or eb is not None:
        if eb is None or (ea is not None and
                          (ea[0], -ea[1]) <= (eb[0], -eb[1])):
            yield ea  # type: ignore[misc]
            ea = next(a, None)
        else:
            yield eb
            eb = next(b, None)


class RTableReader:
    """Reader for RTable vSSTs: dense partitioned index → lazy value reads.

    v2 additions: a key-set Bloom filter answers negative lookups with zero
    device hops, and decoded value records read on behalf of USER_READ are
    admitted to the shared cache (ghost-gated, low priority) — separated
    reads on the flagship format used to bypass the cache entirely.
    """

    def __init__(self, device: BlockDevice, fid: int, cache: BlockCache,
                 open_cls: IOClass = IOClass.USER_READ) -> None:
        self.device = device
        self.fid = fid
        self.cache = cache
        fsize = device.size(fid)
        foot = _Footer(device.read(fid, fsize - FOOTER.size, FOOTER.size, open_cls))
        self.version = foot.version
        top = msgpack.unpackb(
            _read_meta(device, fid, foot.idx_off, foot.idx_len, open_cls,
                       self.version), raw=False, strict_map_key=False)
        self.top = [(bytes(k), off, ln) for k, off, ln in top]
        self.filter = None
        if self.version and foot.aux_len:
            self.filter = decode_filter(
                _read_meta(device, fid, foot.aux_off, foot.aux_len, open_cls,
                           self.version))
        self.props = msgpack.unpackb(
            _read_meta(device, fid, foot.props_off, foot.props_len, open_cls,
                       self.version), raw=False, strict_map_key=False)

    def _payload(self, raw: bytes, off: int) -> bytes:
        if not self.version:
            return raw
        payload, _ = decode_block(raw, stats=self.device.block_stats,
                                  fid=self.fid, offset=off,
                                  device=self.device)
        return payload

    def _load_partition(self, off: int, ln: int, cls: IOClass
                        ) -> List[Tuple[bytes, int, int]]:
        ckey = (self.fid, off)
        blk = self.cache.get(ckey)
        if blk is None:
            raw = self.device.read(self.fid, off, ln, cls)
            blk = self._payload(raw, off)
            self.cache.put(ckey, blk, high_priority=True, charge=len(raw))
        else:
            self.device.charge_cpu()
        return [(bytes(k), o, l) for k, o, l in msgpack.unpackb(blk, raw=False, strict_map_key=False)]

    def read_keys(self, cls: IOClass = IOClass.GC_READ
                  ) -> List[Tuple[bytes, int, int]]:
        """GC-Read step 1 under Lazy Read: fetch the dense index only —
        all keys + record addresses, no value bytes (paper Fig. 8b).
        Partitions are contiguous, so this is one sequential read."""
        if not self.top:
            return []
        start = self.top[0][1]
        end = self.top[-1][1] + self.top[-1][2]
        buf = self.device.read(self.fid, start, end - start, cls)
        out: List[Tuple[bytes, int, int]] = []
        pos = 0
        for _, off, ln in self.top:
            chunk = buf[pos:pos + ln]
            pos += ln
            part = msgpack.unpackb(self._payload(chunk, off), raw=False,
                                   strict_map_key=False)
            out.extend((bytes(k), o, l) for k, o, l in part)
        return out

    def read_record(self, off: int, ln: int,
                    cls: IOClass = IOClass.USER_READ) -> Tuple[bytes, bytes]:
        # Foreground value reads go through the shared cache (admission is
        # ghost-gated inside the cache core); background GC/compaction
        # reads stay uncached so one GC pass cannot flush the working set.
        use_cache = cls == IOClass.USER_READ
        ckey = (self.fid, off)
        if use_cache:
            blk = self.cache.get(ckey)
            if blk is not None:
                self.device.charge_cpu()
                k, v, _ = decode_record(blk, 0)
                return k, v
        raw = self.device.read(self.fid, off, ln, cls)
        blk = self._payload(raw, off)
        if use_cache:
            self.cache.put(ckey, blk, charge=len(raw))
        k, v, _ = decode_record(blk, 0)
        return k, v

    def read_span(self, off: int, ln: int,
                  cls: IOClass = IOClass.GC_READ) -> List[Tuple[bytes, bytes]]:
        """One coalesced read covering several contiguous records —
        the adaptive-readahead primitive (paper III-B.4)."""
        buf = self.device.read(self.fid, off, ln, cls)
        out = []
        if self.version:
            for _, payload in iter_blocks(
                    buf, stats=self.device.block_stats, fid=self.fid,
                    base_offset=off, device=self.device):
                k, v, _ = decode_record(payload, 0)
                out.append((k, v))
        else:
            pos = 0
            while pos < len(buf):
                k, v, pos = decode_record(buf, pos)
                out.append((k, v))
        return out

    def get(self, ukey: bytes, cls: IOClass = IOClass.USER_READ
            ) -> Optional[bytes]:
        bs = self.device.block_stats
        if self.filter is not None:
            bs.vsst_filter_probes += 1
            if not self.filter.may_contain(ukey):
                bs.vsst_filter_negatives += 1
                self.device.charge_cpu()
                return None
        user = cls == IOClass.USER_READ
        lasts = [t[0] for t in self.top]
        i = bisect_left(lasts, ukey)
        if i < len(self.top):
            part = self._load_partition(self.top[i][1], self.top[i][2], cls)
            keys = [p[0] for p in part]
            j = bisect_left(keys, ukey)
            if j < len(part) and part[j][0] == ukey:
                if user:
                    bs.vsst_probe_hits += 1
                _, off, ln = part[j]
                return self.read_record(off, ln, cls)[1]
        if user:
            bs.vsst_probe_misses += 1
        if self.filter is not None:
            bs.vsst_filter_false_pos += 1
        return None


class VBTableReader:
    """Reader for BTable-layout vSSTs (sparse index, block reads)."""

    def __init__(self, device: BlockDevice, fid: int, cache: BlockCache,
                 open_cls: IOClass = IOClass.USER_READ) -> None:
        self.device = device
        self.fid = fid
        self.cache = cache
        fsize = device.size(fid)
        foot = _Footer(device.read(fid, fsize - FOOTER.size, FOOTER.size, open_cls))
        self.version = foot.version
        idx = msgpack.unpackb(
            _read_meta(device, fid, foot.idx_off, foot.idx_len, open_cls,
                       self.version), raw=False, strict_map_key=False)
        self.sparse = [(bytes(a), bytes(b), c, d) for a, b, c, d in idx]
        self.filter = None
        if self.version and foot.aux_len:
            self.filter = decode_filter(
                _read_meta(device, fid, foot.aux_off, foot.aux_len, open_cls,
                           self.version))
        self.props = msgpack.unpackb(
            _read_meta(device, fid, foot.props_off, foot.props_len, open_cls,
                       self.version), raw=False, strict_map_key=False)

    def _load_block(self, off: int, ln: int, cls: IOClass
                    ) -> List[Tuple[bytes, bytes]]:
        ckey = (self.fid, off)
        blk = self.cache.get(ckey)
        if blk is None:
            raw = self.device.read(self.fid, off, ln, cls)
            if self.version:
                blk, _ = decode_block(raw, stats=self.device.block_stats,
                                      fid=self.fid, offset=off,
                                      device=self.device)
            else:
                blk = raw
            self.cache.put(ckey, blk, charge=len(raw))
        else:
            self.device.charge_cpu()
        out = []
        pos = 0
        while pos < len(blk):
            k, v, pos = decode_record(blk, pos)
            out.append((k, v))
        return out

    def get(self, ukey: bytes, cls: IOClass = IOClass.USER_READ
            ) -> Optional[bytes]:
        bs = self.device.block_stats
        if self.filter is not None:
            bs.vsst_filter_probes += 1
            if not self.filter.may_contain(ukey):
                bs.vsst_filter_negatives += 1
                self.device.charge_cpu()
                return None
        user = cls == IOClass.USER_READ
        lasts = [e[1] for e in self.sparse]
        i = bisect_left(lasts, ukey)
        if i < len(self.sparse):
            for k, v in self._load_block(self.sparse[i][2],
                                         self.sparse[i][3], cls):
                if k == ukey:
                    if user:
                        bs.vsst_probe_hits += 1
                    return v
        if user:
            bs.vsst_probe_misses += 1
        if self.filter is not None:
            bs.vsst_filter_false_pos += 1
        return None

    def scan_all(self, cls: IOClass = IOClass.GC_READ
                 ) -> List[Tuple[bytes, bytes]]:
        """GC-Read without lazy read: the whole data region is fetched
        (sequentially — but including every invalid value, which is the
        deficiency Lazy Read removes)."""
        if not self.sparse:
            return []
        end = self.sparse[-1][2] + self.sparse[-1][3]
        buf = self.device.read(self.fid, 0, end, cls)
        out = []
        if self.version:
            for _, payload in iter_blocks(
                    buf, stats=self.device.block_stats, fid=self.fid,
                    base_offset=0, device=self.device):
                pos = 0
                while pos < len(payload):
                    k, v, pos = decode_record(payload, pos)
                    out.append((k, v))
        else:
            pos = 0
            while pos < len(buf):
                k, v, pos = decode_record(buf, pos)
                out.append((k, v))
        return out


class LogTableReader:
    """Reader for unordered value logs (Titan/WiscKey)."""

    def __init__(self, device: BlockDevice, fid: int) -> None:
        self.device = device
        self.fid = fid

    def read_record(self, off: int, ln: int,
                    cls: IOClass = IOClass.USER_READ) -> Tuple[bytes, bytes]:
        buf = self.device.read(self.fid, off, ln, cls)
        k, v, _ = decode_record(buf, 0)
        return k, v

    def scan_all(self, cls: IOClass = IOClass.GC_READ
                 ) -> List[Tuple[bytes, bytes, int, int]]:
        buf = self.device.read_all(self.fid, cls)
        out = []
        pos = 0
        while pos < len(buf):
            start = pos
            k, v, pos = decode_record(buf, pos)
            out.append((k, v, start, pos - start))
        return out
