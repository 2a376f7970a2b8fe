"""File metadata, LSM version set and the manifest log.

The version set tracks two populations of files:

* **kSSTs** — index-LSM-tree tables arranged in levels (L0 overlapping,
  L1+ key-disjoint), carrying ``compensated_bytes`` and the kSST→vSST
  ``value_refs`` dependency map;
* **vSSTs / blob files** — value stores with ``total/live`` byte
  accounting, hot/cold tags, and the TerarkDB-style *inheritance* map that
  redirects stale file numbers to their GC descendants.

Every topology change is logged to a manifest file so the store recovers
its structure after a crash (WAL replay restores the memtable on top).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import msgpack

from ..store.device import BlockDevice, IOClass


@dataclasses.dataclass
class FileMeta:
    """kSST metadata."""
    fid: int
    level: int
    smallest: bytes
    largest: bytes
    file_size: int
    num_entries: int
    compensated_bytes: int
    value_refs: Dict[int, Tuple[int, int]]  # vsst -> (entries, bytes)
    table_type: int
    being_compacted: bool = False

    def effective_size(self, compensated: bool) -> int:
        return self.compensated_bytes if compensated else self.file_size


@dataclasses.dataclass
class VSSTMeta:
    """Value-store file metadata (vSST / blob / vLog)."""
    fid: int
    file_size: int
    total_value_bytes: int
    live_value_bytes: int
    num_entries: int
    fmt: str                      # 'log' | 'btable' | 'rtable'
    is_hot: bool = False
    being_gc: bool = False
    pending_delete: bool = False

    @property
    def garbage_ratio(self) -> float:
        if self.total_value_bytes <= 0:
            return 1.0
        return 1.0 - self.live_value_bytes / self.total_value_bytes


class VersionSet:
    def __init__(self, device: BlockDevice, num_levels: int,
                 manifest_fid: Optional[int] = None) -> None:
        self.device = device
        self.num_levels = num_levels
        self.levels: List[List[FileMeta]] = [[] for _ in range(num_levels)]
        self.vssts: Dict[int, VSSTMeta] = {}
        self.inheritance: Dict[int, int] = {}   # old vSST fid -> successor
        # Lookup groups: every vSST belongs to a group; GC replaces the
        # victim with its outputs *within the same group*.  Group members
        # hold pairwise-disjoint key sets (outputs partition the victim's
        # records), so a key lives in at most one member — the invariant
        # that makes hot/cold-split GC lookups correct.
        self.group_of: Dict[int, int] = {}      # fid -> gid (kept forever)
        self.group_members: Dict[int, List[int]] = {}  # gid -> live fids
        self.seq = 0
        # Newest global commit sequence number (CSN) this shard has
        # persisted (stamped into "wal"-open and flush edits).  WAL
        # segments are deleted after flush, so the manifest is the CSN's
        # durable floor; recovery takes max(manifest, segment stamps).
        self.csn = 0
        self.active_wal: Optional[int] = None
        self.pending_wals: List[int] = []       # logged but not yet flushed
        self.manifest_fid = (device.create() if manifest_fid is None
                             else manifest_fid)

    # ------------------------------------------------------------------
    def resolve_vsst(self, fid: int) -> int:
        """Follow the inheritance chain to the current holder of a file
        number (TerarkDB triangle in Fig. 1(c)); path-compresses."""
        seen = []
        while fid in self.inheritance:
            seen.append(fid)
            fid = self.inheritance[fid]
        for s in seen[:-1]:
            self.inheritance[s] = fid
        return fid

    def ksst_files(self) -> Iterable[FileMeta]:
        for lvl in self.levels:
            yield from lvl

    # -- size / amplification accounting (paper eqs. 1-3) ---------------
    def index_level_sizes(self) -> List[int]:
        return [sum(f.file_size for f in lvl) for lvl in self.levels]

    def s_index(self) -> float:
        sizes = self.index_level_sizes()
        nonempty = [i for i, s in enumerate(sizes) if s > 0]
        if not nonempty:
            return 1.0
        last = nonempty[-1]
        k_l = sizes[last]
        k_u = sum(sizes[:last])
        return (k_u + k_l) / k_l if k_l else 1.0

    def num_nonempty_levels(self) -> int:
        return sum(1 for s in self.index_level_sizes() if s > 0)

    def value_stats(self) -> Tuple[int, int]:
        """(total_value_bytes, live_value_bytes) over non-deleted vSSTs."""
        tot = live = 0
        for m in self.vssts.values():
            if not m.pending_delete:
                tot += m.total_value_bytes
                live += m.live_value_bytes
        return tot, live

    def exposed_ratio(self) -> float:
        """G_E / D as visible to the engine (live bytes include hidden
        garbage — the oracle in bench/ separates the two)."""
        tot, live = self.value_stats()
        return (tot - live) / live if live > 0 else 0.0

    def global_garbage_ratio(self) -> float:
        tot, live = self.value_stats()
        return (tot - live) / tot if tot > 0 else 0.0

    # -- edits -----------------------------------------------------------
    def log_edit(self, edit: dict) -> None:
        blob = msgpack.packb(edit, use_bin_type=True)
        self.device.append(self.manifest_fid,
                           len(blob).to_bytes(4, "little") + blob,
                           IOClass.MANIFEST)

    def apply_edit(self, edit: dict, log: bool = True) -> None:
        if log:
            self.log_edit(edit)
        for lvl, meta in edit.get("add_ksst", []):
            self.levels[lvl].append(meta)
            if lvl > 0:
                self.levels[lvl].sort(key=lambda f: f.smallest)
            else:
                self.levels[0].sort(key=lambda f: -f.fid)   # newest first
        for fid in edit.get("del_ksst", []):
            for lvl in self.levels:
                for i, f in enumerate(lvl):
                    if f.fid == fid:
                        del lvl[i]
                        break
        for meta in edit.get("add_vsst", []):
            self.vssts[meta.fid] = meta
            if meta.fid not in self.group_of:       # singleton group
                self.group_of[meta.fid] = meta.fid
                self.group_members[meta.fid] = [meta.fid]
        for old, new in edit.get("inherit", []):
            self.inheritance[old] = new
        for victim, new_fids in edit.get("regroup", []):
            gid = self.group_of[victim]
            members = self.group_members.setdefault(gid, [])
            if victim in members:
                members.remove(victim)
            for nf in new_fids:
                # GC outputs join the victim's group (may move them out of
                # their provisional singleton group).
                old_gid = self.group_of.get(nf)
                if old_gid is not None and old_gid != gid:
                    m = self.group_members.get(old_gid, [])
                    if nf in m:
                        m.remove(nf)
                self.group_of[nf] = gid
                if nf not in members:
                    members.append(nf)
        for fid in edit.get("del_vsst", []):
            self.vssts.pop(fid, None)
            gid = self.group_of.get(fid)
            if gid is not None:
                m = self.group_members.get(gid, [])
                if fid in m:
                    m.remove(fid)
        if "seq" in edit:
            self.seq = max(self.seq, edit["seq"])
        if "csn" in edit:
            self.csn = max(self.csn, edit["csn"])
        if "wal" in edit:
            # A solo store logs one WAL file per memtable; a shard of a
            # sharded store logs every shared commit-log *segment* its
            # memtable has records in (the owning front-end replays those
            # segments, routing records by shard tag).  Dedup so replayed
            # manifests cannot double-queue a segment.
            self.active_wal = edit["wal"]
            if edit["wal"] not in self.pending_wals:
                self.pending_wals.append(edit["wal"])
        if "wal_done" in edit:
            if edit["wal_done"] in self.pending_wals:
                self.pending_wals.remove(edit["wal_done"])

    # -- serialization for manifest recovery ------------------------------
    @staticmethod
    def _meta_to_wire(edit: dict) -> dict:
        out = dict(edit)
        if "add_ksst" in edit:
            out["add_ksst"] = [(lvl, dataclasses.asdict(m))
                               for lvl, m in edit["add_ksst"]]
        if "add_vsst" in edit:
            out["add_vsst"] = [dataclasses.asdict(m) for m in edit["add_vsst"]]
        return out

    def log_and_apply(self, edit: dict) -> None:
        self.log_edit(self._meta_to_wire(edit))
        self.apply_edit(edit, log=False)

    def recover(self) -> None:
        """Rebuild topology by replaying the manifest (crash restart)."""
        buf = self.device.read_all(self.manifest_fid, IOClass.MANIFEST)
        pos = 0
        while pos + 4 <= len(buf):
            ln = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
            if pos + ln > len(buf):
                break                       # torn tail
            edit = msgpack.unpackb(buf[pos:pos + ln], raw=False, strict_map_key=False)
            pos += ln
            if "add_ksst" in edit:
                edit["add_ksst"] = [
                    (lvl, FileMeta(**{**d, "smallest": bytes(d["smallest"]),
                                      "largest": bytes(d["largest"]),
                                      "value_refs": {int(k): tuple(v) for k, v
                                                     in d["value_refs"].items()}}))
                    for lvl, d in edit["add_ksst"]]
            if "add_vsst" in edit:
                edit["add_vsst"] = [VSSTMeta(**d) for d in edit["add_vsst"]]
            self.apply_edit(edit, log=False)

    # -- queries ----------------------------------------------------------
    def lookup_candidates(self, entry_fid: int) -> List[int]:
        """Live vSSTs that may hold a record whose index entry references
        ``entry_fid``: the inheritance-resolved primary first, then its
        group siblings (hot/cold GC outputs)."""
        primary = self.resolve_vsst(entry_fid)
        gid = self.group_of.get(entry_fid, self.group_of.get(primary))
        if gid is None:
            return [primary] if primary in self.vssts else []
        members = self.group_members.get(gid, [])
        out = []
        if primary in self.vssts and primary in members:
            out.append(primary)
        out.extend(m for m in members if m != primary)
        return out

    def same_group(self, fid_a: int, fid_b: int) -> bool:
        ga = self.group_of.get(fid_a)
        gb = self.group_of.get(fid_b)
        return ga is not None and ga == gb

    def overlapping(self, level: int, smallest: bytes, largest: bytes
                    ) -> List[FileMeta]:
        out = []
        for f in self.levels[level]:
            if f.largest >= smallest and f.smallest <= largest:
                out.append(f)
        return out

    def decrement_live(self, vsst_fid: int, nbytes: int, n_entries: int = 1
                       ) -> Optional[VSSTMeta]:
        """An index entry referencing ``vsst_fid`` was dropped during
        compaction: the referenced bytes turn from *hidden* to *exposed*
        garbage.  Resolves inheritance so GC descendants are charged."""
        fid = self.resolve_vsst(vsst_fid)
        meta = self.vssts.get(fid)
        if meta is None:
            return None
        meta.live_value_bytes = max(0, meta.live_value_bytes - nbytes)
        meta.num_entries = meta.num_entries   # entries tracked via live bytes
        return meta
