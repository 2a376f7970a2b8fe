"""Garbage collection strategies (paper Sections II-B, II-D.1, III-B).

Four designs are implemented behind one interface:

* **titan** (WiscKey/Titan): scan the whole blob file (Read), point-query
  the index for each key comparing addresses (GC-Lookup), rewrite valid
  records (Write), then write the new addresses back through the LSM write
  path (Write-Index) — the 4-step workflow of Fig. 2.
* **terark** (TerarkDB): KF index + file-number *inheritance* mapping — no
  Write-Index; BTable vSSTs mean Read still fetches every data block.
* **scavenger(+)**: RTable dense index → **Lazy Read** (keys first, values
  only for proven-valid records); batch GC-Lookup builds a **valid bitmap**;
  **adaptive readahead** coalesces contiguous valid runs into single reads
  (Fig. 10); DropCache-driven **hot/cold output splitting**.
* **blobdb** is not here — its compaction-triggered rewriting lives in
  ``compaction.execute_compaction``.

Every step charges its dedicated IOClass so Fig. 4's latency breakdown
falls out of the device stats.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ..store.device import IOClass
from ..store.format import (VT_INDEX_KA, VT_INDEX_KF, VT_VALUE, decode_ka,
                            decode_kf, encode_ka)
from ..store.tables import LogTableWriter
from .version import VSSTMeta


def pick_gc_candidate(db, forced: bool = False) -> Optional[VSSTMeta]:
    """Greedy max-garbage-ratio file selection (paper II-B / III-B.3).

    Standalone GC triggers when the *global* garbage ratio exceeds R_G
    (TerarkDB policy); ``forced`` (space-cap stall) picks the best file
    regardless of the global trigger.

    MVCC gate (Titan's oldest-snapshot rule): while any snapshot bound
    is registered, GC admits nothing — both GC flavors delete the victim
    vSST, and a snapshot-retained index entry may still address records
    in it.  Snapshot release sets ``_gc_check_pending`` so the deferred
    work is re-offered at the next scheduling tick.
    """
    if db.snapshots.active:
        return None
    vs = db.versions
    cands = [m for m in vs.vssts.values()
             if not m.being_gc and not m.pending_delete and m.num_entries > 0]
    if not cands:
        return None
    best = max(cands, key=lambda m: m.garbage_ratio)
    # Fully-dead files (live bytes exhausted) are always eligible — with
    # KF-mode estimated accounting they must be *validated* by GC rather
    # than blindly deleted (see db.retire_vsst).
    if best.garbage_ratio >= 0.999:
        return best
    if not forced and vs.global_garbage_ratio() <= db.opts.garbage_ratio:
        return None
    if not forced and best.garbage_ratio <= db.opts.garbage_ratio:
        return None
    if forced and best.garbage_ratio <= 0.0:
        return None
    return best


# ---------------------------------------------------------------------------
# Titan-style GC (KA addressing, unordered blob files, index write-back)
# ---------------------------------------------------------------------------

def run_gc_titan(db, victim: VSSTMeta) -> Callable[[], None]:
    opts = db.opts
    vs = db.versions
    victim.being_gc = True

    # (1) Read: sequential scan of the whole blob file.
    records = db.log_reader(victim.fid).scan_all(IOClass.GC_READ)

    # (2) GC-Lookup: validity = stored address equals scanned position.
    valid: List[Tuple[bytes, bytes, bytes]] = []   # (+ the KA we validated)
    for ukey, value, off, ln in records:
        e = db.get_entry(ukey, IOClass.GC_LOOKUP)
        if e is not None and e[2] == VT_INDEX_KA:
            vfid, voff, _ = decode_ka(e[3])
            if vfid == victim.fid and voff == off:
                valid.append((ukey, value, e[3]))

    # (3) Write: rewrite valid records into new blob files.  Records the
    # placement engine wants back inline (small/cold under the current
    # effective threshold) skip the blob write entirely and ride the
    # Write-Index step as plain VT_VALUE entries — the sep->inline
    # migration riding the rewrite GC was doing anyway.
    new_metas: List[VSSTMeta] = []
    # (key, old KA, vtype, payload-or-value): KA write-back or reattach
    writeback: List[Tuple[bytes, bytes, int, bytes]] = []
    writer: Optional[LogTableWriter] = None
    wfid: Optional[int] = None

    def _seal() -> None:
        nonlocal writer, wfid
        if writer is not None and writer.num_entries:
            new_metas.append(db.finish_vsst(writer, IOClass.GC_WRITE,
                                            fid=wfid))
        writer, wfid = None, None

    for ukey, value, old_ka in valid:
        if db.placement.want_inline_on_gc(ukey, len(value)):
            writeback.append((ukey, old_ka, VT_VALUE, value))
            continue
        if writer is None or writer.estimated_bytes >= opts.vsst_bytes:
            _seal()
            wfid = db.device.create()
            writer = LogTableWriter(db.device)
        off, ln = writer.add(ukey, value)
        writeback.append((ukey, old_ka, VT_INDEX_KA,
                          encode_ka(wfid, off, ln, raw=len(value))))
    _seal()

    def effects(elapsed: float = 0.0) -> None:
        # (4) Write-Index: push new addresses (or reattached inline
        # values) through the normal write path (WAL + memtable), charged
        # as GC_WRITE_INDEX.  A key whose memtable entry changed
        # *relative to the validated address* is skipped (Titan's
        # WriteCallback sequence check); a skipped blob move's bytes
        # become garbage in the new blob immediately, a skipped reattach
        # simply wrote nothing.
        moved: dict = {}
        for m in new_metas:
            moved[m.fid] = m
        reattached = 0
        for ukey, old_ka, vtype, payload in writeback:
            if vtype == VT_VALUE:
                # Reattached live bytes left the value store but were not
                # garbage — keep them out of the collected total below.
                reattached += len(payload)
            cur = db.mem_lookup(ukey)
            if cur is not None and not (cur[1] == VT_INDEX_KA
                                        and cur[2] == old_ka):
                if vtype == VT_INDEX_KA:
                    nfid, _, nln = decode_ka(payload)
                    nm = moved.get(nfid)
                    if nm is not None:
                        nm.live_value_bytes = max(
                            0, nm.live_value_bytes
                            - max(0, nln - len(ukey) - 2))
                continue
            db.write_index_entry(ukey, vtype, payload,
                                 IOClass.GC_WRITE_INDEX)
            if vtype == VT_VALUE:
                db.placement.note_migration(False, len(payload))
        rewritten = sum(m.total_value_bytes for m in new_metas)
        db.placement.note_gc(rewritten,
                             victim.total_value_bytes - rewritten
                             - reattached)
        vs.log_and_apply({"add_vsst": new_metas, "del_vsst": [victim.fid]})
        db.drop_table(victim.fid)
        db.stats_counters["gc_runs"] += 1
        db.after_background()

    return effects


# ---------------------------------------------------------------------------
# TerarkDB-style GC and the Scavenger+ ladder (KF + inheritance)
# ---------------------------------------------------------------------------

def _is_valid_kf(db, ukey: bytes, victim_fid: int) -> bool:
    """A record scanned out of ``victim_fid`` is live iff the key's newest
    index entry resolves into the victim's lookup *group* (group members
    hold disjoint key sets, so group membership pins the physical copy)."""
    e = db.get_entry(ukey, IOClass.GC_LOOKUP)
    if e is None or e[2] != VT_INDEX_KF:
        return False
    fid, _ = decode_kf(e[3])
    return db.versions.same_group(db.versions.resolve_vsst(fid), victim_fid)


def run_gc_terark(db, victim: VSSTMeta) -> Callable[[], None]:
    """Shared implementation for terark / scavenger / scavenger+; feature
    flags select the I/O plan:

    - vsst_format == 'btable'  → Read = full block scan, no lazy read;
    - vsst_format == 'rtable'  → Lazy Read (keys from dense index, values
      on demand), optionally with adaptive readahead;
    - dropcache                → hot/cold output splitting.
    """
    opts = db.opts
    vs = db.versions
    victim.being_gc = True
    lazy = (victim.fmt == "rtable")

    valid: List[Tuple[bytes, bytes]] = []
    if not lazy:
        # Classic GC-Read: whole-file block scan, then per-key lookup.
        records = db.vb_reader(victim.fid).scan_all(IOClass.GC_READ)
        for ukey, value in records:
            if _is_valid_kf(db, ukey, victim.fid):
                valid.append((ukey, value))
    else:
        reader = db.r_reader(victim.fid)
        # Lazy Read step 1: dense index only — keys + record addresses.
        keyidx = reader.read_keys(IOClass.GC_READ)
        # Batch GC-Lookup → valid bitmap (paper III-B.4).
        bitmap = [_is_valid_kf(db, k, victim.fid) for k, _, _ in keyidx]
        if opts.adaptive_readahead:
            # Coalesce contiguous valid runs into single span reads.
            i, n = 0, len(keyidx)
            while i < n:
                if not bitmap[i]:
                    i += 1
                    continue
                j = i
                while j + 1 < n and bitmap[j + 1] and \
                        keyidx[j + 1][1] == keyidx[j][1] + keyidx[j][2]:
                    j += 1
                span_off = keyidx[i][1]
                span_len = keyidx[j][1] + keyidx[j][2] - span_off
                valid.extend(reader.read_span(span_off, span_len,
                                              IOClass.GC_READ))
                i = j + 1
        else:
            for ok, (k, off, ln) in zip(bitmap, keyidx):
                if ok:
                    valid.append(reader.read_record(off, ln, IOClass.GC_READ))

    # Placement migration (sep->inline), riding the rewrite: records the
    # engine wants back under the boundary re-enter the index tree as
    # VT_VALUE entries through the write path (new seq shadows the old
    # KF entry; the victim's copy dies with the victim).  The stale KF
    # entry's eventual compaction drop decrements the *successor's* live
    # counter — the same clamped-at-0 estimation error the hot/cold
    # split already tolerates in KF accounting.
    reattached_bytes = 0
    if opts.adaptive_placement and valid:
        kept: List[Tuple[bytes, bytes]] = []
        for ukey, value in valid:
            if db.placement.want_inline_on_gc(ukey, len(value)):
                db.write_index_entry(ukey, VT_VALUE, value,
                                     IOClass.GC_WRITE_INDEX)
                db.placement.note_migration(False, len(value))
                reattached_bytes += len(value)
            else:
                kept.append((ukey, value))
        valid = kept

    # Write: rewrite valid records, split hot/cold when DropCache is on.
    new_metas: List[VSSTMeta] = []

    def _write_group(records: List[Tuple[bytes, bytes]], hot: bool) -> None:
        writer = None
        wfid = None
        for ukey, value in records:
            if writer is None or writer.estimated_bytes >= opts.vsst_bytes:
                if writer is not None and writer.num_entries:
                    new_metas.append(db.finish_vsst(
                        writer, IOClass.GC_WRITE, fid=wfid, is_hot=hot))
                wfid = db.device.create()
                writer = db.new_vsst_writer()
            writer.add(ukey, value)
        if writer is not None and writer.num_entries:
            new_metas.append(db.finish_vsst(writer, IOClass.GC_WRITE,
                                            fid=wfid, is_hot=hot))

    if opts.dropcache:
        hot = [(k, v) for k, v in valid if db.dropcache.is_hot(k)]
        cold = [(k, v) for k, v in valid if not db.dropcache.is_hot(k)]
        _write_group(hot, True)
        _write_group(cold, False)
    else:
        _write_group(valid, False)

    def effects(elapsed: float = 0.0) -> None:
        # Inheritance (Fig. 1(c) triangle): the victim's file number
        # redirects to the first successor — no index write-back.  The
        # outputs join the victim's lookup group; garbage-byte accounting
        # for later entry drops lands on the resolved primary (estimation
        # error across hot/cold siblings is tolerated, clamped at 0).
        edit = {"add_vsst": new_metas, "del_vsst": [victim.fid],
                "regroup": [(victim.fid, [m.fid for m in new_metas])]}
        if new_metas:
            edit["inherit"] = [(victim.fid, new_metas[0].fid)]
        rewritten = sum(m.total_value_bytes for m in new_metas)
        db.placement.note_gc(
            rewritten, victim.total_value_bytes - rewritten
            - reattached_bytes)
        vs.log_and_apply(edit)
        db.drop_table(victim.fid)
        db.stats_counters["gc_runs"] += 1
        db.after_background()

    return effects
