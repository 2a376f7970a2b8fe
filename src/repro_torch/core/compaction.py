"""Leveled compaction with the paper's space-aware *compensated size*
strategy (Section III-C).

With ``opts.compensated_size`` enabled, level scores and file selection use
``index_bytes + referenced_value_bytes`` — the *logical* size — which makes
the shrunken index LSM-tree behave like a non-separated tree: levels fill
their logical targets, compaction fires at RocksDB-like frequency, and
``S_index`` converges to ``1 + Σ 1/T^i ≈ 1.11`` (Fig. 21(a)).

Dropping a shadowed index entry during a merge is the moment *hidden*
garbage becomes *exposed*: the referenced vSST's live-byte counter is
decremented (via the inheritance map) and the key is recorded in the
DropCache as a write hotspot (Section III-B.3).
"""

from __future__ import annotations

import heapq
from typing import Callable, Iterator, List, Optional, Tuple

from ..store.device import IOClass
from ..store.format import (VT_DELETE, VT_INDEX_KA, VT_INDEX_KF, VT_VALUE,
                            decode_ka, encode_ka, encode_kf,
                            entry_value_size, entry_vsst)
from ..store.tables import Entry, KTableWriter, LogTableWriter
from .version import FileMeta, VersionSet


class CompactionPlan:
    def __init__(self, level: int, inputs_up: List[FileMeta],
                 inputs_down: List[FileMeta], output_level: int) -> None:
        self.level = level
        self.inputs_up = inputs_up
        self.inputs_down = inputs_down
        self.output_level = output_level

    @property
    def all_inputs(self) -> List[FileMeta]:
        return self.inputs_up + self.inputs_down


def level_targets(opts, eff_sizes: List[int]) -> Tuple[List[float], int]:
    """RocksDB dynamic-leveling (DCA) targets, which the paper enables
    (Section II-D.2): the bottom level's target equals its actual size and
    upper-level targets cascade down by 1/T, so a stable tree holds
    ``K_U ≈ K_L·(1/T + 1/T² + …)`` and S_index → 1.11 at T=10.

    Returns (targets, base_level): flushes compact L0 → base_level, the
    shallowest level whose target is at least one level_base.
    """
    t = float(opts.level_multiplier)
    bottom = opts.num_levels - 1
    targets = [0.0] * opts.num_levels
    if not opts.dca:
        # Static cascade (pre-DCA RocksDB / the KV-separated forks): L1
        # holds level_base, each deeper level T× more.  A small (physical)
        # index tree never reaches the upper-level triggers — the paper's
        # delayed-compaction pathology (Fig. 11(b)).
        for i in range(1, opts.num_levels):
            targets[i] = float(opts.level_base_bytes) * t ** (i - 1)
        return targets, 1
    targets[bottom] = float(max(eff_sizes[bottom], opts.level_base_bytes))
    base_level = bottom
    for i in range(bottom - 1, 0, -1):
        targets[i] = targets[i + 1] / t
        if targets[i] >= opts.level_base_bytes / t:
            base_level = i
    return targets, base_level


def compute_scores(vs: VersionSet, opts) -> Tuple[List[float], int]:
    comp = opts.compensated_size
    eff = [sum(f.effective_size(comp) for f in lvl) for lvl in vs.levels]
    targets, base_level = level_targets(opts, eff)
    scores = [0.0] * opts.num_levels
    scores[0] = len([f for f in vs.levels[0] if not f.being_compacted]) \
        / opts.l0_trigger
    floor = opts.level_base_bytes / opts.level_multiplier
    for i in range(1, opts.num_levels - 1):
        avail = sum(f.effective_size(comp) for f in vs.levels[i]
                    if not f.being_compacted)
        scores[i] = avail / max(targets[i], floor)
    return scores, base_level


def plan_compaction(vs: VersionSet, opts) -> Optional[CompactionPlan]:
    scores, base_level = compute_scores(vs, opts)
    order = sorted((i for i in range(len(scores)) if scores[i] >= 1.0),
                   key=lambda i: -scores[i])
    for level in order:
        plan = _try_plan_level(vs, opts, level, base_level)
        if plan is not None:
            return plan
    return None


def _try_plan_level(vs: VersionSet, opts, level: int, base_level: int
                    ) -> Optional[CompactionPlan]:
    if level == 0:
        # Only one L0→base compaction at a time: L0 files overlap, so two
        # concurrent L0 merges would emit overlapping L1 outputs with
        # undefined precedence (RocksDB serializes this too).
        if any(f.being_compacted for f in vs.levels[0]):
            return None
        ups = list(vs.levels[0])
        if not ups:
            return None
    else:
        cands = [f for f in vs.levels[level] if not f.being_compacted]
        if not cands:
            return None
        if opts.compensated_size:
            # paper III-C: pick the file with max compensated size
            pick = max(cands, key=lambda f: f.compensated_bytes)
        else:
            pick = min(cands, key=lambda f: f.fid)   # oldest-first
        ups = [pick]
    smallest = min(f.smallest for f in ups)
    largest = max(f.largest for f in ups)
    if level == 0:
        out_level = base_level          # DCA: L0 compacts straight to base
    else:
        out_level = min(max(level + 1, base_level), opts.num_levels - 1)
    downs = vs.overlapping(out_level, smallest, largest)
    if any(f.being_compacted for f in downs):
        return None
    for f in ups + downs:
        f.being_compacted = True
    return CompactionPlan(level, ups, downs, out_level)


def merge_entries(streams: List[Iterator[Entry]]) -> Iterator[Tuple[Entry, bool]]:
    """Yield (entry, is_newest_version).  Streams must each be sorted by
    (ukey asc, seq desc); the global merge keeps that order."""
    merged = heapq.merge(*streams, key=lambda e: (e[0], -e[1]))
    prev_key: Optional[bytes] = None
    for e in merged:
        newest = e[0] != prev_key
        prev_key = e[0]
        yield e, newest


def execute_compaction(db, plan: CompactionPlan) -> Callable[[], None]:
    """Run the merge (charged to the job clock); return the effects closure.

    BlobDB-mode (``opts.gc_mode == 'compaction'``) additionally rewrites
    values whose blob file crossed the garbage threshold — the paper's
    "GC must wait for compaction" coupling.
    """
    opts = db.opts
    vs = db.versions
    streams = [db.reader(f.fid).iter_entries(IOClass.COMPACTION_READ)
               for f in plan.all_inputs]
    is_last = plan.output_level == opts.num_levels - 1 or not any(
        vs.levels[l] for l in range(plan.output_level + 1, opts.num_levels))

    outputs: List[Tuple[int, dict]] = []
    writer: Optional[KTableWriter] = None
    blob_writer: Optional[LogTableWriter] = None
    blob_fid: Optional[int] = None
    new_blob_metas: List = []
    # Blob rewriting relocates records and can retire the source blob
    # file; while MVCC snapshots are registered, retained older index
    # entries may still address it — defer the rewrite (the garbage
    # survives one compaction; the next one reclaims it).
    rewrite_blobs = (opts.kv_separation and opts.gc_mode == "compaction"
                     and not db.snapshots.active)
    # Adaptive placement: compaction is rewriting every input entry
    # anyway, so inline values that have outgrown the (possibly lowered)
    # effective threshold re-separate here — the inline->sep migration
    # riding the merge, symmetric to GC's reattach.
    resep = opts.kv_separation and opts.adaptive_placement
    sep_writer = None
    sep_fid: Optional[int] = None
    blob_prefetch: dict = {}
    dropped_refs: List[Tuple[int, int]] = []   # (vsst_fid, bytes)

    def _roll() -> None:
        nonlocal writer
        if writer is not None and writer.num_entries:
            fid, props = writer.finish(IOClass.COMPACTION_WRITE)
            outputs.append((fid, props))
        writer = KTableWriter(db.device, opts.block_bytes,
                              dtable=(opts.ksst_format == "dtable"),
                              bits_per_key=opts.bloom_bits(),
                              codec=opts.block_compression,
                              min_ratio=opts.compression_min_ratio,
                              level=plan.output_level)

    _roll()
    assert writer is not None
    kept_vt, kept_pl, kept_seq = -1, b"", 0
    for entry, newest in merge_entries(streams):
        ukey, seq, vtype, payload = entry
        if not newest:
            # An older version is shadowed.  Compactions copy entries
            # between levels, so several instances may reference the SAME
            # physical record — dropping such a duplicate (identical type
            # and payload as the kept version) exposes no garbage.  Only a
            # *real* overwrite (payload differs) turns hidden garbage into
            # exposed garbage and marks the key hot.
            if vtype == kept_vt and payload == kept_pl:
                continue
            # MVCC retention: keep the older version while a registered
            # snapshot bound separates it from its adjacent newer kept
            # version (old.seq <= b < kept.seq means a snapshot at b
            # still reads it).  The retained entry becomes the adjacency
            # reference for the next older version — the pairwise rule
            # composes down the whole version chain.
            if db.snapshots.needs_version(seq, kept_seq):
                kept_vt, kept_pl, kept_seq = vtype, payload, seq
                writer.add(entry)
                if writer.estimated_bytes >= opts.ksst_bytes:
                    _roll()
                continue
            if vtype in (VT_INDEX_KA, VT_INDEX_KF):
                dropped_refs.append((entry_vsst(vtype, payload),
                                     entry_value_size(vtype, payload)))
            db.note_drop(ukey, entry_value_size(vtype, payload))
            continue
        kept_vt, kept_pl, kept_seq = vtype, payload, seq
        if vtype == VT_DELETE and is_last \
                and not db.snapshots.has_bound_below(seq):
            # Dropping a bottom-level tombstone is only safe when no
            # snapshot can still read an older (retained) version of the
            # key below it — otherwise the delete would un-happen.
            continue                               # tombstone reaches bottom
        if rewrite_blobs and vtype == VT_INDEX_KA:
            vfid, off, ln = decode_ka(payload)
            # KA offsets are file-local; BlobDB never moves blobs outside
            # compaction, so vfid is the physical file.
            meta = vs.vssts.get(vfid)
            if meta is not None and meta.garbage_ratio > opts.garbage_ratio:
                # BlobDB prefetches a blob file once per compaction and
                # serves subsequent record reads from the prefetch buffer.
                if vfid not in blob_prefetch:
                    blob_prefetch[vfid] = {
                        o: (k2, v2) for k2, v2, o, _ in
                        db.log_reader(vfid).scan_all(IOClass.COMPACTION_READ)}
                k, v = blob_prefetch[vfid].get(off, (None, None))
                if k is None:       # defensive: torn prefetch
                    k, v = db.log_reader(vfid).read_record(
                        off, ln, IOClass.COMPACTION_READ)
                db.device.charge_cpu()
                if blob_writer is None or \
                        blob_writer.estimated_bytes >= opts.vsst_bytes:
                    if blob_writer is not None and blob_writer.num_entries:
                        new_blob_metas.append(db.finish_vsst(
                            blob_writer, IOClass.COMPACTION_WRITE,
                            fid=blob_fid))
                    blob_fid = db.device.create()
                    blob_writer = LogTableWriter(db.device)
                noff, nlen = blob_writer.add(k, v)
                meta.live_value_bytes = max(
                    0, meta.live_value_bytes - len(v))
                dropped_refs.append((vfid, 0))  # marks ref move; bytes done
                entry = (ukey, seq, vtype,
                         encode_ka(blob_fid, noff, nlen, raw=len(v)))
        if resep and vtype == VT_VALUE and \
                db.placement.want_separate_on_compaction(ukey, len(payload)):
            if sep_writer is None or \
                    sep_writer.estimated_bytes >= opts.vsst_bytes:
                if sep_writer is not None and sep_writer.num_entries:
                    new_blob_metas.append(db.finish_vsst(
                        sep_writer, IOClass.COMPACTION_WRITE, fid=sep_fid))
                sep_fid = db.device.create()
                sep_writer = db.new_vsst_writer()
            off, ln = sep_writer.add(ukey, payload)
            # kept_vt/kept_pl stay the inline original: an identical older
            # inline copy in a deeper level is still a free duplicate
            # (its bytes vanish with the input file, no garbage exposed).
            if opts.index_kind == "ka":
                entry = (ukey, seq, VT_INDEX_KA,
                         encode_ka(sep_fid, off, ln, raw=len(payload)))
            else:
                entry = (ukey, seq, VT_INDEX_KF,
                         encode_kf(sep_fid, len(payload)))
            db.placement.note_migration(True, len(payload))
        ukey, seq, vtype, payload = entry
        writer.add(entry)
        if writer.estimated_bytes >= opts.ksst_bytes:
            _roll()
    if blob_writer is not None and blob_writer.num_entries:
        new_blob_metas.append(db.finish_vsst(blob_writer,
                                             IOClass.COMPACTION_WRITE,
                                             fid=blob_fid))
    if sep_writer is not None and sep_writer.num_entries:
        new_blob_metas.append(db.finish_vsst(sep_writer,
                                             IOClass.COMPACTION_WRITE,
                                             fid=sep_fid))
    if writer.num_entries:
        fid, props = writer.finish(IOClass.COMPACTION_WRITE)
        outputs.append((fid, props))

    input_fids = [f.fid for f in plan.all_inputs]

    def effects(elapsed: float = 0.0) -> None:
        metas = [db.make_ksst_meta(fid, props, plan.output_level)
                 for fid, props in outputs]
        for vfid, nbytes in dropped_refs:
            m = vs.decrement_live(vfid, nbytes)
            if m is not None and m.live_value_bytes == 0 and not m.being_gc:
                db.retire_vsst(m)
        vs.log_and_apply({
            "add_ksst": [(plan.output_level, m) for m in metas],
            "del_ksst": input_fids,
            "add_vsst": new_blob_metas,
        })
        for fid in input_fids:
            db.drop_table(fid)
        tree_bytes = sum(props["file_size"] for _, props in outputs)
        db.placement.note_compaction(tree_bytes)
        db.stats_counters["compactions"] += 1
        db._gc_check_pending = True     # TerarkDB: GC trigger re-evaluated
        db.after_background()           # after each compaction (II-B)

    return effects
