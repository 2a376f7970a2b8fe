"""Quickstart, on the PyTorch port: the paper's engine in 40 lines. The
engine is host code on a simulated clock and holds no tensor, so the script
takes no --device. The stores, the workloads and the lines printed are those
of examples/quickstart.py.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""

from repro_torch.bench import (WorkloadSpec, gen_load, gen_update,
                               make_db, run_phase, space_amplification)

# Scavenger+ vs TerarkDB under the paper's Fixed-8K update workload
spec = WorkloadSpec(value_kind="fixed-8192", dataset_bytes=16 << 20,
                    update_bytes=48 << 20)

for system in ("terarkdb", "scavenger_plus"):
    db = make_db(system, spec)
    run_phase(db, "load", gen_load(spec), drain=True)
    r = run_phase(db, "update", gen_update(spec), drain=True)
    s = db.stats()
    print(f"{system:15s} update={r.kops_per_s:6.1f} kops/s "
          f"space_amp={space_amplification(db):.2f} "
          f"S_index={s['space']['s_index']:.2f} "
          f"gc_runs={s['counters']['gc_runs']:.0f}")

# Basic KV usage
from repro_torch.core import KVStore, preset  # noqa: E402

db = KVStore(preset("scavenger_plus"))
db.put(b"hello", b"world" * 300)        # >512 B → KV-separated
db.put(b"tiny", b"x")                   # inline in the index tree
db.delete(b"tiny")
assert db.get(b"hello") == b"world" * 300
assert db.get(b"tiny") is None
print("scan:", [(k, len(v)) for k, v in db.scan(b"", 10)])

# Sharded multi-tenant front-end: N shards, one device, one lane pool.
# Batched ops route per shard; GC/compaction admission is global.
from repro_torch.core import ShardedKVStore  # noqa: E402

sdb = ShardedKVStore(preset("scavenger_plus"), n_shards=4)
sdb.write_batch([("put", b"k%04d" % i, b"v" * 1024) for i in range(64)]
                + [("del", b"k0000")])
vals = sdb.multi_get([b"k0001", b"k0000", b"k0042"])
assert vals[0] == b"v" * 1024 and vals[1] is None
sdb.flush_all()
print("sharded scan:", [k for k, _ in sdb.scan(b"k", 5)])
print("sharded space:", {k: v for k, v in sdb.space_usage().items()
                         if k in ("total_bytes", "index_bytes",
                                  "value_live_bytes")})

# Cross-shard group commit: every write_batch is made durable by ONE
# coalesced WAL sync, however many shards the batch touches — compare
# wal syncs/records with and without batching.
sdb2 = ShardedKVStore(preset("scavenger_plus"), n_shards=4)
for j in range(8):
    sdb2.write_batch([("put", b"g%05d" % (64 * j + i), b"v" * 1024)
                      for i in range(64)])
w = sdb2.stats()["wal"]
print(f"group commit: {w['records']} records in {w['syncs']} wal_syncs "
      f"({w['records'] / w['syncs']:.0f} records/sync)")
assert w["syncs"] < w["records"] / 16

# Solo stores batch too: KVStore.write_batch opens a commit group on its
# private WAL, so a standalone store amortizes syncs the same way.
db2 = KVStore(preset("scavenger_plus"))
db2.write_batch([("put", b"s%05d" % i, b"v" * 1024) for i in range(64)])
w = db2.stats()["wal"]
print(f"solo group commit: {w['records']} records in {w['syncs']} syncs")

# Online shard rebalancing: keys hash into fixed slots, slots map to
# shards, and a JOB_MIGRATE job (scheduled like GC, throttled by the
# same bandwidth governor) moves one slot at a time — routing re-points
# in a single epoch commit, and the balancer proposes moves itself when
# per-shard live-byte load diverges (opts.rebalance=True).
rdb = ShardedKVStore(preset("scavenger_plus", num_slots=64), n_shards=2)
for i in range(256):
    rdb.put(b"r%05d" % i, b"v" * 2048)
slot = next(s for s, owner in enumerate(rdb.slot_map) if owner == 0)
rdb.rebalancer.start_migration(slot, 1)      # move slot: shard 0 -> 1
rdb.drain()                                  # epoch commit rides the job
reb = rdb.stats()["rebalance"]
assert rdb.slot_map[slot] == 1 and reb["epoch"] == 1
print(f"rebalance: epoch={reb['epoch']} slots_moved={reb['slots_moved']} "
      f"keys_moved={reb['keys_moved']} bytes_moved={reb['bytes_moved']}")

# Adaptive KV placement: the separation threshold tunes itself per store
# from a space-vs-write-amp cost model over observed value sizes and
# update rates, and records migrate lazily on rewrite — GC reattaches
# small/cold separated values inline, compaction re-separates large
# inline ones.  Hot small values (overwritten soon) stay inline even
# below the boundary, where the next compaction reclaims them for free.
adb = KVStore(preset("scavenger_plus_adaptive"))
for r in range(4):
    for i in range(400):
        adb.put(b"p%04d" % i, b"v" * (128 if i % 10 else 16384))
adb.flush_all()
pl = adb.stats()["placement"]
print(f"placement: thr={pl['effective_threshold']}B "
      f"inline={pl['inline_records']} separated={pl['separated_records']} "
      f"migrated_in={pl['migr_to_inline_keys']} "
      f"migrated_out={pl['migr_to_sep_keys']}")
assert pl["adaptive"] and pl["retunes"] >= 1

# Shared read cache: the shards of a ShardedKVStore share ONE
# device-wide cache budget.  With shared_cache on (scavenger_plus_adaptive
# preset, S-CACHE ablation), per-shard admission quotas re-tune online
# from ghost-cache utility — a read-hot tenant's slice grows, idle
# slices shrink — while quota bytes always sum exactly to cache_bytes.
# The cache also feeds per-size-class read heat into the placement cost
# model (knob: placement_read_weight; 0 turns the read-cost term off),
# so frequently point-read small values stay inline and skip the second
# device hop separated values pay.
cdb = ShardedKVStore(preset("scavenger_plus_adaptive",
                            cache_bytes=64 << 10,
                            cache_retune_interval=256), n_shards=2)
for i in range(800):
    cdb.put(b"c%04d" % i, b"v" * 128)
cdb.flush_all()
hot = [b"c%04d" % i for i in range(800) if cdb.shard_of(b"c%04d" % i) == 0]
for r in range(8):                       # shard 0 read-hot, shard 1 idle
    for k in hot:
        cdb.get(k)
cs = cdb.stats()["cache"]
print(f"cache: quotas={cs['quota_bytes']} (sum={cs['quota_sum_bytes']}) "
      f"hit={cs['hit_ratio']:.2f} ghost_hits={cs['ghost_hits']} "
      f"retunes={cs['quota_retunes']}")
assert cs["quota_sum_bytes"] == 64 << 10
assert cs["resident_bytes"] <= cs["capacity_bytes"]
assert cs["quota_bytes"][0] > cs["quota_bytes"][1]

# Concurrent front-end: client threads drive write_batch/multi_get
# against the same store.  Batches open commit groups on the shared
# pipeline; whichever thread closes a group first becomes the commit
# leader and drains every concurrent batch with one coalesced WAL sync,
# so aggregate syncs/record drop as thread count grows.
import threading  # noqa: E402

tdb = ShardedKVStore(preset("scavenger_plus"), n_shards=4)
N_THREADS, PER = 4, 64
barrier = threading.Barrier(N_THREADS)

def _client(tid):
    barrier.wait()
    for i in range(0, PER, 4):
        tdb.write_batch([("put", b"t%02d-%04d" % (tid, i + j), b"v" * 256)
                         for j in range(4)])

threads = [threading.Thread(target=_client, args=(t,))
           for t in range(N_THREADS)]
for t in threads:
    t.start()
for t in threads:
    t.join()
got = tdb.multi_get([b"t%02d-%04d" % (t, 0) for t in range(N_THREADS)])
assert all(v == b"v" * 256 for v in got)
w = tdb.stats()["wal"]
print(f"concurrent: {N_THREADS} threads, {w['records']} records in "
      f"{w['syncs']} wal_syncs ({w['records'] / w['syncs']:.1f} records/sync)")
assert w["syncs"] < N_THREADS * PER // 4      # cross-thread coalescing
