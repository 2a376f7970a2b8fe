"""Cross-shard MVCC snapshots (the versioned-read layer).

Group commit (``core.commitlog``) makes a cross-shard batch atomically
*durable*; this module makes it atomically *visible*.  A
:class:`Snapshot` pins reads to a per-shard sequence-bound vector plus
the global commit sequence number (CSN) the group-commit leader
allocated for the round that produced it:

* **Capture** — ``store.snapshot()`` reads every shard's applied
  sequence under the sharded front-end's *apply gate* (no batch can be
  mid-apply) and the engine lock (no single record can be mid-apply),
  so any batch is either entirely ``<=`` the bounds or entirely above
  them.  The routing epoch (slot map + in-flight migrations) is
  captured alongside: snapshot reads route by the *captured* map, which
  keeps them on the migration source — whose data at sequences ``<=``
  bound is preserved (cleanup tombstones and catch-up copies all carry
  later sequences).
* **Visibility** — every read filters to the newest version with
  ``seq <= bound`` on its shard: the memtable keeps shadowed versions
  in a per-key history while a registered bound spans them, flush
  writes the retained history out (kSSTs tolerate duplicate keys with
  distinct seqs), and compaction drops an older version only when no
  registered bound separates it from its successor (the classic
  oldest-snapshot retention rule).  Standalone GC defers entirely while
  snapshots are registered — Titan's oldest-snapshot gate — because GC
  deletes value files that bound-visible index entries may still
  reference.
* **Lifetime** — snapshots are refcounted in a per-shard
  :class:`SnapshotRegistry` (a leaf-level mutex, see
  ``core.concurrency``); releasing the last reference re-arms the GC
  trigger the registration deferred.

``read_modify_write`` / ``compare_and_swap`` build on the same
machinery: the write validates the key's newest sequence (its per-shard
slice of the CSN order) under the shard's foreground locks and retries
on conflict, with the WAL append riding the commit pipeline.
"""

from __future__ import annotations

import threading
from bisect import bisect_left, insort
from typing import Dict, List, Optional, Sequence, Tuple


class SnapshotRegistry:
    """Refcounted multiset of registered sequence bounds for ONE shard.

    Mutations happen under the engine lock (capture and release both
    take it), but the internal leaf mutex makes the queries callable
    from any context without widening the engine section.  The
    ``active`` fast path is lock-free: with no snapshot registered —
    the overwhelmingly common case on the write path — version
    retention must cost one attribute read and a truthiness check.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()              # leaf (level 3)
        self._refs: Dict[int, int] = {}          # bound -> refcount
        self._sorted: List[int] = []             # sorted unique bounds

    @property
    def active(self) -> bool:
        """Any snapshot registered?  (Lock-free fast path.)"""
        return bool(self._refs)

    @property
    def count(self) -> int:
        with self._mu:
            return sum(self._refs.values())

    def register(self, bound: int) -> None:
        with self._mu:
            n = self._refs.get(bound, 0)
            self._refs[bound] = n + 1
            if n == 0:
                insort(self._sorted, bound)

    def unregister(self, bound: int) -> None:
        with self._mu:
            n = self._refs.get(bound, 0) - 1
            if n <= 0:
                self._refs.pop(bound, None)
                try:
                    self._sorted.remove(bound)
                except ValueError:
                    pass
            else:
                self._refs[bound] = n

    def needs_version(self, old_seq: int, new_seq: int) -> bool:
        """Must the version at ``old_seq``, shadowed by one at
        ``new_seq``, be retained?  True iff a registered bound ``b``
        satisfies ``old_seq <= b < new_seq`` — a snapshot at ``b`` sees
        the old version and not the new one.  Applying this to every
        *adjacent* version pair retains exactly the versions some
        registered snapshot can still read (chains compose)."""
        if not self._refs:
            return False
        with self._mu:
            i = bisect_left(self._sorted, old_seq)
            return i < len(self._sorted) and self._sorted[i] < new_seq

    def has_bound_below(self, seq: int) -> bool:
        """Any registered bound strictly below ``seq``?  Used by
        compaction to keep a bottom-level tombstone whose retained
        older versions would otherwise resurrect."""
        if not self._refs:
            return False
        with self._mu:
            return bool(self._sorted) and self._sorted[0] < seq

    def min_bound(self) -> Optional[int]:
        with self._mu:
            return self._sorted[0] if self._sorted else None


class Snapshot:
    """A pinned, context-managed MVCC read view over a ``Store``.

    ``bounds[tag]`` is shard ``tag``'s applied sequence at capture (a
    solo store is shard 0 of a one-element vector); ``csn`` is the
    advisory global commit sequence at capture; ``slot_map`` /
    ``inflight`` freeze the routing epoch for sharded stores so reads
    stay on the migration *source* — the shard whose ``<=`` bound data
    is retention-protected — no matter how routing moves afterwards.

    Reads (``get`` / ``multi_get`` / ``scan`` / ``contains``) delegate
    to the owning store with ``snapshot=self``.  The handle is
    refcount-registered at construction and must be released exactly
    once — use it as a context manager, or call :meth:`close`.
    """

    def __init__(self, store, bounds: Sequence[int], csn: int,
                 slot_map: Optional[List[int]] = None,
                 inflight: Optional[Dict[int, int]] = None,
                 epoch: int = 0) -> None:
        self.store = store
        self.bounds = list(bounds)
        self.csn = csn
        self.slot_map = list(slot_map) if slot_map is not None else None
        self.inflight = dict(inflight) if inflight is not None else {}
        self.epoch = epoch
        self._closed = False

    # -- lifetime --------------------------------------------------------
    def __enter__(self) -> "Snapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Release the pinned bounds (idempotent).  Version retention
        for them stops and any GC the registration deferred is
        re-armed."""
        if self._closed:
            return
        self._closed = True
        self.store._release_snapshot(self)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- pinned reads ----------------------------------------------------
    def get(self, ukey: bytes) -> Optional[bytes]:
        return self.store.get(ukey, snapshot=self)

    def multi_get(self, keys) -> List[Optional[bytes]]:
        return self.store.multi_get(keys, snapshot=self)

    def scan(self, start: bytes, count: int) -> List[Tuple[bytes, bytes]]:
        return self.store.scan(start, count, snapshot=self)

    def contains(self, ukey: bytes) -> bool:
        return self.store.contains(ukey, snapshot=self)
