"""Thread-coordination primitives for the concurrent front-end.

The engine stays a discrete-event simulation over one shared clock, but
client threads may now drive ``write_batch``/``multi_get``/``scan``
concurrently.  The lock levels keep that safe; acquire strictly in
increasing level order (skipping levels is fine, reversing is not):

level 0  ``ShardedKVStore.routing`` (:class:`RWLock`)
         Routing epoch: slot map + in-flight migration windows.  Every
         routed op holds a *read* hold for its whole span; a migration's
         epoch commit needs the *write* side.  Commits never block on it:
         they ``try_acquire_write`` and defer to the next idle point
         (``release_read`` reports idleness), preserving the old deferred
         -commit semantics of the ``_route_locks`` counter this replaces.

level 0.5  ``ShardedKVStore._apply_gate`` (``RLock``)
         The MVCC batch-atomicity gate: ``write_batch`` holds it across
         the whole multi-shard apply loop, ``snapshot()`` holds it while
         reading the per-shard sequence bounds.  A snapshot's bounds
         vector therefore sits entirely before or entirely after any
         batch — cross-shard batches are visible all-or-nothing.  Taken
         after the routing read hold, before any shard latch.

level 1  ``KVStore.latch`` (per-shard ``RLock``)
         Serializes foreground client ops on one shard's memtable/sink
         state.  Background job bodies and event effects do NOT take it —
         they run under the engine lock, which foreground ops also hold
         for their mutation span, so shard state stays single-writer.

level 2  ``SchedulerCore.engine_lock`` (``RLock``)
         THE serialization point for simulated time: clock, device I/O
         charging, event heap, lanes, admission, governor, version sets.
         All clock advancement happens under it.

level 3  Leaf mutexes, never held across a blocking acquire of anything
         above: the commit pipeline's queue lock (``CommitPipeline``),
         the shared read cache's lock, the rebalancer's accounting lock,
         the snapshot registry's bound-set lock (``core.mvcc``).

Two extra rules close the deadlock surface:

* A thread never waits on the commit-pipeline condition while holding
  the engine lock — the group leader needs the engine lock to drain.
  (Waiting while holding a latch or a routing read hold is fine; the
  leader never takes those.)
* Epoch commits inside ``pump`` use ``try_acquire_write`` only — a
  blocking write acquire under the engine lock would deadlock against
  the very readers whose pump fired the effect.
"""

from __future__ import annotations

import threading
from typing import Optional


class RWLock:
    """Reader-writer lock with reentrant, thread-local read holds.

    Generalizes the old ``_route_locks`` counter: routing reads are
    shared (and reentrant — a routed op that internally routes again
    must not self-deadlock), epoch commits are exclusive.  A waiting
    writer blocks *new* first-time readers so a steady read stream
    cannot starve commits forever; nested reads by an existing holder
    always proceed.

    :meth:`release_read` returns ``True`` when the drop left the lock
    fully idle — the caller uses that edge to run deferred commits,
    exactly where the old counter hit zero.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._cond = threading.Condition(self._mu)
        self._readers = 0                    # threads with first-level holds
        self._writer: Optional[int] = None   # owning thread ident
        self._writers_waiting = 0
        self._tls = threading.local()

    # -- read side -------------------------------------------------------
    def acquire_read(self) -> None:
        depth = getattr(self._tls, "depth", 0)
        if depth > 0:                        # nested: already counted
            self._tls.depth = depth + 1
            return
        me = threading.get_ident()
        with self._mu:
            if self._writer == me:
                # The writer may read under its own write hold; it is
                # already exclusive, so don't count it as a reader.
                self._tls.depth = 1
                self._tls.under_write = True
                return
            while self._writer is not None or self._writers_waiting > 0:
                self._cond.wait()
            self._readers += 1
        self._tls.depth = 1
        self._tls.under_write = False

    def release_read(self) -> bool:
        """Drop one read hold; returns True if the lock went fully idle."""
        depth = self._tls.depth
        self._tls.depth = depth - 1
        if depth > 1:
            return False
        if getattr(self._tls, "under_write", False):
            self._tls.under_write = False
            return False
        with self._mu:
            self._readers -= 1
            idle = self._readers == 0 and self._writer is None
            if self._readers == 0:
                self._cond.notify_all()
            return idle

    @property
    def read_held(self) -> bool:
        """Does the *calling thread* hold a read hold?"""
        return getattr(self._tls, "depth", 0) > 0

    # -- write side ------------------------------------------------------
    def acquire_write(self) -> None:
        """Blocking exclusive acquire.  Never call while holding a read
        hold on this lock (self-deadlock) or the engine lock (lock-order
        inversion against active readers) — commits use the try_ form."""
        me = threading.get_ident()
        with self._mu:
            self._writers_waiting += 1
            try:
                while self._writer is not None or self._readers > 0:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = me

    def try_acquire_write(self) -> bool:
        """Non-blocking exclusive acquire; the commit path's only form."""
        with self._mu:
            if self._writer is None and self._readers == 0 \
                    and self._writers_waiting == 0:
                self._writer = threading.get_ident()
                return True
            return False

    def release_write(self) -> None:
        with self._mu:
            assert self._writer == threading.get_ident()
            self._writer = None
            self._cond.notify_all()

    @property
    def write_held(self) -> bool:
        return self._writer == threading.get_ident()
