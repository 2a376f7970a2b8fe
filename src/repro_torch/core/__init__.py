"""Scavenger+ core: the KV-separated LSM-tree engine (paper Section III).

Public API::

    from repro.core import KVStore, Options, Store, preset
    db = KVStore(preset("scavenger_plus"))
    db.put(b"k", b"v" * 4096)
    db.get(b"k")
    db.scan(b"a", 100)
    with db.snapshot() as snap:       # pinned MVCC read view
        snap.get(b"k")
    db.read_modify_write(b"k", lambda v: (v or b"") + b"!")
    db.stats()

:class:`KVStore` (one engine) and :class:`ShardedKVStore` (N engines
behind slot routing, a shared device and one group-commit log) both
satisfy the :class:`Store` protocol — checkpointing, the bench harness
and the benchmarks are written against it, so every workload runs
unchanged on either topology.
"""

from typing import (Callable, Dict, Iterable, List, Optional, Protocol,
                    Sequence, Tuple, runtime_checkable)

from .cache import SharedReadCache
from .db import KVStore
from .mvcc import Snapshot
from .options import Options, preset
from .sharded import ShardedKVStore


@runtime_checkable
class Store(Protocol):
    """The unified store surface (structural; both engines satisfy it).

    Write ops are durable per the engine's commit pipeline (WAL append,
    group-coalesced when batched); reads taking ``snapshot=`` are pinned
    to that :class:`~.mvcc.Snapshot`'s bounds.  ``multi_get`` and
    ``scan`` without an explicit snapshot are still torn-read free —
    the sharded engine pins an implicit one for the call.
    """

    def put(self, ukey: bytes, value: bytes) -> None: ...
    def delete(self, ukey: bytes) -> None: ...
    def get(self, ukey: bytes, *,
            snapshot: Optional[Snapshot] = None) -> Optional[bytes]: ...
    def contains(self, ukey: bytes, *,
                 snapshot: Optional[Snapshot] = None) -> bool: ...
    def multi_get(self, keys: Sequence[bytes], *,
                  snapshot: Optional[Snapshot] = None
                  ) -> List[Optional[bytes]]: ...
    def write_batch(self, ops: Iterable[Tuple]) -> None: ...
    def scan(self, start: bytes, count: int, *,
             snapshot: Optional[Snapshot] = None
             ) -> List[Tuple[bytes, bytes]]: ...
    def snapshot(self) -> Snapshot: ...
    def read_modify_write(self, ukey: bytes,
                          fn: Callable[[Optional[bytes]], Optional[bytes]],
                          max_retries: int = 64) -> Optional[bytes]: ...
    def compare_and_swap(self, ukey: bytes, expected: Optional[bytes],
                         new: Optional[bytes]) -> bool: ...
    def flush_all(self) -> None: ...
    def drain(self, max_sim_s: float = 1e9) -> None: ...
    def stats(self) -> Dict[str, object]: ...
    def space_usage(self) -> Dict[str, object]: ...
    # Observability (repro.obs): registry + amplification-ledger
    # snapshot, and Chrome-trace recording on the simulated clock
    # (``with db.trace("out.json"): ...``).
    def metrics(self, *, sim_only: bool = False) -> Dict[str, object]: ...
    def trace(self, path: Optional[str] = None): ...


__all__ = ["KVStore", "Options", "preset", "ShardedKVStore",
           "SharedReadCache", "Snapshot", "Store"]
