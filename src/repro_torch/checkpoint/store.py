"""LSM-backed tensor checkpoint store, for trees of torch tensors.

The same store as the JAX package's: tensor chunks are separated values
in the Scavenger+ engine (the port's copy under ``core/`` and
``store/``), the manifest is a small inline value, and superseded
checkpoints deleted by retention become exposed garbage for the engine's
GC.  Keys, chunking, the msgpack manifest and its dtype strings are the
JAX store's, so a directory written by either store restores in the
other.

Durability: a save commits through one ``write_batch`` (every chunk and
the ``meta`` key in one commit group, one WAL sync).  Consistency:
``restore`` runs under one pinned MVCC snapshot, so a save or a
retention delete racing it can tear nothing.  ``FSBlockDevice`` persists
across process restarts; a new process reads a directory back with
``recover=True``.  One departure from the JAX store: a store opened
with ``recover=True`` flushes what it replayed from the WAL at once (the
engine deletes the WAL files it replays), so a directory survives any
number of restarts; the JAX store loses the checkpoints that were still
in the WAL at its first recovery when it is recovered a second time.

On a mesh that runs (``parallel.runtime``), ``save_sharded`` and
``restore_sharded`` take trees of this process's blocks, split over the
mesh's ``data`` and ``model`` axes: the store holds whole tensors, in the
same directory format, so a checkpoint saved on one mesh restores on any
other shape or number of processes, and in the one-process store.
On a mesh without a group they are ``save`` and ``restore(like=...)``.

A tree is a nested dict of tensors.  Its leaves are named by their keys,
in sorted order (the order ``jax.tree_util`` visits a dict), joined with
``/``: ``params/embed``, ``opt/mu/...``, ``opt/count``.  Numpy has no
bfloat16, so a bf16 leaf is stored as its raw 2-byte bits under the
dtype string ``"bfloat16"``, which is what the JAX store writes for
``jnp.bfloat16``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import msgpack
import numpy as np
import torch
import torch.distributed as dist

from ..core import Store
from ..core.db import KVStore
from ..core.mvcc import Snapshot
from ..core.options import preset
from ..parallel import runtime
from ..parallel.sharding import Mesh, tree_map
from ..store.device import FSBlockDevice

CHUNK = 1 << 20          # 1 MiB shard chunks
BF16 = "bfloat16"


def _key_meta(step: int) -> bytes:
    return b"ckpt/%016d/meta" % step


def _key_chunk(step: int, path: str, i: int) -> bytes:
    return b"ckpt/%016d/t/%s/%08d" % (step, path.encode(), i)


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) of a nested dict, keys in sorted order: the names a
    checkpoint stores its leaves under."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [x for k in sorted(tree)
            for x in named_leaves(tree[k],
                                  f"{prefix}/{k}" if prefix else str(k))]


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """The host array whose bytes are stored, and its dtype string."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


@dataclasses.dataclass
class CheckpointConfig:
    keep_last: int = 2
    engine: str = "scavenger_plus"


class CheckpointStore:
    def __init__(self, root: Optional[str] = None,
                 cc: Optional[CheckpointConfig] = None,
                 db: Optional[Store] = None, recover: bool = False
                 ) -> None:
        self.cc = cc or CheckpointConfig()
        if db is not None:
            self.db = db
        else:
            opts = preset(self.cc.engine)
            device = FSBlockDevice(root) if root else None
            self.db = KVStore(opts, device=device, recover=recover)
            if recover:
                # The engine replays the WAL files into the memtable and
                # deletes them without logging their records again: flush
                # those records to tables now, or a second crash before
                # the next flush loses them.
                self.db.flush_all()

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None
             ) -> None:
        """Write one checkpoint as ONE atomic batch: all chunk keys plus
        the ``meta`` key commit under a single group, so a concurrent
        snapshot reader sees it all or nothing."""
        manifest = {"step": step, "extra": extra or {}, "tensors": {}}
        batch: List[Tuple] = []
        for name, leaf in named_leaves(tree):
            arr, dtype = _to_numpy(leaf)
            data = arr.tobytes()
            n_chunks = max(1, -(-len(data) // CHUNK))
            manifest["tensors"][name] = {
                "shape": list(arr.shape), "dtype": dtype, "chunks": n_chunks}
            for i in range(n_chunks):
                batch.append(("put", _key_chunk(step, name, i),
                              data[i * CHUNK:(i + 1) * CHUNK]))
        batch.append(("put", _key_meta(step), msgpack.packb(manifest)))
        self.db.write_batch(batch)
        self._enforce_retention()

    def steps(self, snapshot: Optional[Snapshot] = None) -> List[int]:
        # ``accept`` filters keys before their values are read: the listing
        # reads the manifests and no tensor chunk.
        out = []
        for k, _ in self.db.scan(b"ckpt/", 1 << 20,
                                 accept=lambda k: k.endswith(b"/meta"),
                                 snapshot=snapshot):
            out.append(int(k.split(b"/")[1]))
        return sorted(set(out))

    def latest(self, snapshot: Optional[Snapshot] = None) -> Optional[int]:
        s = self.steps(snapshot=snapshot)
        return s[-1] if s else None

    def restore(self, step: Optional[int] = None, like: Any = None):
        """Returns (step, tree), or (None, None) when nothing is stored.

        With ``like``, a nested dict of tensors, each stored array is
        copied into ``like``'s tensor of the same name, on that tensor's
        device and in its dtype, and the tree returned is ``like``
        itself: a restore on the card needs no second copy of the state.
        A shape that differs raises.  Without ``like``, the tree is the
        flat ``{name: np.ndarray}`` dict; a bf16 leaf there is its raw
        bits as ``np.uint16`` (numpy has no bfloat16):
        ``torch.from_numpy(a).view(torch.bfloat16)`` makes it a tensor.

        The whole restore (step listing, manifest read, every chunk read)
        runs under one pinned snapshot."""
        with self.db.snapshot() as snap:
            step = self.latest(snapshot=snap) if step is None else step
            if step is None:
                return None, None
            raw = self.db.get(_key_meta(step), snapshot=snap)
            if raw is None:
                raise KeyError(f"no checkpoint at step {step}")
            manifest = msgpack.unpackb(raw, raw=False)
            tensors: Dict[str, np.ndarray] = {}
            for name, info in manifest["tensors"].items():
                dtype = (np.dtype(np.uint16) if info["dtype"] == BF16
                         else np.dtype(info["dtype"]))
                buf = bytearray(dtype.itemsize
                                * int(np.prod(info["shape"], dtype=np.int64)))
                at = 0
                for i in range(info["chunks"]):
                    blob = self.db.get(_key_chunk(step, name, i),
                                       snapshot=snap)
                    if blob is None:
                        raise KeyError(f"checkpoint {step}: chunk {i} of "
                                       f"{name} is missing")
                    buf[at:at + len(blob)] = blob
                    at += len(blob)
                tensors[name] = np.frombuffer(buf, dtype=dtype) \
                    .reshape(info["shape"])
        if like is None:
            return step, tensors
        with torch.no_grad():
            for name, leaf in named_leaves(like):
                arr = tensors[name]
                if tuple(leaf.shape) != arr.shape:
                    raise ValueError(f"{name}: stored shape {arr.shape}, "
                                     f"like {tuple(leaf.shape)}")
                src = torch.from_numpy(arr)
                if manifest["tensors"][name]["dtype"] == BF16:
                    src = src.view(torch.bfloat16)
                leaf.copy_(src)
        return step, like

    def delete(self, step: int) -> None:
        """Tombstone all keys of a checkpoint in one batch: the shards
        become exposed garbage for the engine's GC, and a snapshot reader
        pinned before the delete still restores the full step."""
        raw = self.db.get(_key_meta(step))
        if raw is None:
            return
        manifest = msgpack.unpackb(raw, raw=False)
        batch: List[Tuple] = []
        for name, info in manifest["tensors"].items():
            for i in range(info["chunks"]):
                batch.append(("del", _key_chunk(step, name, i)))
        batch.append(("del", _key_meta(step)))
        self.db.write_batch(batch)

    def _enforce_retention(self) -> None:
        steps = self.steps()
        for s in steps[:-self.cc.keep_last]:
            self.delete(s)

    def stats(self) -> Dict:
        return self.db.stats()


def save_sharded(store: Optional[CheckpointStore], step: int, tree: Any,
                 spec_tree: Any, mesh: Mesh,
                 extra: Optional[Dict] = None) -> None:
    """``CheckpointStore.save`` of a tree of blocks placed by ``spec_tree``
    on ``mesh``.  Every process takes part in gathering each whole tensor;
    the process of rank 0, the only one that holds the store (``store`` is
    None on the others), writes them in one ``save``, and every process
    waits at a barrier until it has.  On a mesh with a ``pod`` axis, over
    which no leaf is split, every pod gathers the same whole tensors and
    rank 0's, at pod coordinate 0, are written.  On a mesh without a group
    (one process, whole tensors) it is ``store.save``."""
    if mesh.group is None:
        store.save(step, tree, extra)
        return
    rank0 = runtime.rank(mesh) == 0

    def whole(x, spec):
        x = runtime.gather_whole_tree(x, spec, mesh)
        return x.cpu() if rank0 else None
    full = tree_map(whole, tree, spec_tree)
    if rank0:
        store.save(step, full, extra)
    del full
    runtime.barrier(mesh)


def restore_sharded(store: Optional[CheckpointStore], like: Any,
                    spec_tree: Any, mesh: Mesh):
    """``CheckpointStore.restore(like=...)`` of the latest step, with
    ``like`` a tree of this process's blocks placed by ``spec_tree`` on
    ``mesh``.  The process of rank 0 (the only one that holds ``store``)
    reads the whole tensors and sends each to the others; each copies its
    block into ``like``'s tensor (every pod of a mesh with a ``pod`` axis
    the same blocks).  Returns (step, like), or (None, None) on every
    process when nothing is stored.  On a mesh without a group it is
    ``store.restore(like=like)``."""
    if mesh.group is None:
        return store.restore(like=like)
    rank0 = runtime.rank(mesh) == 0
    step, whole = None, None
    if rank0:
        blank = tree_map(lambda x, spec: torch.empty(
            runtime.full_shape(tuple(x.shape), spec, mesh), dtype=x.dtype),
            like, spec_tree)
        step, whole = store.restore(like=blank)
    sent = [step]
    dist.broadcast_object_list(sent, src=0, group=mesh.group)
    if sent[0] is None:
        return None, None
    sources = dict(named_leaves(whole)) if rank0 else {}
    with torch.no_grad():
        for (name, leaf), (_, spec) in zip(named_leaves(like),
                                           named_leaves(spec_tree)):
            if rank0:
                buf = sources.pop(name).to(leaf.device)
            else:
                buf = leaf.new_empty(runtime.full_shape(tuple(leaf.shape),
                                                        spec, mesh))
            dist.broadcast(buf, src=0, group=mesh.group)
            leaf.copy_(runtime.local_block(buf, spec, mesh))
    return sent[0], like
