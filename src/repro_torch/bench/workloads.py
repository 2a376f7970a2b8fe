"""Workload generators reproducing the paper's evaluation setup (IV-A).

* 24-byte keys, Zipfian key popularity (YCSB-style, scrambled ranks);
* value-size models: Fixed-N, Mixed-8K (ByteDance OLTP: 1:1 small
  100-512 B / large 16 KB) and Pareto-1K/8K (generalized Pareto, per the
  RocksDB workload-generation study the paper cites);
* db_bench-style phases (load / update / read / scan) and YCSB A-F.

All sizes scale from ``dataset_bytes`` with the paper's ratios (100 GB
dataset : 64 MB memtable : 64 MB kSST : 256 MB vSST : 1 GB cache), so a
64 MB run exhibits the same amplification dynamics as the paper's 100 GB.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.options import Options

KEY_BYTES = 24

Op = Tuple  # ('put',k,v) | ('del',k) | ('get',k) | ('scan',k,n) | ('rmw',k,v)


@dataclasses.dataclass
class ScaleConfig:
    """Derive engine sizes from the dataset size with paper ratios."""
    dataset_bytes: int

    def apply(self, opts: Options) -> Options:
        # The paper's 100 GB run has dataset:memtable = 1600 and
        # memtable:value = 8192.  Both ratios cannot survive a linear
        # shrink; we keep value sizes real and set dataset:memtable = 128
        # so flush files still hold O(100) entries (the per-op latency of
        # the cost model stays meaningful) while the level structure and
        # amplification dynamics are preserved.
        opts.memtable_bytes = max(64 << 10, self.dataset_bytes // 128)
        opts.ksst_bytes = opts.memtable_bytes
        opts.vsst_bytes = 4 * opts.memtable_bytes
        opts.cache_bytes = max(64 << 10, self.dataset_bytes // 100)
        # In the paper, max_bytes_for_level_base (256 MB) is ~1/400 of the
        # dataset but ~0.65x of the *separated index* size — small enough
        # that the index spans multiple levels.  memtable/4 reproduces
        # that index:level_base ratio at bench scale.
        opts.level_base_bytes = max(16 << 10, opts.memtable_bytes // 4)
        return opts


class ValueModel:
    """Samples value sizes; bytes come from a shared random pool."""

    POOL = None

    def __init__(self, kind: str, seed: int = 7) -> None:
        self.kind = kind
        self.rng = np.random.default_rng(seed)
        if ValueModel.POOL is None:
            ValueModel.POOL = np.random.default_rng(123).integers(
                0, 256, size=1 << 22, dtype=np.uint8).tobytes()
        self._batch: Optional[np.ndarray] = None
        self._i = 0

    def mean_size(self) -> float:
        if self.kind.startswith("fixed"):
            return float(int(self.kind.split("-")[1]))
        if self.kind == "mixed-8k":
            return 0.5 * 306 + 0.5 * 16384
        if self.kind == "pareto-1k":
            return 1024.0
        if self.kind == "pareto-8k":
            return 8192.0
        if self.kind.startswith("lognormal"):
            mean, _ = self._lognormal_params()
            return mean
        if self.kind.startswith("bimodal"):
            small, large, p_small = self._bimodal_params()
            return p_small * small + (1.0 - p_small) * large
        raise ValueError(self.kind)

    # -- mixed-distribution knobs (kind-string encoded) -----------------
    def _lognormal_params(self) -> Tuple[float, float]:
        """``lognormal-<mean>[-<sigma_x10>]``: lognormal sizes with the
        given mean and underlying-normal sigma (default 1.0) — the long
        right tail object-store size studies report."""
        parts = self.kind.split("-")
        mean = float(int(parts[1]))
        sigma = int(parts[2]) / 10.0 if len(parts) > 2 else 1.0
        return mean, sigma

    def _bimodal_params(self) -> Tuple[int, int, float]:
        """``bimodal-<small>-<large>[-<pct_small>]``: a small/large
        mixture with ``pct_small`` percent (default 90) of records small
        — the small-value-heavy population the adaptive-placement
        benchmarks exercise.  Small sizes jitter uniformly in
        [small/2, 3*small/2] (mean preserved); large sizes are exact."""
        parts = self.kind.split("-")
        small, large = int(parts[1]), int(parts[2])
        pct = int(parts[3]) if len(parts) > 3 else 90
        if not (small >= 1 and large >= small and 0 < pct < 100):
            raise ValueError(self.kind)
        return small, large, pct / 100.0

    def _sample_sizes(self, n: int) -> np.ndarray:
        if self.kind.startswith("fixed"):
            return np.full(n, int(self.kind.split("-")[1]), dtype=np.int64)
        if self.kind == "mixed-8k":
            small = self.rng.integers(100, 513, size=n)
            pick = self.rng.random(n) < 0.5
            return np.where(pick, small, 16384).astype(np.int64)
        if self.kind in ("pareto-1k", "pareto-8k"):
            mean = 1024.0 if self.kind == "pareto-1k" else 8192.0
            xi = 0.154                      # shape from the FB/RocksDB study
            sigma = mean * (1.0 - xi)
            u = self.rng.random(n)
            sizes = sigma / xi * ((1.0 - u) ** -xi - 1.0)
            return np.clip(sizes, 64, 64 << 10).astype(np.int64)
        if self.kind.startswith("lognormal"):
            mean, sig = self._lognormal_params()
            mu = np.log(mean) - 0.5 * sig * sig   # E[lognormal] = mean
            sizes = self.rng.lognormal(mu, sig, size=n)
            return np.clip(sizes, 16, 256 << 10).astype(np.int64)
        if self.kind.startswith("bimodal"):
            small, large, p_small = self._bimodal_params()
            lo = max(1, small // 2)
            smalls = self.rng.integers(lo, 3 * small // 2 + 1, size=n)
            pick = self.rng.random(n) < p_small
            return np.where(pick, smalls, large).astype(np.int64)
        raise ValueError(self.kind)

    def next_size(self) -> int:
        if self._batch is None or self._i >= len(self._batch):
            self._batch = self._sample_sizes(4096)
            self._i = 0
        s = int(self._batch[self._i])
        self._i += 1
        return s

    def value(self, size: int) -> bytes:
        off = int(self.rng.integers(0, len(ValueModel.POOL) - size)) \
            if size < len(ValueModel.POOL) else 0
        return ValueModel.POOL[off:off + size]


class KeyChooser:
    """Zipfian (theta=0.99, scrambled) or uniform key popularity."""

    def __init__(self, n_keys: int, dist: str = "zipfian",
                 seed: int = 11) -> None:
        self.n = n_keys
        self.dist = dist
        self.rng = np.random.default_rng(seed)
        if dist == "zipfian":
            ranks = np.arange(1, n_keys + 1, dtype=np.float64)
            p = ranks ** -0.99
            self.cdf = np.cumsum(p / p.sum())
            self.perm = np.random.default_rng(seed + 1).permutation(n_keys)
        self._batch: Optional[np.ndarray] = None
        self._i = 0

    def _sample(self, n: int) -> np.ndarray:
        if self.dist == "uniform":
            return self.rng.integers(0, self.n, size=n)
        u = self.rng.random(n)
        idx = np.searchsorted(self.cdf, u)
        return self.perm[np.minimum(idx, self.n - 1)]

    def next(self) -> int:
        if self._batch is None or self._i >= len(self._batch):
            self._batch = self._sample(4096)
            self._i = 0
        k = int(self._batch[self._i])
        self._i += 1
        return k


def make_key(i: int) -> bytes:
    return b"user%020d" % i


@dataclasses.dataclass
class WorkloadSpec:
    value_kind: str                 # fixed-4096 | mixed-8k | pareto-1k ...
    dataset_bytes: int
    update_bytes: int               # paper: 3x dataset
    read_ops: int = 0
    scan_ops: int = 0
    scan_max: int = 100
    seed: int = 5

    @property
    def n_keys(self) -> int:
        vm = ValueModel(self.value_kind)
        return max(64, int(self.dataset_bytes / (vm.mean_size() + KEY_BYTES)))


def gen_load(spec: WorkloadSpec) -> Iterator[Op]:
    """Random-order unique load of the whole keyspace."""
    vm = ValueModel(spec.value_kind, spec.seed)
    order = np.random.default_rng(spec.seed + 2).permutation(spec.n_keys)
    for i in order:
        yield ("put", make_key(int(i)), vm.value(vm.next_size()))


def gen_update(spec: WorkloadSpec) -> Iterator[Op]:
    """Zipfian updates until ``update_bytes`` of traffic is written."""
    vm = ValueModel(spec.value_kind, spec.seed + 3)
    kc = KeyChooser(spec.n_keys, "zipfian", spec.seed + 4)
    written = 0
    while written < spec.update_bytes:
        size = vm.next_size()
        yield ("put", make_key(kc.next()), vm.value(size))
        written += size + KEY_BYTES


def gen_read(spec: WorkloadSpec, n_ops: int) -> Iterator[Op]:
    kc = KeyChooser(spec.n_keys, "zipfian", spec.seed + 5)
    for _ in range(n_ops):
        yield ("get", make_key(kc.next()))


def gen_scan(spec: WorkloadSpec, n_ops: int) -> Iterator[Op]:
    kc = KeyChooser(spec.n_keys, "zipfian", spec.seed + 6)
    rng = np.random.default_rng(spec.seed + 7)
    for _ in range(n_ops):
        yield ("scan", make_key(kc.next()),
               int(rng.integers(2, spec.scan_max + 1)))


def gen_ycsb(spec: WorkloadSpec, which: str, n_ops: int) -> Iterator[Op]:
    """YCSB core workloads A-F over a pre-loaded dataset."""
    vm = ValueModel(spec.value_kind, spec.seed + 8)
    kc = KeyChooser(spec.n_keys, "zipfian", spec.seed + 9)
    rng = np.random.default_rng(spec.seed + 10)
    next_insert = spec.n_keys
    mixes = {   # (read, update, insert, scan, rmw)
        "a": (0.5, 0.5, 0.0, 0.0, 0.0),
        "b": (0.95, 0.05, 0.0, 0.0, 0.0),
        "c": (1.0, 0.0, 0.0, 0.0, 0.0),
        "d": (0.95, 0.0, 0.05, 0.0, 0.0),
        "e": (0.0, 0.0, 0.05, 0.95, 0.0),
        "f": (0.5, 0.0, 0.0, 0.0, 0.5),
    }
    r, u, ins, sc, rmw = mixes[which]
    edges = np.cumsum([r, u, ins, sc, rmw])
    for _ in range(n_ops):
        x = rng.random()
        if x < edges[0]:
            yield ("get", make_key(kc.next()))
        elif x < edges[1]:
            yield ("put", make_key(kc.next()), vm.value(vm.next_size()))
        elif x < edges[2]:
            yield ("put", make_key(next_insert), vm.value(vm.next_size()))
            next_insert += 1
        elif x < edges[3]:
            yield ("scan", make_key(kc.next()),
                   int(rng.integers(2, spec.scan_max + 1)))
        else:
            # Workload F: a true read-modify-write op — the harness runs
            # it through ``Store.read_modify_write`` (validated, retried
            # on conflict) rather than an unvalidated get+put pair.
            yield ("rmw", make_key(kc.next()), vm.value(vm.next_size()))


# ---------------------------------------------------------------------------
# Multi-client / multi-tenant workloads (sharded front-end)
# ---------------------------------------------------------------------------

def tenant_key(tenant: int, key: bytes) -> bytes:
    """Prefix a key with its tenant id — each logical client owns a
    disjoint keyspace, the multi-tenant setting of the sharded store."""
    return b"t%03d/" % tenant + key


def _prefix_ops(stream: Iterator[Op], tenant: int) -> Iterator[Op]:
    for op in stream:
        if op[0] in ("put", "rmw"):
            yield (op[0], tenant_key(tenant, op[1]), op[2])
        elif op[0] == "scan":
            yield ("scan", tenant_key(tenant, op[1]), op[2])
        else:                                   # get / del
            yield (op[0], tenant_key(tenant, op[1]))


def interleave_round_robin(streams: Sequence[Iterator[Op]]) -> Iterator[Op]:
    """One op from each live client per round, until all are exhausted —
    the arrival pattern of M concurrent clients over one front-end."""
    active: List[Iterator[Op]] = list(streams)
    while active:
        survivors: List[Iterator[Op]] = []
        for s in active:
            try:
                yield next(s)
            except StopIteration:
                continue
            survivors.append(s)
        active = survivors


def gen_multi_client(spec: WorkloadSpec, n_clients: int,
                     phase: str = "ycsb-a", n_ops: int = 0,
                     tenant_prefix: bool = True) -> Iterator[Op]:
    """M logical clients interleaved round-robin over one op stream.

    ``phase`` is ``'load'``, ``'update'`` or ``'ycsb-<a..f>'``; each
    client runs its own generator instance (distinct seed, optional
    tenant-prefixed keyspace).  The stream depends only on (spec,
    n_clients), never on shard count, so the same op sequence can drive a
    plain KVStore and any ShardedKVStore for equivalence testing.
    ``spec.dataset_bytes``/``n_ops`` are interpreted per client.
    """
    streams: List[Iterator[Op]] = []
    for c in range(n_clients):
        cspec = dataclasses.replace(spec, seed=spec.seed + 101 * c)
        if phase == "load":
            s = gen_load(cspec)
        elif phase == "update":
            s = gen_update(cspec)
        elif phase.startswith("ycsb-"):
            s = gen_ycsb(cspec, phase[len("ycsb-"):], n_ops)
        else:
            raise ValueError(phase)
        streams.append(_prefix_ops(s, c) if tenant_prefix else s)
    return interleave_round_robin(streams)
