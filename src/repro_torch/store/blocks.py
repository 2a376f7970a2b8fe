"""Block encoding, bloom filters and the block-cache view.

The block cache follows RocksDB's two-queue design referenced by the paper
(Section III-B.2): entries inserted with high priority live in a protected
region that is evicted only after the low-priority region is exhausted —
this is what keeps DTable *index-entry blocks* resident across GC-Lookups.
The cache *implementation* lives in :mod:`repro.core.cache` — one
device-wide :class:`~repro.core.cache.SharedReadCache` serves every shard
through per-shard handles; :func:`BlockCache` here is the historical
single-tenant constructor, now a view over a private one-shard core.
"""

from __future__ import annotations

from typing import Tuple

# varint coding lives in blockio (stdlib-only, shared with envelopes and
# filters); the Bloom filters moved to repro.store.filter.  Both are
# re-exported here for the historical import surface.
from .blockio import decode_varint, encode_varint
from .filter import BloomFilter

__all__ = ["encode_varint", "decode_varint", "encode_record",
           "decode_record", "BloomFilter", "BlockCache"]


# --------------------------------------------------------------------------
# record coding
# --------------------------------------------------------------------------

def encode_record(key: bytes, value: bytes) -> bytes:
    return encode_varint(len(key)) + key + encode_varint(len(value)) + value


def decode_record(buf: bytes, pos: int) -> Tuple[bytes, bytes, int]:
    klen, pos = decode_varint(buf, pos)
    key = buf[pos:pos + klen]
    pos += klen
    vlen, pos = decode_varint(buf, pos)
    value = buf[pos:pos + vlen]
    pos += vlen
    return key, value, pos


# --------------------------------------------------------------------------
# Block cache (view constructor — the core lives in repro.core.cache)
# --------------------------------------------------------------------------

def BlockCache(capacity_bytes: int, high_ratio: float = 0.5):
    """Single-tenant byte-capacity LRU with a high-priority protected
    region — the historical constructor, kept as the convenient way to
    build a private cache (tests, standalone table readers).

    ``high_ratio`` of the capacity is reserved for high-priority entries
    (index / index-entry blocks).  Low-priority insertions never evict
    high-priority residents; high-priority insertions may evict both.

    Returns a :class:`~repro.core.cache.ShardCacheHandle` over a private
    one-shard :class:`~repro.core.cache.SharedReadCache` (same surface
    the old class exposed).  Imported lazily: ``repro.core`` imports this
    module at package-init time, so a module-level import would cycle.
    """
    from ..core.cache import SharedReadCache
    return SharedReadCache(capacity_bytes, n_shards=1,
                           high_ratio=high_ratio).handle(0)
