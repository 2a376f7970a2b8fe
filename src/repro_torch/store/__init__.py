"""Storage substrate: simulated block device, block cache, table formats,
block I/O envelopes + filters, memtable/WAL.  See DESIGN.md §3."""

from .blockio import BlockCodecStats, BlockCorruptionError
from .blocks import BlockCache, BloomFilter
from .device import (BlockDevice, Clock, CostModel, FSBlockDevice, IOClass,
                     IOStats, RateLimiter)
from .filter import PartitionedBloomFilter
from .memtable import WAL, Memtable

__all__ = [
    "BlockCache", "BlockCodecStats", "BlockCorruptionError", "BloomFilter",
    "BlockDevice", "Clock", "CostModel", "FSBlockDevice", "IOClass",
    "IOStats", "PartitionedBloomFilter", "RateLimiter", "WAL", "Memtable",
]
