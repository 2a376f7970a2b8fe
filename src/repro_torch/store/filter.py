"""Per-table Bloom filters: single and partitioned.

A :class:`BloomFilter` is the classic double-hashing-over-blake2b filter the
kSST aux block has always carried.  A :class:`PartitionedBloomFilter` splits
a table's (sorted) key set into fixed-size partitions, each with its own
small filter, plus the last key of each partition — probes bisect to the one
partition that could hold the key, so a probe touches a few cache lines
instead of a table-sized bit array, and a key past the table's last key is
rejected without hashing at all.  v2 tables serialize partitioned filters
into a filter block (kSST aux / vSST footer aux slot);
:func:`decode_filter` also understands the legacy single-filter encoding so
old tables keep their filters after the format upgrade.
"""

from __future__ import annotations

import hashlib
import struct
from bisect import bisect_left
from typing import List, Optional, Tuple, Union

from .blockio import decode_varint, encode_varint

#: leading byte of the partitioned encoding.  The legacy single-filter
#: encoding leads with its probe count k in 1..8, so the two are disjoint.
FILTER_MAGIC = 0xF1

#: keys per partition — small enough that one partition's bits fit in a few
#: cache lines at 10 bits/key, large enough that the last-key directory stays
#: tiny next to the bit arrays.
DEFAULT_PARTITION = 2048


class BloomFilter:
    def __init__(self, bits: bytearray, k: int) -> None:
        self.bits = bits
        self.k = k

    @staticmethod
    def _hashes(key: bytes) -> Tuple[int, int]:
        d = hashlib.blake2b(key, digest_size=16).digest()
        return (int.from_bytes(d[:8], "little"),
                int.from_bytes(d[8:], "little") | 1)

    @classmethod
    def build(cls, keys: List[bytes], bits_per_key: int = 10) -> "BloomFilter":
        n = max(64, len(keys) * bits_per_key)
        k = max(1, min(8, int(round(bits_per_key * 0.69))))
        bits = bytearray((n + 7) // 8)
        m = len(bits) * 8
        for key in keys:
            h1, h2 = cls._hashes(key)
            for i in range(k):
                b = (h1 + i * h2) % m
                bits[b >> 3] |= 1 << (b & 7)
        return cls(bits, k)

    def may_contain(self, key: bytes) -> bool:
        m = len(self.bits) * 8
        if m == 0:
            return True
        h1, h2 = self._hashes(key)
        for i in range(self.k):
            b = (h1 + i * h2) % m
            if not self.bits[b >> 3] & (1 << (b & 7)):
                return False
        return True

    def encode(self) -> bytes:
        return struct.pack("<B", self.k) + bytes(self.bits)

    @classmethod
    def decode(cls, data: bytes) -> "BloomFilter":
        (k,) = struct.unpack_from("<B", data, 0)
        return cls(bytearray(data[1:]), k)


class PartitionedBloomFilter:
    """Bloom filter partitioned by key range.

    ``lasts[i]`` is the greatest key covered by ``parts[i]``; keys bisect to
    exactly one candidate partition.  A key greater than the table's last
    key is definitively absent (every table key is <= ``lasts[-1]``).
    """

    def __init__(self, lasts: List[bytes], parts: List[BloomFilter]) -> None:
        self.lasts = lasts
        self.parts = parts

    @classmethod
    def build(cls, keys: List[bytes], bits_per_key: int = 10,
              partition: int = DEFAULT_PARTITION) -> "PartitionedBloomFilter":
        """Build from keys in ascending order (table build order)."""
        lasts: List[bytes] = []
        parts: List[BloomFilter] = []
        for i in range(0, len(keys), partition):
            chunk = keys[i:i + partition]
            lasts.append(chunk[-1])
            parts.append(BloomFilter.build(chunk, bits_per_key))
        return cls(lasts, parts)

    def may_contain(self, key: bytes) -> bool:
        i = bisect_left(self.lasts, key)
        if i >= len(self.parts):
            return False
        return self.parts[i].may_contain(key)

    def encode(self) -> bytes:
        out = bytearray((FILTER_MAGIC,))
        out += encode_varint(len(self.parts))
        for last, part in zip(self.lasts, self.parts):
            pb = part.encode()
            out += encode_varint(len(last)) + last
            out += encode_varint(len(pb)) + pb
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "PartitionedBloomFilter":
        assert data[0] == FILTER_MAGIC
        n, pos = decode_varint(data, 1)
        lasts: List[bytes] = []
        parts: List[BloomFilter] = []
        for _ in range(n):
            ln, pos = decode_varint(data, pos)
            lasts.append(bytes(data[pos:pos + ln]))
            pos += ln
            ln, pos = decode_varint(data, pos)
            parts.append(BloomFilter.decode(data[pos:pos + ln]))
            pos += ln
        return cls(lasts, parts)


FilterLike = Union[BloomFilter, PartitionedBloomFilter]


def build_filter(keys: List[bytes], bits_per_key: int) -> bytes:
    """Serialize a partitioned filter over ``keys``; b'' when disabled."""
    if bits_per_key <= 0 or not keys:
        return b""
    return PartitionedBloomFilter.build(keys, bits_per_key).encode()


def decode_filter(data: bytes) -> Optional[FilterLike]:
    """Decode a filter block; handles the legacy single-filter encoding."""
    if not data:
        return None
    if data[0] == FILTER_MAGIC:
        return PartitionedBloomFilter.decode(data)
    return BloomFilter.decode(data)
