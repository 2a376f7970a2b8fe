"""On-disk record formats shared by all table types.

An *entry* is ``(user_key, seq, vtype, payload)``:

* ``VT_VALUE``      — inline value (small KV kept in the index LSM-tree)
* ``VT_INDEX_KA``   — WiscKey/Titan-style address index: payload encodes
                      ``(vsst_file, offset, size)``
* ``VT_INDEX_KF``   — TerarkDB-style file index: payload encodes
                      ``(vsst_file, size)`` — the engine resolves the key
                      inside the vSST through its own (dense) index
* ``VT_DELETE``     — tombstone

Internal keys order by ``user_key`` ascending then ``seq`` descending,
LevelDB-style, so the newest version of a key sorts first.
"""

from __future__ import annotations

import struct
from typing import Tuple

from .blocks import decode_varint, encode_varint

VT_VALUE = 0
VT_INDEX_KA = 1
VT_INDEX_KF = 2
VT_DELETE = 3

MAX_SEQ = (1 << 56) - 1


def pack_ikey(ukey: bytes, seq: int, vtype: int) -> bytes:
    """user_key + 8-byte trailer; trailer stores (MAX_SEQ-seq) so that
    lexicographic byte order gives seq-descending within one user key."""
    return ukey + struct.pack(">Q", ((MAX_SEQ - seq) << 8) | vtype)


def unpack_ikey(ikey: bytes) -> Tuple[bytes, int, int]:
    (tail,) = struct.unpack(">Q", ikey[-8:])
    return ikey[:-8], MAX_SEQ - (tail >> 8), tail & 0xFF


def encode_ka(vsst: int, offset: int, size: int,
              raw: int = None) -> bytes:
    """KA address payload: (vsst, offset, size) + optional logical size.

    ``size`` is the *stored* span (envelope bytes under compression); when
    the logical (uncompressed) value size differs, it rides along as a 4th
    varint so heat/placement accounting stays in logical bytes while reads
    still know exactly how many device bytes to fetch.
    """
    out = encode_varint(vsst) + encode_varint(offset) + encode_varint(size)
    if raw is not None and raw != size:
        out += encode_varint(raw)
    return out


def decode_ka(payload: bytes) -> Tuple[int, int, int]:
    vsst, p = decode_varint(payload, 0)
    off, p = decode_varint(payload, p)
    size, p = decode_varint(payload, p)
    return vsst, off, size


def ka_logical_size(payload: bytes) -> int:
    """Logical value size of a KA payload (stored size when they coincide)."""
    _, p = decode_varint(payload, 0)
    _, p = decode_varint(payload, p)
    size, p = decode_varint(payload, p)
    if p < len(payload):
        size, p = decode_varint(payload, p)
    return size


def encode_kf(vsst: int, size: int) -> bytes:
    return encode_varint(vsst) + encode_varint(size)


def decode_kf(payload: bytes) -> Tuple[int, int]:
    vsst, p = decode_varint(payload, 0)
    size, p = decode_varint(payload, p)
    return vsst, size


def entry_value_size(vtype: int, payload: bytes) -> int:
    """Referenced (or inline) value bytes of an entry — the quantity the
    compensated-size compaction strategy sums per kSST (paper III-C).

    Always *logical* (uncompressed) bytes, so compression does not skew the
    heat sketch or the placement histograms; ``space_usage()`` reports the
    physical side separately."""
    if vtype == VT_VALUE:
        return len(payload)
    if vtype == VT_INDEX_KA:
        return ka_logical_size(payload)
    if vtype == VT_INDEX_KF:
        return decode_kf(payload)[1]
    return 0


def entry_vsst(vtype: int, payload: bytes) -> int:
    if vtype == VT_INDEX_KA:
        return decode_ka(payload)[0]
    if vtype == VT_INDEX_KF:
        return decode_kf(payload)[0]
    return 0
