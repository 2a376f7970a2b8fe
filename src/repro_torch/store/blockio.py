"""Self-describing block envelopes: codec tag + lengths + CRC32 checksum.

Every v2 table block (kSST data/index/meta blocks, RTable records, VBTable
value blocks) is wrapped in an envelope so that readers can (a) verify
integrity before handing bytes to anyone, (b) decompress transparently, and
(c) walk a byte range block-by-block without an external index:

    [1B codec] [varint raw_len] [varint body_len] [4B crc32(body) LE] [body]

The CRC covers the stored body (compressed or raw), so a bit flip anywhere
is caught: body flips fail the CRC, length-varint flips shift the CRC window,
codec-tag flips either hit an unknown codec or fail the raw_len check after
decode.  A failure raises :class:`BlockCorruptionError` — corrupt bytes are
never returned to a caller.

The ``lz4`` codec simulates a fast byte-oriented compressor: the stored body
is a real zlib(level=1) stream (so roundtrips are exact) padded up to a
modeled output size drawn from a per-size-class compressibility table, which
keeps the *space* accounting honest for synthetic benchmark values that zlib
would otherwise collapse to nothing.  CPU cost is charged against the
simulation clock via the device's ``charge_cpu`` when one is supplied.

This module depends only on the stdlib (devices and tables import it).
"""

from __future__ import annotations

import zlib
from typing import Dict, Iterator, Optional, Tuple

CODEC_NONE = 0
CODEC_LZ4 = 1

CODECS = {"none": CODEC_NONE, "lz4": CODEC_LZ4}
CODEC_NAMES = {v: k for k, v in CODECS.items()}

#: payloads smaller than this are never worth compressing (header dwarfs gain)
MIN_COMPRESS_BYTES = 64

_CRC_LEN = 4


def encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


class BlockCorruptionError(Exception):
    """A block failed its checksum / structural verification.

    Carries the file id and offset (when known) so the store can quarantine
    the damaged file and fall back to a redundant copy where one exists.
    """

    def __init__(self, msg: str, fid: Optional[int] = None,
                 offset: Optional[int] = None):
        if fid is not None:
            msg = f"{msg} (fid={fid}, off={offset})"
        super().__init__(msg)
        self.fid = fid
        self.offset = offset


# Modeled compressibility by payload size class (log2 buckets).  Small values
# carry proportionally more entropy per byte (keys, headers); large values
# compress better.  Ratios are stored_size / raw_size.
_MODEL_RATIOS = (
    (128, 0.92),
    (256, 0.85),
    (512, 0.78),
    (1024, 0.72),
    (2048, 0.66),
    (4096, 0.62),
    (8192, 0.60),
    (16384, 0.58),
)
_MODEL_FLOOR = 0.55


def model_ratio(n: int) -> float:
    """Modeled compressed/raw ratio for a payload of ``n`` bytes."""
    for cap, r in _MODEL_RATIOS:
        if n <= cap:
            return r
    return _MODEL_FLOOR


class BlockCodecStats:
    """Counters for the block I/O subsystem, hung off a BlockDevice.

    ``bytes_before``/``bytes_after`` are keyed by label: an int tree level
    for kSST blocks, the string ``"value"`` for vSST blocks.  ``after``
    includes envelope overhead, so the ratios reflect the real on-device
    format.
    """

    def __init__(self) -> None:
        self.bytes_before: Dict[object, int] = {}
        self.bytes_after: Dict[object, int] = {}
        self.blocks_encoded = 0
        self.blocks_compressed = 0
        self.blocks_decoded = 0
        self.corrupt_blocks = 0
        self.quarantined_files = 0
        # kSST (index tree) bloom filters
        self.filter_probes = 0
        self.filter_negatives = 0
        self.filter_false_pos = 0
        # vSST key-set filters + probe outcomes (placement's wasted-hop signal)
        self.vsst_filter_probes = 0
        self.vsst_filter_negatives = 0
        self.vsst_filter_false_pos = 0
        self.vsst_probe_hits = 0
        self.vsst_probe_misses = 0

    def note_encode(self, label: object, raw: int, stored: int,
                    compressed: bool) -> None:
        self.bytes_before[label] = self.bytes_before.get(label, 0) + raw
        self.bytes_after[label] = self.bytes_after.get(label, 0) + stored
        self.blocks_encoded += 1
        if compressed:
            self.blocks_compressed += 1

    def ratio(self, group: str = "all") -> float:
        """Measured stored/raw byte ratio over a label group.

        ``group`` is ``"tree"`` (int-labeled kSST levels), ``"value"``
        (vSST blocks) or ``"all"``.  Returns 1.0 until enough bytes have
        been observed to be meaningful.
        """
        before = after = 0
        for k, b in self.bytes_before.items():
            if group == "tree" and not isinstance(k, int):
                continue
            if group == "value" and k != "value":
                continue
            before += b
            after += self.bytes_after.get(k, 0)
        if before < 4096:
            return 1.0
        return min(max(after / before, 0.05), 1.5)

    def wasted_probe_rate(self) -> float:
        """vSST probe misses per hit — extra device hops negative lookups pay.

        Filters drive this toward zero (a filtered miss never reaches the
        device).  Clamped; returns 0.0 until the sample is meaningful.
        """
        h, m = self.vsst_probe_hits, self.vsst_probe_misses
        if h + m < 16:
            return 0.0
        return min(m / max(1, h), 4.0)

    def snapshot(self) -> dict:
        levels = {}
        for k in sorted(self.bytes_before, key=str):
            b = self.bytes_before[k]
            a = self.bytes_after.get(k, 0)
            levels[str(k)] = {
                "bytes_before": b,
                "bytes_after": a,
                "ratio": round(a / b, 4) if b else 1.0,
            }
        return {
            "levels": levels,
            "tree_ratio": round(self.ratio("tree"), 4),
            "value_ratio": round(self.ratio("value"), 4),
            "blocks_encoded": self.blocks_encoded,
            "blocks_compressed": self.blocks_compressed,
            "blocks_decoded": self.blocks_decoded,
            "corrupt_blocks": self.corrupt_blocks,
            "quarantined_files": self.quarantined_files,
            "filter_probes": self.filter_probes,
            "filter_negatives": self.filter_negatives,
            "filter_false_pos": self.filter_false_pos,
            "vsst_filter_probes": self.vsst_filter_probes,
            "vsst_filter_negatives": self.vsst_filter_negatives,
            "vsst_filter_false_pos": self.vsst_filter_false_pos,
            "vsst_probe_hits": self.vsst_probe_hits,
            "vsst_probe_misses": self.vsst_probe_misses,
            "wasted_probe_rate": round(self.wasted_probe_rate(), 4),
        }


def encode_block(payload: bytes, codec: int = CODEC_NONE, *,
                 min_ratio: float = 1.0,
                 stats: Optional[BlockCodecStats] = None,
                 label: object = None,
                 device=None) -> bytes:
    """Wrap ``payload`` in an envelope, compressing when it pays off.

    Falls back to ``none`` storage when the compressed body (including its
    inner length prefix) would not come in under ``min_ratio * len(payload)``
    or the payload is too small to bother.
    """
    body = payload
    used = CODEC_NONE
    if codec == CODEC_LZ4 and len(payload) >= MIN_COMPRESS_BYTES:
        comp = zlib.compress(payload, 1)
        cbody = encode_varint(len(comp)) + comp
        target = int(len(payload) * model_ratio(len(payload)))
        if len(cbody) < target:
            cbody += b"\x00" * (target - len(cbody))
        if len(cbody) < len(payload) * min_ratio:
            body = cbody
            used = CODEC_LZ4
            if device is not None:
                device.charge_cpu(1 + len(payload) // 8192)
    env = (bytes((used,)) + encode_varint(len(payload))
           + encode_varint(len(body))
           + zlib.crc32(body).to_bytes(_CRC_LEN, "little") + body)
    if stats is not None:
        stats.note_encode(label, len(payload), len(env), used != CODEC_NONE)
    return env


def decode_block(buf: bytes, pos: int = 0, *,
                 stats: Optional[BlockCodecStats] = None,
                 fid: Optional[int] = None,
                 offset: Optional[int] = None,
                 device=None) -> Tuple[bytes, int]:
    """Decode one envelope at ``buf[pos:]``; return (payload, end_pos).

    Raises :class:`BlockCorruptionError` on any checksum or structural
    mismatch — never returns damaged bytes.
    """
    try:
        codec = buf[pos]
        raw_len, p = decode_varint(buf, pos + 1)
        body_len, p = decode_varint(buf, p)
        crc = int.from_bytes(buf[p:p + _CRC_LEN], "little")
        p += _CRC_LEN
        body = bytes(buf[p:p + body_len])
        end = p + body_len
        if len(body) != body_len:
            raise ValueError("truncated block body")
    except (IndexError, ValueError) as exc:
        if stats is not None:
            stats.corrupt_blocks += 1
        raise BlockCorruptionError(f"malformed block envelope: {exc}",
                                   fid, offset if offset is not None else pos)
    if zlib.crc32(body) != crc:
        if stats is not None:
            stats.corrupt_blocks += 1
        raise BlockCorruptionError("block checksum mismatch",
                                   fid, offset if offset is not None else pos)
    if codec == CODEC_NONE:
        payload = body
    elif codec == CODEC_LZ4:
        try:
            clen, q = decode_varint(body, 0)
            payload = zlib.decompress(body[q:q + clen])
        except (IndexError, zlib.error) as exc:
            if stats is not None:
                stats.corrupt_blocks += 1
            raise BlockCorruptionError(f"block decompress failed: {exc}",
                                       fid,
                                       offset if offset is not None else pos)
        if device is not None:
            device.charge_cpu(1 + len(payload) // 8192)
    else:
        if stats is not None:
            stats.corrupt_blocks += 1
        raise BlockCorruptionError(f"unknown block codec {codec}",
                                   fid, offset if offset is not None else pos)
    if len(payload) != raw_len:
        if stats is not None:
            stats.corrupt_blocks += 1
        raise BlockCorruptionError("block length mismatch after decode",
                                   fid, offset if offset is not None else pos)
    if stats is not None:
        stats.blocks_decoded += 1
    return payload, end


def iter_blocks(buf: bytes, *, stats: Optional[BlockCodecStats] = None,
                fid: Optional[int] = None, base_offset: int = 0,
                device=None) -> Iterator[Tuple[int, bytes]]:
    """Walk a byte range of back-to-back envelopes.

    Yields ``(offset, payload)`` with ``offset`` relative to ``base_offset``
    (i.e. the device offset of each envelope when ``base_offset`` is the
    read position).
    """
    pos = 0
    while pos < len(buf):
        start = pos
        payload, pos = decode_block(buf, pos, stats=stats, fid=fid,
                                    offset=base_offset + start, device=device)
        yield base_offset + start, payload
