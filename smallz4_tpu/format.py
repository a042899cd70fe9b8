"""LZ4 frame/block format layer: constants, headers, token codec — as data, no kernels.

This module is the single source of truth for every format-level constant and
byte-layout rule of the two container formats the framework speaks:

* the modern LZ4 frame format v1 (magic ``04 22 4D 18``), and
* the legacy format (magic ``02 21 4C 18``).

Behavioral parity notes (reference: gbonneau-hardent/smallz4):
  constants         smallz4.h:85-131
  modern header     smallz4.h:486-495   (flags 0x40: v1, dependent blocks,
                                         no checksums; BD 0x70: 4 MB max block;
                                         precomputed xxhash header byte 0xDF)
  legacy header     smallz4.h:479-483
  block size word   smallz4.h:765-775   (u32 LE, high bit set = stored block)
  end mark          smallz4.h:809-813   (modern only: u32 zero)
  token codec       smallz4.h:259-371 (encode) / smallz4cat.c:207-343 (decode)

Everything here is pure Python/NumPy — serialization stays on the host side of
the host/device boundary by design (byte-order fidelity; see SURVEY.md §7).
"""
from __future__ import annotations

import dataclasses
import struct

# ---------------------------------------------------------------------------
# Core constants (parity: smallz4.h:85-131)
# ---------------------------------------------------------------------------

MIN_MATCH = 4                    # minimum match length
JUST_LITERAL = 1                 # cost/length of a single literal
BLOCK_END_NO_MATCH = 12          # no match may start closer than 12 B to block end
BLOCK_END_LITERALS = 5           # last 5 bytes of a block are always literals

HASH_BITS = 20                   # match-finder hash width
HASH_SIZE = 1 << HASH_BITS
HASH_MULTIPLIER = 48271          # LCG multiplier (smallz4.h:164-169)

MAX_DISTANCE = 65535             # match window (u16 offsets)
END_OF_CHAIN = 0
MAX_CHAIN_LENGTH = MAX_DISTANCE  # "unlimited" chain steps => optimal parsing
MAX_SAME_LETTER = 19 + 255 * 256  # run-shortcut threshold (smallz4.h:118)

MAX_BLOCK_SIZE_ID = 7
MAX_BLOCK_SIZE = 4 * 1024 * 1024
MAX_BLOCK_SIZE_LEGACY = 8 * 1024 * 1024
MAX_LENGTH_CODE = 255

# level thresholds (public API parity: smallz4.h:73-80)
SHORT_CHAINS_GREEDY = 3          # level <= 3: greedy parsing
SHORT_CHAINS_LAZY = 6            # 3 < level <= 6: lazy evaluation

VERSION = "1.5"                  # behavioral parity version (smallz4.h:67-70)

# magic numbers
MAGIC_MODERN = 0x184D2204
MAGIC_LEGACY = 0x184C2102
MAGIC_MODERN_BYTES = struct.pack("<I", MAGIC_MODERN)   # 04 22 4D 18
MAGIC_LEGACY_BYTES = struct.pack("<I", MAGIC_LEGACY)   # 02 21 4C 18
# skippable frames (LZ4 frame spec): 0x184D2A50..0x184D2A5F + u32 size.
# The reference decoder rejects these (doc: smallz4cat.c:29-30); we skip
# them per spec — a strict capability superset.
MAGIC_SKIPPABLE_BASE = 0x184D2A50
MAGIC_SKIPPABLE_MASK = 0xFFFFFFF0

# the exact 7-byte modern frame header the reference emits (smallz4.h:486-495):
# magic + FLG(0x40: version 1, dependent blocks, no checksums, no dict id)
# + BD(0x70: max block size id 7 => 4 MB) + header checksum byte (0xDF,
# precomputed xxhash32 of FLG+BD, second byte, as required by the spec)
FLG_BYTE = 1 << 6
BD_BYTE = MAX_BLOCK_SIZE_ID << 4
HEADER_CHECKSUM_BYTE = 0xDF
MODERN_FRAME_HEADER = MAGIC_MODERN_BYTES + bytes((FLG_BYTE, BD_BYTE, HEADER_CHECKSUM_BYTE))

STORED_FLAG = 0x80000000         # high bit of the block size word => stored
END_MARK = struct.pack("<I", 0)

# worst-case compressed size of a block's token stream:
# every 255 literals need one extra length byte, plus token+len bytes headroom.
def max_compressed_block_size(block_size: int) -> int:
    """Upper bound on the token-stream size of one block (pad-to-bound for
    ragged device outputs; see SURVEY.md §7 'Ragged outputs')."""
    return block_size + block_size // 255 + 16


def level_to_max_chain(level: int) -> int:
    """CLI level -> match-chain step budget (parity: smallz4.cpp:175,232-239).

    Levels 0..8 map to 0..8 accepted-improvement steps; level 9 means
    "unlimited" (65535). Level 0 disables compression entirely.
    """
    if not 0 <= level <= 9:
        raise ValueError(f"compression level must be 0..9, got {level}")
    return MAX_CHAIN_LENGTH if level == 9 else level


# ---------------------------------------------------------------------------
# Frame headers
# ---------------------------------------------------------------------------

def build_frame_header(
    legacy: bool = False,
    content_checksum: bool = False,
    block_checksum: bool = False,
) -> bytes:
    """Serialize the frame header (parity: smallz4.h:479-496).

    With checksums requested, the FLG bits and the header-checksum byte are
    computed properly (the reference hardcodes the no-checksum descriptor's
    byte; we carry a real xxHash32 — utils/xxhash.py)."""
    if legacy:
        return MAGIC_LEGACY_BYTES
    if not (content_checksum or block_checksum):
        return MODERN_FRAME_HEADER
    from .utils.xxhash import frame_header_checksum

    flg = FLG_BYTE | (0x10 if block_checksum else 0) | (0x04 if content_checksum else 0)
    descriptor = bytes((flg, BD_BYTE))
    return MAGIC_MODERN_BYTES + descriptor + bytes((frame_header_checksum(descriptor),))


def build_block_header(payload_size: int, stored: bool, legacy: bool = False) -> bytes:
    """u32 LE block size word; modern stored blocks set the high bit
    (parity: smallz4.h:770-775). Legacy blocks are always 'compressed'."""
    if payload_size >= STORED_FLAG:
        raise ValueError("block payload too large")
    tag = payload_size | (STORED_FLAG if (stored and not legacy) else 0)
    return struct.pack("<I", tag)


def build_end_mark(legacy: bool = False) -> bytes:
    """Modern frames end with a zero-size block; legacy frames just stop
    (parity: smallz4.h:809-813)."""
    return b"" if legacy else END_MARK


@dataclasses.dataclass(frozen=True)
class FrameInfo:
    """Parsed frame header (parity: smallz4cat.c:112-158)."""
    legacy: bool
    has_block_checksum: bool = False
    has_content_size: bool = False
    has_content_checksum: bool = False
    has_dictionary_id: bool = False
    header_size: int = 4          # bytes consumed from the stream


class FormatError(ValueError):
    """Corrupt or unsupported stream (decoder error taxonomy parity:
    smallz4cat.c:49-56,123,141,267)."""


def parse_frame_header(buf: bytes) -> FrameInfo:
    """Parse a frame header from the start of ``buf``.

    Mirrors the reference decoder's handling (smallz4cat.c:112-158): optional
    fields (content size, dictionary id, checksums) are *skipped*, not
    verified; only format version 1 is accepted.
    """
    if len(buf) < 4:
        raise FormatError("out of data")
    magic = struct.unpack_from("<I", buf, 0)[0]
    if magic == MAGIC_LEGACY:
        return FrameInfo(legacy=True, header_size=4)
    if magic != MAGIC_MODERN:
        raise FormatError("invalid signature")
    if len(buf) < 7:
        raise FormatError("out of data")
    flags = buf[4]
    if (flags >> 6) != 1:
        raise FormatError("only LZ4 file format version 1 supported")
    has_block_checksum = bool(flags & 16)
    has_content_size = bool(flags & 8)
    has_content_checksum = bool(flags & 4)
    has_dictionary_id = bool(flags & 1)
    size = 4 + 1 + 1  # magic + FLG + BD
    if has_content_size:
        size += 8
    if has_dictionary_id:
        size += 4
    size += 1  # header checksum byte
    if len(buf) < size:
        raise FormatError("out of data")
    return FrameInfo(
        legacy=False,
        has_block_checksum=has_block_checksum,
        has_content_size=has_content_size,
        has_content_checksum=has_content_checksum,
        has_dictionary_id=has_dictionary_id,
        header_size=size,
    )


def parse_block_header(word: bytes, legacy: bool) -> tuple[int, bool]:
    """-> (payload_size, is_compressed). Parity: smallz4cat.c:192-205."""
    if len(word) < 4:
        raise FormatError("out of data")
    raw = struct.unpack("<I", word[:4])[0]
    if legacy:
        return raw, True
    return raw & 0x7FFFFFFF, (raw & STORED_FLAG) == 0


# ---------------------------------------------------------------------------
# Token / length codec (sequence layer)
# ---------------------------------------------------------------------------

def encode_length_extra(value: int) -> bytes:
    """255-chained extension bytes for a length that overflowed its nibble
    (parity: smallz4.h:326-336, 354-367). ``value`` is the amount beyond 15."""
    out = bytearray()
    while value >= MAX_LENGTH_CODE:
        out.append(MAX_LENGTH_CODE)
        value -= MAX_LENGTH_CODE
    out.append(value)
    return bytes(out)


def encode_sequence(literals: bytes, match_length: int, match_distance: int) -> bytes:
    """Serialize one LZ4 sequence: token, ext literal count, literals,
    offset (u16 LE), ext match length. ``match_length == 0`` encodes the final
    literals-only token (parity: smallz4.h:295-344)."""
    out = bytearray()
    num_literals = len(literals)
    ml_code = 0 if match_length == 0 else match_length - MIN_MATCH
    token = ml_code if ml_code < 15 else 15
    if num_literals < 15:
        out.append(token | (num_literals << 4))
    else:
        out.append(token | 0xF0)
        out += encode_length_extra(num_literals - 15)
    out += literals
    if match_length == 0:
        return bytes(out)
    if not 1 <= match_distance <= MAX_DISTANCE:
        raise ValueError(f"invalid match distance {match_distance}")
    out += struct.pack("<H", match_distance)
    if ml_code >= 15:
        out += encode_length_extra(ml_code - 15)
    return bytes(out)


def sequence_cost(num_literals: int, match_length: int) -> int:
    """Exact byte cost of a serialized sequence — the DP cost model
    (parity: smallz4.h:395-455)."""
    cost = 1 + num_literals  # token + literal bytes
    if num_literals >= 15:
        cost += 1 + (num_literals - 15) // MAX_LENGTH_CODE
    if match_length > 0:
        cost += 2  # offset
        ml_code = match_length - MIN_MATCH
        if ml_code >= 15:
            cost += 1 + (ml_code - 15) // MAX_LENGTH_CODE
    return cost


def match_extra_cost(length: int) -> int:
    """token+offset+extension cost of a match of ``length`` (excludes
    literals): 3 for len<=18, then +1 at 19, +1 per further 255
    (parity: smallz4.h:421-455)."""
    if length <= 18:
        return 3
    return 3 + 1 + (length - 19) // MAX_LENGTH_CODE
