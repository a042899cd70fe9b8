"""Reference-exact scalar LZ4 codec (NumPy) — the differential-test anchor.

This module reproduces the *behavior* of the reference encoder/decoder
(gbonneau-hardent/smallz4) bit-for-bit, but with a clean mathematical
formulation instead of the reference's 20-bit hash-chain machinery.

Candidate-set theorem (derived from smallz4.h:603-744 and verified by the
golden-stream tests): for a queried position ``p`` the candidates the
reference's two-level hash chains enumerate are exactly the *inserted* prior
positions q < p with the identical 4-byte gram, at distance p - q <= 65535,
enumerated nearest-first.  Hash collisions only add steps to the reference's
walk, never change its outcome, so exact-gram tables are equivalent.

Semantic fine print the reference implies (all replicated here, each one
empirically confirmed against an instrumented build):

* Insertion set: every position visited by the per-block scan inserts into
  the tables (including the negative-``i`` lookback seeding, smallz4.h:614-624)
  EXCEPT positions covered by the byte-run shortcut (smallz4.h:631-643), which
  ``continue`` before the table update.
* Gate: the greedy/lazy skip counter, the lazy probe, and the match search
  only run at positions whose gate passes — i.e. that HAVE a candidate within
  the window (the chain-construction ``continue``s at smallz4.h:659-673,711-717
  precede the skip logic at smallz4.h:727-733).  Positions without candidates
  pass through without consuming skip state.
* Boundary chain cut: at each modern block boundary the lookback re-inserts
  position ``lastBlock-12``, which was already inserted; the reference then
  stores distance 0 == EndOfChain (smallz4.h:667,676,720), *cutting* that
  position's chain link.  Later queries walking through it stop early.
* Lookback depth is min(dataZero, 12) — so streams shorter than 64 KB use a
  shallower lookback (smallz4.h:615-617).
* Search semantics (smallz4.h:173-255): start from best length 1; a candidate
  improves iff its common-prefix length (capped at block_end-5-p) is
  >= best+1; each improvement consumes one step of the level's budget; the
  walk stops when the budget hits 0, when no longer match can fit, or when
  candidates run out.  Ties in length resolve to the nearest candidate.

Dictionary deviation (documented, intentional): the reference's dictionary
mode emits corrupt streams (ring-slot misalignment, smallz4.h:656 vs :694 —
see SURVEY.md "Reference bugs").  This oracle implements spec semantics
instead: the dictionary's last <= 65535 bytes act as a virtual prefix of the
first block, with no zero-padding.

This code is deliberately simple and scalar; it exists to be *obviously
correct* and to cross-check the native C++ runtime and the device kernels.
Use it on small inputs only.
"""
from __future__ import annotations

import numpy as np

from . import format as fmt

# ---------------------------------------------------------------------------
# gram extraction (shared with the device ops)
# ---------------------------------------------------------------------------

def grams4(data: np.ndarray) -> np.ndarray:
    """uint32 little-endian 4-byte gram starting at each position
    (the last 3 positions have no full gram and are excluded)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if len(data) < 4:
        return np.zeros(0, dtype=np.uint32)
    b = data.astype(np.uint32)
    return b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16) | (b[3:] << 24)


def hash32(grams: np.ndarray) -> np.ndarray:
    """The reference's LCG hash: (x * 48271) >> 12, 20 bits
    (parity: smallz4.h:163-169).  The oracle needs no hashing (exact gram
    grouping); the device bucketed matcher uses this."""
    prod = (grams.astype(np.uint64) * np.uint64(fmt.HASH_MULTIPLIER)) & np.uint64(0xFFFFFFFF)
    return ((prod >> np.uint64(32 - fmt.HASH_BITS)) & np.uint64(fmt.HASH_SIZE - 1)).astype(np.uint32)


def prev_occurrence(grams: np.ndarray) -> np.ndarray:
    """int64 index of the previous position with the same gram, -1 if none.
    Vectorized via stable sort on (gram, position).  This is the
    *unconditional* insertion table — callers that need reference bit-parity
    across 64 KB byte-runs or block boundaries must apply the insertion-set
    and chain-cut rules from the module docstring on top."""
    n = len(grams)
    prev = np.full(n, -1, dtype=np.int64)
    if n == 0:
        return prev
    order = np.argsort(grams, kind="stable")
    sg = grams[order]
    same = sg[1:] == sg[:-1]
    prev[order[1:][same]] = order[:-1][same]
    return prev


# ---------------------------------------------------------------------------
# streaming match finder
# ---------------------------------------------------------------------------

class _MatcherState:
    """Cross-block encoder state over absolute positions of the virtual
    stream (dictionary tail + input).

    Candidate enumeration uses static per-gram *group arrays* (all positions
    sharing a 4-gram, ascending) plus two dynamic flag arrays:

    * ``inserted[p]`` — p entered the tables (run-shortcut positions never do);
    * ``cut[p]``      — p's outgoing chain link is EndOfChain (the boundary
      double-insertion, smallz4.h:667,676,720): a candidate walk that reaches
      p processes it and then stops.

    This is semantically identical to the reference's linked chains but lets
    the walk scan candidates with vectorized slices.
    """

    def __init__(self, buf: np.ndarray, grams: np.ndarray):
        self.buf = buf
        n = len(grams)
        order = np.argsort(grams, kind="stable")  # stable => ascending pos in group
        sg = grams[order]
        new_group = np.empty(n, dtype=bool)
        if n:
            new_group[0] = True
            new_group[1:] = sg[1:] != sg[:-1]
        group_first = np.maximum.accumulate(np.where(new_group, np.arange(n), 0))
        self.sorted_pos = order
        self.group_start = np.empty(n, dtype=np.int64)
        self.rank = np.empty(n, dtype=np.int64)
        self.group_start[order] = group_first
        self.rank[order] = np.arange(n) - group_first
        self.inserted = np.zeros(n, dtype=bool)
        self.cut = np.zeros(n, dtype=bool)
        self.data_zero = 0  # start of retained context (smallz4.h:506,798-805)

    def insert(self, p: int) -> int:
        """Table insert for position p (smallz4.h:646-653).  Returns the
        nearest already-inserted occurrence of p's gram (-1 if none), i.e. the
        reference's ``lastHash`` lookup.  Re-insertion (the block-boundary
        lookback hitting an already-inserted position) cuts p's chain link."""
        if self.inserted[p]:
            self.cut[p] = True  # stored distance 0 == EndOfChain
            return p
        q = self._nearest_inserted(p)
        self.inserted[p] = True
        if q < 0 or p - q > fmt.MAX_DISTANCE:
            self.cut[p] = True  # EndOfChain entry (smallz4.h:659-673)
        return q

    def _nearest_inserted(self, p: int) -> int:
        members = self.sorted_pos[self.group_start[p] : self.group_start[p] + self.rank[p]]
        ins = np.nonzero(self.inserted[members])[0]
        return int(members[ins[-1]]) if len(ins) else -1

    def candidates(self, p: int) -> np.ndarray:
        """Nearest-first candidate list for a query at p: inserted prior
        occurrences within the 64 KB window, truncated after the first
        cut-linked member."""
        members = self.sorted_pos[self.group_start[p] : self.group_start[p] + self.rank[p]]
        w = np.searchsorted(members, p - fmt.MAX_DISTANCE)
        qs = members[w:][::-1]  # nearest-first
        qs = qs[self.inserted[qs]]
        cuts = self.cut[qs]
        if cuts.any():
            qs = qs[: int(np.argmax(cuts)) + 1]
        return qs


def _lcp(buf: np.ndarray, p: int, q: int, cap: int) -> int:
    """Common-prefix length of buf[p:] vs buf[q:], capped (q < p; overlap OK —
    comparing within one fixed buffer gives exactly the RLE semantics)."""
    a = buf[p : p + cap]
    b = buf[q : q + cap]
    neq = np.nonzero(a != b)[0]
    return int(neq[0]) if len(neq) else cap


def _find_longest(
    state: _MatcherState,
    p: int,
    cap: int,
    max_chain: int,
) -> tuple[int, int]:
    """findLongestMatch parity (smallz4.h:173-255): walk candidates
    nearest-first; only improvements (prefix >= best+1) consume steps.
    The scan for the next possible improver is vectorized: a necessary
    condition is buf[q+best] == buf[p+best] (the last byte the reference's
    backward phase 1 checks first)."""
    buf = state.buf
    qs = state.candidates(p)
    best = fmt.JUST_LITERAL
    best_dist = 0
    steps = max_chain
    k = 0
    while k < len(qs):
        if best + 1 > cap:
            break
        target = buf[p + best]
        passers = np.nonzero(buf[qs[k:] + best] == target)[0]
        improved = False
        for j in passers:
            q = int(qs[k + j])
            length = _lcp(buf, p, q, cap)
            if length >= best + 1:
                best = length
                best_dist = p - q
                steps -= 1
                k = k + int(j) + 1
                improved = True
                break
        if not improved or steps == 0:
            break
    return best, best_dist


def _match_block(
    state: _MatcherState,
    block_start: int,
    block_end: int,
    level: int,
    lookback: int,
) -> np.ndarray:
    """Per-position match array for one block, with table insertion —
    the whole per-block scan of smallz4.h:603-747."""
    buf = state.buf
    max_chain = fmt.level_to_max_chain(level)
    bs = block_end - block_start
    matches = np.zeros((bs, 2), dtype=np.int64)  # zero-init like std::vector
    match_limit = block_end - fmt.BLOCK_END_LITERALS

    is_greedy = max_chain <= fmt.SHORT_CHAINS_GREEDY
    is_lazy = (not is_greedy) and max_chain <= fmt.SHORT_CHAINS_LAZY
    skip = 0
    lazy_evaluation = False

    i = -lookback
    while i + fmt.BLOCK_END_NO_MATCH <= bs:
        p = block_start + i
        # byte-run shortcut: continues BEFORE the table insert (smallz4.h:631-643)
        if i > 0 and buf[p] == buf[p - 1]:
            plen, pdist = matches[i - 1]
            if pdist == 1 and plen > fmt.MAX_SAME_LETTER:
                matches[i] = (plen - 1, 1)
                i += 1
                continue
        q = state.insert(p)
        # gate: no candidate in window => no probe and no skip bookkeeping
        # (the chain-construction continues at smallz4.h:659-673,711-717
        # precede the skip branch at smallz4.h:727-733)
        if q == p or q < 0 or p - q > fmt.MAX_DISTANCE:
            i += 1
            continue
        if i < 0:  # lookback seeding only updates tables (smallz4.h:722-724)
            i += 1
            continue
        if skip > 0:  # greedy/lazy skip (smallz4.h:726-733)
            skip -= 1
            if not lazy_evaluation:
                i += 1
                continue
            lazy_evaluation = False
        best, best_dist = _find_longest(state, p, match_limit - p, max_chain)
        matches[i] = (best, best_dist)
        if (is_lazy or is_greedy) and best != fmt.JUST_LITERAL:
            lazy_evaluation = skip == 0
            skip = int(best)
        i += 1
    # trailing positions stay literals (parity: smallz4.h:745-747)
    while 0 <= i < bs:
        matches[i] = (fmt.JUST_LITERAL, 0)
        i += 1
    return matches


# ---------------------------------------------------------------------------
# optimal parse: backward cost DP (parity: smallz4.h:376-472)
# ---------------------------------------------------------------------------

def estimate_costs(matches: np.ndarray) -> None:
    """Backward DP over the block; shortens match lengths in place to the
    cost-optimal choice.  Tie-breaks exactly as the reference: '<=' prefers
    matches over literals and longer matches over shorter (smallz4.h:431-448);
    the distance-1 long-run shortcut takes the full run without scanning
    lengths (smallz4.h:409-416)."""
    n = len(matches)
    cost = np.zeros(n + 1, dtype=np.int64)
    num_literals = fmt.BLOCK_END_LITERALS
    lengths = matches[:, 0]
    dists = matches[:, 1]
    for i in range(n - 1 - fmt.BLOCK_END_LITERALS, -1, -1):
        num_literals += 1
        best_length = fmt.JUST_LITERAL
        min_cost = cost[i + 1] + fmt.JUST_LITERAL
        if num_literals == 15 or (
            num_literals >= 15 + fmt.MAX_LENGTH_CODE
            and (num_literals - 15) % fmt.MAX_LENGTH_CODE == 0
        ):
            min_cost += 1  # this literal starts another length-extension byte
        mlen = int(lengths[i])
        if mlen >= fmt.MAX_SAME_LETTER and dists[i] == 1:
            best_length = mlen
            min_cost = cost[i + mlen] + 1 + 2 + 1 + (mlen - 19) // 255
        elif mlen >= fmt.MIN_MATCH:
            lens = np.arange(fmt.MIN_MATCH, mlen + 1, dtype=np.int64)
            cands = cost[i + fmt.MIN_MATCH : i + mlen + 1] + _extra_cost(lens)
            cmin = int(cands.min())
            if cmin <= min_cost:
                min_cost = cmin
                # ascending scan with '<=' keeps the LAST minimal candidate
                best_length = int(lens[len(cands) - 1 - int(np.argmin(cands[::-1]))])
        cost[i] = min_cost
        lengths[i] = best_length
        if best_length != fmt.JUST_LITERAL:
            num_literals = 0


def _extra_cost(lengths: np.ndarray) -> np.ndarray:
    """Vectorized fmt.match_extra_cost: 3 for len<=18, +1 at 19, +1/255 after."""
    extra = np.full(len(lengths), 3, dtype=np.int64)
    long = lengths > 18
    extra[long] += 1 + (lengths[long] - 19) // fmt.MAX_LENGTH_CODE
    return extra


# ---------------------------------------------------------------------------
# sequence emission (parity: smallz4.h:259-371)
# ---------------------------------------------------------------------------

def select_best_matches(matches: np.ndarray, block: bytes) -> bytes:
    """Serialize the chosen matches into the block's token stream."""
    out = bytearray()
    n = len(matches)
    literals_from = 0
    num_literals = 0
    offset = 0
    while offset < n:
        mlen = int(matches[offset, 0])
        if mlen <= fmt.JUST_LITERAL:
            if num_literals == 0:
                literals_from = offset
            num_literals += 1
            offset += 1
            if offset < n:
                continue
            out += fmt.encode_sequence(
                block[literals_from : literals_from + num_literals], 0, 0
            )
            return bytes(out)
        dist = int(matches[offset, 1])
        out += fmt.encode_sequence(
            block[literals_from : literals_from + num_literals], mlen, dist
        )
        offset += mlen
        num_literals = 0
    if num_literals:  # unreachable for well-formed match arrays
        out += fmt.encode_sequence(
            block[literals_from : literals_from + num_literals], 0, 0
        )
    return bytes(out)


# ---------------------------------------------------------------------------
# frame-level encode (parity: smallz4.h:476-814)
# ---------------------------------------------------------------------------

def compress(
    data: bytes | np.ndarray,
    level: int = 9,
    legacy: bool = False,
    dictionary: bytes | None = None,
    block_size: int | None = None,
    content_checksum: bool = False,
    block_checksum: bool = False,
) -> bytes:
    """Compress ``data`` into a complete LZ4 frame.

    Bit-identical to the reference CLI for all levels 0-9, modern and legacy
    formats (golden tests); dictionary mode is spec-correct (see module doc).
    ``block_size`` overrides the 4 MB (modern) / 8 MB (legacy) default —
    emitting smaller blocks is spec-legal and is how the sharded device path
    tunes its per-device granularity.
    """
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data, dtype=np.uint8).tobytes()
    else:
        data = bytes(data)
    if legacy and dictionary:
        raise ValueError("legacy format doesn't support dictionaries")
    if legacy and level == 0:
        raise ValueError("legacy format doesn't support uncompressed files")
    if (legacy and block_size not in (None, fmt.MAX_BLOCK_SIZE_LEGACY)
            and len(data) > block_size):
        # legacy framing has no per-block size field: a NON-final block
        # decoding to < 8 MB ends the stream (smallz4cat.c:325-327), so a
        # short custom block size on multi-block input would emit an
        # undecodable stream (single-block streams are fine)
        raise ValueError(
            "legacy multi-block streams require the fixed 8 MB block size")
    if block_size is None:
        block_size = fmt.MAX_BLOCK_SIZE_LEGACY if legacy else fmt.MAX_BLOCK_SIZE
    if legacy and (content_checksum or block_checksum):
        raise ValueError("legacy format doesn't support checksums")

    dict_tail = b""
    if dictionary and not legacy:
        dict_tail = bytes(dictionary)[-fmt.MAX_DISTANCE:]
    d = len(dict_tail)
    buf = np.frombuffer(dict_tail + data, dtype=np.uint8)
    n_virtual = len(buf)

    out = bytearray(fmt.build_frame_header(legacy, content_checksum, block_checksum))
    max_chain = fmt.level_to_max_chain(level)
    state = _MatcherState(buf, grams4(buf)) if (not legacy and max_chain) else None

    pos = d  # virtual-stream position
    first = True
    while pos < n_virtual:
        block_end = min(pos + block_size, n_virtual)
        bs = block_end - pos
        block_bytes = buf[pos:block_end].tobytes()
        if max_chain == 0:
            payload, stored = block_bytes, True
        else:
            if legacy:
                # legacy format: fresh tables per block, no cross-block
                # matching (smallz4.h:783-795)
                block_buf = buf[pos:block_end]
                block_state = _MatcherState(block_buf, grams4(block_buf))
                matches = _match_block(block_state, 0, bs, level, lookback=0)
            else:
                if first and d > 0:
                    lookback = d  # seed the whole dictionary (spec semantics)
                else:
                    lookback = min(state.data_zero, fmt.BLOCK_END_NO_MATCH)
                matches = _match_block(state, pos, block_end, level, lookback)
                state.data_zero = max(state.data_zero, block_end - fmt.MAX_DISTANCE)
            if bs > fmt.BLOCK_END_NO_MATCH and max_chain > fmt.SHORT_CHAINS_GREEDY:
                estimate_costs(matches)
            compressed = select_best_matches(matches, block_bytes)
            if len(compressed) < bs or legacy:
                payload, stored = compressed, False
            else:
                payload, stored = block_bytes, True
        out += fmt.build_block_header(len(payload), stored, legacy)
        out += payload
        if block_checksum:
            from .utils.xxhash import xxh32
            out += int.to_bytes(xxh32(payload), 4, "little")
        pos = block_end
        first = False
    out += fmt.build_end_mark(legacy)
    if content_checksum:
        from .utils.xxhash import xxh32
        out += int.to_bytes(xxh32(data), 4, "little")
    return bytes(out)


# ---------------------------------------------------------------------------
# decode (parity: smallz4cat.c:112-360)
# ---------------------------------------------------------------------------

def decompress(
    data: bytes,
    dictionary: bytes | None = None,
    verify: bool = False,
) -> bytes:
    """Decode a complete LZ4 frame (modern or legacy).

    Error behavior parity with the reference decoder: invalid signature,
    unsupported version, zero offset and truncated input all raise
    ``fmt.FormatError`` (smallz4cat.c:123,141,267,91).  Leading skippable
    frames are skipped per the LZ4 frame spec (capability superset: the
    reference rejects them, smallz4cat.c:29-30)."""
    import struct as _struct

    skipped = 0
    while len(data) >= 8:
        magic = _struct.unpack_from("<I", data, 0)[0]
        if (magic & fmt.MAGIC_SKIPPABLE_MASK) != fmt.MAGIC_SKIPPABLE_BASE:
            break
        size = _struct.unpack_from("<I", data, 4)[0]
        if 8 + size > len(data):
            raise fmt.FormatError("out of data")
        data = data[8 + size:]
        skipped += 1
    info = fmt.parse_frame_header(data)
    pos = info.header_size
    out = bytearray()
    dict_tail = bytes(dictionary)[-65536:] if dictionary else b""

    while True:
        if pos + 4 > len(data):
            if info.legacy:
                break  # legacy frames end at EOF (smallz4cat.c:325-327)
            raise fmt.FormatError("out of data")
        size, is_compressed = fmt.parse_block_header(data[pos : pos + 4], info.legacy)
        pos += 4
        if size == 0:
            break
        if pos + size > len(data):
            raise fmt.FormatError("out of data")
        payload = data[pos : pos + size]
        pos += size
        if is_compressed:
            produced = _decode_block(payload, out, dict_tail)
        else:
            out += payload
        if info.has_block_checksum:
            # skipped by default (reference parity: smallz4cat.c:345-349);
            # verified on request (spec superset)
            if verify:
                from .utils.xxhash import xxh32
                if pos + 4 > len(data):
                    raise fmt.FormatError("out of data")
                want = int.from_bytes(data[pos : pos + 4], "little")
                if xxh32(payload) != want:
                    raise fmt.FormatError("block checksum mismatch")
            pos += 4
        if info.legacy and is_compressed and produced < fmt.MAX_BLOCK_SIZE_LEGACY:
            break  # non-full legacy block terminates the stream
    if info.has_content_checksum:
        if verify:
            from .utils.xxhash import xxh32
            if pos + 4 > len(data):
                raise fmt.FormatError("out of data")
            want = int.from_bytes(data[pos : pos + 4], "little")
            if xxh32(bytes(out)) != want:
                raise fmt.FormatError("content checksum mismatch")
        pos += 4
    return bytes(out)


def _decode_block(payload: bytes, out: bytearray, dict_tail: bytes) -> int:
    """Decode one compressed block, appending to ``out``; returns the number
    of bytes produced.  Matches may reference earlier output and the
    dictionary (virtual prefix)."""
    produced0 = len(out)
    n = len(payload)
    bo = 0
    while bo < n:
        token = payload[bo]
        bo += 1
        num_literals = token >> 4
        if num_literals == 15:
            while True:
                if bo >= n:
                    raise fmt.FormatError("out of data")
                cur = payload[bo]
                bo += 1
                num_literals += cur
                if cur != 255:
                    break
        if bo + num_literals > n:
            raise fmt.FormatError("out of data")
        out += payload[bo : bo + num_literals]
        bo += num_literals
        if bo == n:
            break  # last token has only literals
        if bo + 2 > n:
            raise fmt.FormatError("out of data")
        delta = payload[bo] | (payload[bo + 1] << 8)
        bo += 2
        if delta == 0:
            raise fmt.FormatError("invalid offset")
        match_length = 4 + (token & 0x0F)
        if match_length == 19:
            while True:
                if bo >= n:
                    raise fmt.FormatError("out of data")
                cur = payload[bo]
                bo += 1
                match_length += cur
                if cur != 255:
                    break
        ref = len(out) - delta
        if ref < 0:
            # reach into the dictionary (virtual prefix)
            take = min(-ref, match_length)
            dpos = len(dict_tail) + ref
            if dpos < 0:
                raise fmt.FormatError("invalid offset")
            out += dict_tail[dpos : dpos + take]
            match_length -= take
            ref = len(out) - delta
        while match_length > 0:
            # overlap => RLE semantics: copy in chunks of the available span
            span = min(match_length, len(out) - ref)
            out += out[ref : ref + span]
            match_length -= span
            ref += span
    return len(out) - produced0
