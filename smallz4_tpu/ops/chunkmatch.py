"""Chunk-merge device matcher: the production device encode kernel.

The reference's hot loop (smallz4.h:173-255,603-744) is a per-position
hash-chain walk.  This module re-derives the search as sort/compare work
over *chunks* of 64 Ki positions, in plain jnp/lax (XLA fuses every
elementwise stage):

  1. **sort once per chunk** — every chunk is sorted a single time
     (``lax.sort``, ops/sortnet.py) into true byte-lexicographic 20-byte
     suffix order: key = (bytes 0..19 packed big-endian as five words,
     then pos), so equal-prefix groups at every depth <= 20 are
     contiguous and pos-sorted.
  2. **merge with the left neighbor** — the 64 KB window means a
     chunk's candidates live in itself and its left neighbor; the two
     sorted record sets are merged by one ``lax.sort`` of their
     concatenation (on the GPU as fast as a bitonic merge of the halves).
     Every chunk's sort depends only on its own bytes, so a whole group
     of chunks is sorted, merged, probed and packed in one batched call.
  3. **probe** sorted neighbors at static offsets (contiguous 1..8 plus a
     sparse far set): in suffix order the highest-LCP candidates are the
     nearest neighbors; each probe is byte-verified to LCP 20.  Probe
     LCPs are *composed* (PROBE_LCP): one adjacent-pair LCP plane + a
     log-step sparse min-table yields every probe's capped LCP via the
     suffix-array min property — bit-identical to the direct per-probe
     5-word compare (the cut exclusion rides a spare combo bit so probes
     shift one plane).  Claim lengths are clamped to the block match cap
     *before* the nearest-distance tie-break (reference cap-then-tie
     semantics, smallz4.h:178,229-232).
  4. **place** the current chunk's records back in position order with
     one scatter (a record's local position is a permutation of the
     chunk; the halo chunk's records drop out).
  5. **chain** same-distance claims in position order (log-step
     doubling) — verified 20-byte claims extend into exact unbounded
     match lengths; distance-1 byte runs resolve the same way.

Record planes (6 x int32 per record):
  k1, e1, e2,
  x1, x2     = bytes pos+0..19 packed big-endian (all five are sort
               keys: byte 0 is the most significant, so uint32 order ==
               byte order; the same words double as the byte-verify
               reach)
  combo      = invalid(bit31) | pos (bits [16:0]) — final sort key;
               bit31 sinks non-candidates to their 20-byte group's tail

Convergence certificates (bit-parity contract, reference nearest-first
semantics; full derivations in docs/PARITY.md):

  * *edge-LCP rule*: in suffix order the capped LCP clcp(a, b) =
    min(LCP(a, b), 20) is non-increasing as b moves away from a (the
    suffix-array min-property for a 20-byte-truncated sort), so if
    clcp(p, edge) < clip(L, 4, 20) on BOTH sides of the contiguous +-8
    window, no unseen candidate can beat the claim or tie it nearer;
  * *split edge rule* (length-only): clcp(p, edge) < clip(L+1, 4, 20)
    certifies the LENGTH alone — a tie at exactly L only spoils the
    distance, which the DP never consumes (see probe_pair's LK block);
  * *backward adoption + induction*: length/full exactness propagates
    backward through decay chains from certified tails;
  * *nearest-sharer gap rule*: equal-key groups are pos-sorted, so the
    -1 neighbor is the nearest >=20-byte sharer; claim_d == gap plus a
    known length >= 20 pins the nearest achiever.

Positions with uncertified LENGTH are refined on the host pre-DP
(native.match_refine); certified-length positions with uncertified
distance are fixed post-DP only where chosen (native.match_refine_dist,
early-stop walk).
"""
from __future__ import annotations

import functools
import os as _os

import jax
import jax.numpy as jnp

from .. import format as fmt
from . import sortnet

CHUNK = 1 << 16          # positions per chunk
POS_BITS = 17
POS_MASK = (1 << POS_BITS) - 1
INVALID_BIT = jnp.int32(-0x80000000)  # bit31 of combo

#: byte-verification words per record.  5 (default) = the 20-byte keys
#: alone; 7 adds two payload planes (bytes 20..27) — measured to cut the
#: real-file pre-DP refine volume 37->30.4% (exp/cheap_rules_sim.py) for
#: ~+33% sort plane moves.  Env-switchable for on-chip A/B.
VERIFY_WORDS = int(_os.environ.get("SMALLZ4_TPU_VERIFY_WORDS", "5"))
assert VERIFY_WORDS in (5, 7), VERIFY_WORDS
LOOK = 4 * VERIFY_WORDS  # lookahead bytes per chunk buffer

#: probe-LCP strategy: "composed" (default) derives every probe's capped
#: LCP from ONE adjacent-pair LCP plane via the suffix-array min property
#: (clcp(i, k) = min of adjacent clcps on a prefix-sorted order) — a
#: sparse min-table replaces the per-probe 6-plane shifted lex compare,
#: cutting the probe stage's plane touches ~2.3x with bit-identical
#: values.  "direct" restores the per-probe full compare (A/B hatch).
PROBE_LCP = _os.environ.get("SMALLZ4_TPU_PROBE_LCP", "composed")
assert PROBE_LCP in ("composed", "direct"), PROBE_LCP

NEAR_PROBES = tuple(range(1, 9))
EDGE = NEAR_PROBES[-1]   # contiguous-window edge (the certificate anchor)
#: sparse far-probe offsets in suffix order.  Composed LCPs price a far
#: probe at ~3 shifted planes (vs 7 direct), so the default set reaches
#: depth 160: measured to cut the strict-window miss rate 60.7->30.7%
#: on real files (exp/reach_sim.py depth sweep), where misses are
#: suffix-order reach-limited.  Env-overridable for A/B.
_far_env = _os.environ.get("SMALLZ4_TPU_FAR_PROBES")
FAR_PROBES = (tuple(int(x) for x in _far_env.split(",")) if _far_env
              else (12, 16, 24, 32, 48, 64, 96, 128, 160))
PROBES = NEAR_PROBES + FAR_PROBES
KEY_REACH = 20           # bytes covered by the lexicographic sort key
                         # (round 5: all five words are keys — same plane
                         # moves as the r4 12-byte sort, only the lex
                         # compare deepens; measured -3pp refine volume
                         # on real files, exp/cheap_rules_sim.py)
EXT_REACH = 4 * VERIFY_WORDS  # byte-verified LCP reach (>= the key words)
CHAIN_STEPS = 16         # doubling covers runs/matches to 64 Ki


def pack_cut_gram(b4: bytes) -> int:
    """Boundary-cut gram in the probe kernel's key encoding (big-endian
    int32, matching make_records' k1 plane)."""
    v = int.from_bytes(b4, "big")
    return v - (1 << 32) if v >= 1 << 31 else v


@functools.partial(jax.jit, static_argnames=("chunk",))
def make_records(buf: jnp.ndarray, valid_lo, valid_hi, chunk: int = CHUNK):
    """Record planes for one chunk.  ``buf`` is uint8[chunk + LOOK] (the
    lookahead bytes are the next chunk's real prefix); positions with
    local index outside [valid_lo, valid_hi) are marked non-candidates.

    Words are packed big-endian so uint32 ascending order == byte
    lexicographic order: the sort becomes a true 20-byte suffix order."""
    c = buf.astype(jnp.uint32)
    g = (c[:-3] << 24) | (c[1:-2] << 16) | (c[2:-1] << 8) | c[3:]
    words = [g[4 * i : chunk + 4 * i] for i in range(VERIFY_WORDS)]
    pos = jnp.arange(chunk, dtype=jnp.int32)
    valid = (pos >= valid_lo) & (pos < valid_hi)
    combo = jnp.where(valid, pos, pos | INVALID_BIT)
    # plane order: 5 key words, combo (final key), then any extra
    # verify-payload words (VERIFY_WORDS == 7)
    return tuple(words[:5]) + (combo.view(jnp.uint32),) + tuple(words[5:])


@functools.partial(jax.jit, static_argnames=("chunk",))
def sort_chunk(buf: jnp.ndarray, valid_lo, valid_hi, chunk: int = CHUNK):
    """Sort one chunk's records into byte-lexicographic 20-byte suffix
    order: (bytes 0..19, invalid flag, pos) — every record word is a sort
    key, so equal-prefix groups at ALL depths up to 20 are contiguous
    and pos-sorted (the nearest-sharer gap rule's premise)."""
    planes = make_records(buf, valid_lo, valid_hi, chunk=chunk)
    # combo embeds pos -> the 6-plane key is distinct per record (no
    # separate tiebreak); extra verify-payload planes (VERIFY_WORDS == 7)
    # ride along
    return sortnet.sort_records(*planes, n_keys=6, unique=True)


@functools.partial(jax.jit, static_argnames=("chunk",))
def empty_halo(chunk: int = CHUNK):
    """All-invalid sorted halo planes (stream start / legacy block start:
    no history carries in)."""
    return sort_chunk(jnp.zeros(chunk + LOOK, jnp.uint8),
                      jnp.int32(0), jnp.int32(0), chunk=chunk)


def _lcp_be(xors) -> jnp.ndarray:
    """Byte LCP (0..4*len(xors)) from XORed big-endian word pairs."""
    def bc(x):  # leading equal bytes of one BE xor word
        b0 = ((x >> 24) & 0xFF) != 0
        b1 = ((x >> 16) & 0xFF) != 0
        b2 = ((x >> 8) & 0xFF) != 0
        return jnp.where(b0, 0, jnp.where(b1, 1, jnp.where(b2, 2,
                         jnp.where(x != 0, 3, 4)))).astype(jnp.int32)

    lcp = bc(xors[0])
    for i, x in enumerate(xors[1:], start=1):
        lcp = jnp.where(lcp == 4 * i, 4 * i + bc(x), lcp)
    return lcp


def _flat_shift(x: jnp.ndarray, k: int, fill=0) -> jnp.ndarray:
    """out[i] = x[i + k] (k may be negative); ``fill`` where i + k falls
    outside the plane — a static slice + concat."""
    n = x.shape[0]
    if k == 0:
        return x
    if abs(k) >= n:
        return jnp.full_like(x, fill)
    pad = jnp.full((abs(k),), fill, x.dtype)
    if k > 0:
        return jnp.concatenate([x[k:], pad])
    return jnp.concatenate([pad, x[:k]])


def _probe(planes, cut_gram, cut_pos, match_limit, chunk):
    """Neighbor probes over merged suffix-ordered int32 planes (plane
    order: 5 key words, combo, extra verify words if any).

    Returns payload (best_len<<16 | best_dist; len clamped to the block
    cap BEFORE the nearest tie-break — reference cap-then-tie semantics)
    and key ((raw - chunk)<<4 | flags for current-chunk records, 16*chunk
    for halo records; flags bit0 length-truncated (= EXT_REACH with cap
    beyond it), bit1 edge-LCP certificate failed, bit2 length-only edge
    certificate failed (split rule: a tie at exactly L only spoils the
    distance, so length is exact iff nothing unseen shares L+1), bit3
    claim distance == nearest >=KEY_REACH-byte-sharer gap (the -1
    in-group neighbor: equal-key runs are pos-sorted, so it IS the
    nearest sharer)).
    """
    k1 = planes[0]
    combo = planes[5]
    vw = planes[:5] + planes[6:]  # the VERIFY_WORDS byte words, in order
    n = k1.shape[0]
    slot = jnp.arange(n, dtype=jnp.int32)

    raw = combo & POS_MASK
    local = raw - chunk           # >= 0 for current-chunk records
    # block match cap in claim space (halo records: unbounded — their
    # claims are dropped by the placement scatter anyway)
    cap = jnp.where(local >= 0, jnp.maximum(match_limit - local, 0),
                    jnp.int32(1 << 30))

    best_len = jnp.zeros_like(k1)
    best_dist = jnp.zeros_like(k1)
    elcp_lo = jnp.full_like(k1, -1)   # capped LCP with the -EDGE record
    elcp_hi = jnp.full_like(k1, -1)   # capped LCP with the +EDGE record
    gap = jnp.zeros_like(k1)          # distance to the -1 >=20-sharer

    composed = PROBE_LCP == "composed"
    if composed:
        # Composed probe LCPs (suffix-array min property): the merged
        # planes are sorted by the 20-byte key, so for slots a < c the
        # KEY_REACH-capped LCP obeys clcp(a, c) = min over adjacent
        # clcp(i, i+1) — one adjacent-LCP plane plus a log-step sparse
        # min-table replaces the per-probe 5-word shifted compare.  The
        # composed values are EXACTLY the direct ones (min caps compose:
        # min(min(x,20), min(y,20)) == min(min(x,y), 20)); beyond-key
        # verify words (VERIFY_WORDS == 7) extend per probe below, where
        # the key-capped LCP proves 20 shared bytes first.
        nb1 = [_flat_shift(w, 1) for w in vw[:5]]
        lcp_adj = _lcp_be([w ^ nb for w, nb in zip(vw[:5], nb1)])
        mtab = {1: lcp_adj}           # mtab[e][s] = min lcp_adj[s, s+e)
        e = 1
        while 2 * e <= max(PROBES):
            mtab[2 * e] = jnp.minimum(mtab[e], _flat_shift(mtab[e], e))
            e *= 2

        def window_min(width):
            """min lcp_adj over [s, s+width) — binary decomposition."""
            r, off = None, 0
            for e in sorted(mtab, reverse=True):
                if width & e:
                    part = mtab[e] if off == 0 else _flat_shift(mtab[e], off)
                    r = part if r is None else jnp.minimum(r, part)
                    off += e
            return r

        # boundary-cut exclusion rides the combo plane (bit 29 is free:
        # combo = invalid(31) | pos[16:0]) so probes shift ONE plane
        # instead of re-deriving the cut test from a shifted k1
        cut_hit_self = (k1 == cut_gram) & (raw < cut_pos)
        combo_probe = combo | jnp.where(cut_hit_self, jnp.int32(1) << 29,
                                        jnp.int32(0))

    for sk in PROBES:
        if composed:
            wmin = window_min(sk)
        for sgn in (1, -1):
            k = sk * sgn
            in_range = (slot + k >= 0) & (slot + k < n)
            if composed:
                lcp = wmin if sgn > 0 else _flat_shift(wmin, -sk)
                if VERIFY_WORDS > 5:
                    ext = _lcp_be([w ^ _flat_shift(w, k) for w in vw[5:]])
                    lcp = jnp.where(lcp >= KEY_REACH, KEY_REACH + ext, lcp)
                nb_combo = _flat_shift(combo_probe, k)
                cut_hit = ((nb_combo >> 29) & 1) != 0
            else:
                nb_vw = [_flat_shift(w, k) for w in vw]
                nb_k1 = nb_vw[0]
                nb_combo = _flat_shift(combo, k)
                lcp = _lcp_be([w ^ nb for w, nb in zip(vw, nb_vw)])
            if sk == EDGE:
                # certificate anchor: capped LCP with the contiguous
                # window's outermost record, regardless of its validity
                # (suffix-order monotonicity bounds everything beyond)
                e12 = jnp.where(in_range, jnp.minimum(lcp, KEY_REACH),
                                jnp.int32(-1))
                if sgn > 0:
                    elcp_hi = e12
                else:
                    elcp_lo = e12
            nb_raw = nb_combo & POS_MASK
            d = raw - nb_raw
            if sk == 1 and sgn == -1:
                # nearest >=KEY_REACH-byte sharer: the -1 neighbor when
                # it shares the full sort key (groups are pos-sorted,
                # valid records ahead of invalid ones)
                gap = jnp.where(in_range & (nb_combo >= 0) & (d >= 1)
                                & (lcp >= KEY_REACH), d, 0)
            ok = (in_range & (nb_combo >= 0) & (d >= 1)
                  & (d <= fmt.MAX_DISTANCE)
                  & ~(cut_hit if composed
                      else (nb_k1 == cut_gram) & (nb_raw < cut_pos)))
            lcp_eff = jnp.minimum(jnp.where(ok, lcp, 0), cap)
            better = (lcp_eff > best_len) | (
                (lcp_eff == best_len) & (lcp_eff >= 1) & (d < best_dist))
            best_len = jnp.where(better & ok, lcp_eff, best_len)
            best_dist = jnp.where(better & ok, d, best_dist)

    # edge-LCP certificate: an unseen record beyond the +-EDGE window
    # shares at most clcp(p, edge) bytes (capped-LCP monotonicity of the
    # suffix order); < clip(L, 4, KEY_REACH) on both sides rules out any beater
    # or equal-length-nearer candidate.  Claims are exact when also
    # byte-verified (L < EXT_REACH) or clamped at the block cap.
    th = jnp.clip(best_len, fmt.MIN_MATCH, KEY_REACH)
    cert_fail = (elcp_lo >= th) | (elcp_hi >= th)
    # split rule (length-only): an unseen sharer of exactly L can tie but
    # not beat — the LENGTH is exact iff nothing unseen shares L+1.
    # Only decidable below the key reach.
    th_len = jnp.clip(best_len + 1, fmt.MIN_MATCH, KEY_REACH)
    len_fail = ((elcp_lo >= th_len) | (elcp_hi >= th_len)
                | (best_len >= KEY_REACH))
    gap_hit = (best_dist == gap) & (gap >= 1)
    trunc = (best_len >= EXT_REACH) & (cap > EXT_REACH)
    flags = (trunc.astype(jnp.int32)
             | (cert_fail.astype(jnp.int32) << 1)
             | (len_fail.astype(jnp.int32) << 2)
             | (gap_hit.astype(jnp.int32) << 3))
    payload = (best_len << 16) | best_dist
    key = jnp.where(local >= 0, (local << 4) | flags, jnp.int32(16 * chunk))
    return payload, key


def _compact(keep: jnp.ndarray, vals: jnp.ndarray):
    """Order-preserving compaction of ``vals[keep]`` to the front of a
    plane of the same size (zeros behind); returns (plane, count)."""
    n = vals.shape[0]
    rank = jnp.cumsum(keep, dtype=jnp.int32) - 1
    idx = jnp.where(keep, rank, n)  # dropped slots scatter out of range
    return (jnp.zeros_like(vals).at[idx].set(vals, mode="drop"),
            rank[-1] + 1)


def _bitmask_words(flag: jnp.ndarray) -> jnp.ndarray:
    """Pack the low bit of each slot into int32 words: bit i of word w =
    slot 32w+i (numpy ``packbits(bitorder="little")`` layout)."""
    bits = (flag.reshape(-1, 32).astype(jnp.uint32) & 1) << jnp.arange(
        32, dtype=jnp.uint32)
    return jnp.sum(bits, axis=1, dtype=jnp.uint32).view(jnp.int32)


@functools.partial(jax.jit, static_argnames=("chunk",))
def pack_results(lens: jnp.ndarray, dists: jnp.ndarray, conv: jnp.ndarray,
                 lk: jnp.ndarray, chunk: int = CHUNK):
    """Head/delta packing of the position-order match arrays — shrinks the
    device->host result traffic ~6x.  A position is *predicted* when its
    claim continues the predecessor's match: (len-1, same dist) after
    len >= 5, or (65535, same dist) after a saturated 65535 claim (giant
    byte runs would otherwise make every position a head and overflow
    HEAD_CAP), else literal (1, 0).  Unpredicted positions are heads.

    Returns (head bitmask words [chunk/32], compacted len16|dist16 head
    words [chunk] (zeros past the heads), n_heads, conv bitmask words,
    lk bitmask words).  Host inverse: unpack_results."""
    lens = lens.astype(jnp.int32)
    dists = dists.astype(jnp.int32)
    prev_len = _flat_shift(lens, -1)
    prev_dist = _flat_shift(dists, -1)
    pred_len = jnp.where(prev_len == 65535, 65535,
                         jnp.where(prev_len >= 5, prev_len - 1, 1))
    pred_dist = jnp.where(prev_len >= 5, prev_dist, 0)
    slot = jnp.arange(chunk, dtype=jnp.int32)
    head = (lens != pred_len) | (dists != pred_dist) | (slot == 0)
    payload = (jnp.minimum(lens, 65535) << 16) | (dists & 0xFFFF)
    packed, n_heads = _compact(head, payload)
    return (_bitmask_words(head), packed, n_heads, _bitmask_words(conv),
            _bitmask_words(lk))


def unpack_bits_rows(bits, chunk):
    """Bitmask words [R, chunk//32] -> bool [R, chunk]."""
    import numpy as np

    words = np.ascontiguousarray(np.asarray(bits)).astype(np.uint32)
    R = words.shape[0]
    return np.unpackbits(words.view(np.uint8).reshape(R, -1), axis=1,
                         bitorder="little")[:, :chunk].astype(bool)


def _unpack_bits(bits, chunk):
    import numpy as np

    return unpack_bits_rows(np.asarray(bits)[None], chunk)[0]


def unpack_rows(bits, packed, chunk: int = CHUNK):
    """Vectorized numpy inverse of pack_results over stacked rows.

    bits: int-like [R, chunk//32] head bitmask words; packed: [R, >=1]
    compacted head words (rows with more heads than packed columns are the
    caller's overflow problem — their output is garbage here).  Returns
    (lens, dists) as int32 [R, chunk].

    Decay-fill: from each head, len decreases by 1 and dist holds until the
    prediction floors at the literal (1, 0)."""
    import numpy as np

    words = np.ascontiguousarray(np.asarray(bits)).astype(np.uint32)
    R = words.shape[0]
    head = np.unpackbits(words.view(np.uint8).reshape(R, -1), axis=1,
                         bitorder="little")[:, :chunk].astype(bool)
    pos = np.arange(chunk, dtype=np.int32)
    seg = np.cumsum(head, axis=1, dtype=np.int32) - 1  # head rank per pos
    start = np.maximum.accumulate(np.where(head, pos, 0), axis=1)
    pk = np.asarray(packed)
    vals = np.take_along_axis(pk, np.minimum(seg, pk.shape[1] - 1), axis=1)
    base = (vals >> 16) & 0xFFFF
    fill = base - (pos - start)
    # saturated heads (65535) predict 65535 until the next head
    fill = np.where(base == 65535, 65535, fill)
    lens = np.where(fill >= fmt.MIN_MATCH, fill, 1).astype(np.int32)
    dists = np.where(lens >= fmt.MIN_MATCH, vals & 0xFFFF, 0).astype(np.int32)
    return lens, dists


def unpack_results(bits, packed, chunk: int = CHUNK):
    """Numpy inverse of pack_results: rebuild full lens/dists arrays."""
    import numpy as np

    l, d = unpack_rows(np.asarray(bits)[None], np.asarray(packed)[None],
                       chunk=chunk)
    return l[0], d[0]


HEAD_CAP = 1 << 15  # fetched head slots per chunk (overflow -> host redo).
                    # Text-heavy corpora run ~19-29 K heads per 64 Ki chunk
                    # (claim-change density), so 2^14 forced whole-chunk
                    # host redos; 2^15 covers everything measured while the
                    # adaptive fetch (collect_block) still ships only the
                    # realized head count.
GROUP = 64          # chunks per match_chunks call (4 MB at CHUNK = 64 Ki):
                    # one dispatch + one result fetch per default block


def _group_cuts(cut_gram, cut_pos, n_chunks):
    """Per-chunk boundary cuts: scalars bind to chunk 0 only (the pipeline
    contract), int32[n_chunks] arrays give every chunk its own."""
    cut_gram = jnp.asarray(cut_gram, jnp.int32)
    cut_pos = jnp.asarray(cut_pos, jnp.int32)
    if cut_gram.ndim == 1:
        return cut_gram, cut_pos
    idx = jnp.arange(n_chunks, dtype=jnp.int32)
    return (jnp.where(idx == 0, cut_gram, 0),
            jnp.where(idx == 0, cut_pos, -1))


def _group_claims(halo, bufs, cand_hi, valid_hi, match_limit, cut_gram,
                  cut_pos, n_chunks, chunk):
    """Claims for a group of consecutive chunks in one batched pass.  Each
    chunk's sorted planes are a function of its own bytes, so every chunk
    is sorted at once and chunk j's halo is chunk j-1's sorted planes
    (``halo`` for chunk 0).  Returns (next_halo, (lens, dists, conv, lk)
    stacked over chunks)."""
    cgs, cps = _group_cuts(cut_gram, cut_pos, n_chunks)
    curs = jax.vmap(functools.partial(sort_chunk, chunk=chunk),
                    in_axes=(0, None, 0))(bufs, jnp.int32(0), cand_hi)
    halos = tuple(jnp.concatenate([h[None], c[:-1]])
                  for h, c in zip(halo, curs))
    claims = jax.vmap(functools.partial(probe_pair, chunk=chunk),
                      in_axes=(0, 0, 0, 0, None, 0, 0))(
        halos, curs, cgs, cps, jnp.int32(0), valid_hi, match_limit)
    return tuple(c[-1] for c in curs), claims


@functools.partial(jax.jit, static_argnames=("n_chunks", "head_cap", "chunk"))
def match_chunks(
    halo,                  # sorted planes of the chunk preceding bufs[0]
    bufs,                  # uint8[n_chunks, chunk + LOOK]
    cand_hi,               # int32[n_chunks]: candidate validity end (local)
    valid_hi,              # int32[n_chunks]: claim validity end (local)
    match_limit,           # int32[n_chunks]: block match cap (local coords)
    cut_gram,              # int32: boundary-cut gram for chunk 0 (see below)
    cut_pos,               # int32: cut pos in halo-local coords (-1: off)
    n_chunks: int = GROUP,
    head_cap: int = HEAD_CAP,
    chunk: int = CHUNK,
):
    """The device encode path for ``n_chunks`` consecutive chunks: each
    sorted once and probed against its merge with its predecessor's
    sorted records, results head/delta-packed on device.

    Returns (next_halo, (bits, packed[:head_cap], n_heads, conv_bits,
    lk_bits)) with the results stacked over chunks; next_halo (the last
    chunk's sorted planes) chains the following call with zero host
    round-trips.  Scalar ``cut_gram``/``cut_pos`` apply to chunk 0 only
    (block starts align with call boundaries; the pipeline contract);
    int32[n_chunks] arrays give every chunk its own boundary cut (the
    sharded driver's contract, where one call spans several block
    starts).
    """
    next_halo, (lens, dists, conv, lk) = _group_claims(
        halo, bufs, cand_hi, valid_hi, match_limit, cut_gram, cut_pos,
        n_chunks, chunk)
    bits, packed, n_heads, cbits, kbits = jax.vmap(
        functools.partial(pack_results, chunk=chunk))(lens, dists, conv, lk)
    return next_halo, (bits, packed[:, :head_cap], n_heads, cbits, kbits)


@functools.partial(jax.jit, static_argnames=("n_chunks", "chunk"))
def match_chunks_raw(
    halo, bufs, cand_hi, valid_hi, match_limit, cut_gram, cut_pos,
    n_chunks: int = GROUP, chunk: int = CHUNK,
):
    """match_chunks without the head/delta pack: returns the raw claim
    planes (lens u16, dists u16, conv bool, lk bool) per chunk, kept ON
    DEVICE — the front half of the device-resident encode (match ->
    ops.parse DP -> ops.emit), where claims feed the device DP instead
    of crossing the host link."""
    return _group_claims(halo, bufs, cand_hi, valid_hi, match_limit,
                         cut_gram, cut_pos, n_chunks, chunk)


@functools.partial(jax.jit, static_argnames=("chunk",))
def probe_pair(
    halo,                 # (k1, e1, e2, x1, x2, combo) sorted planes of chunk i-1
    cur,                  # same for chunk i
    cut_gram,             # int32: gram at the boundary-cut position
    cut_pos,              # int32: local pos of the cut in the halo (-1: off)
    valid_lo,             # int32: first searchable local pos of chunk i
    valid_hi,             # int32: one past last candidate pos of chunk i
    match_limit,          # int32: block match cap in chunk-i local coords
    chunk: int = CHUNK,
):
    """Match search for every position of chunk i against the merged
    (chunk i-1, chunk i) candidate set.  Returns (lens u16, dists u16,
    conv bool, lk bool) of shape [CHUNK] in position order — ``conv``
    is the full (len + nearest-dist) certificate, ``lk`` the length-only
    certificate (see the LK block below: DP parity needs only lengths;
    distances are fixed post-DP at chosen positions)."""
    merged = _merge_pair(halo, cur, chunk)
    p_pay, p_key = _probe(
        [m.view(jnp.int32) if m.dtype == jnp.uint32 else m for m in merged],
        jnp.asarray(cut_gram, jnp.int32), jnp.asarray(cut_pos, jnp.int32),
        jnp.asarray(match_limit, jnp.int32), chunk)
    flags0, lens0, dists0 = _place(p_key, p_pay, chunk)
    return _certify(flags0, lens0, dists0, cut_pos, valid_lo, valid_hi,
                    match_limit, chunk)


def _merge_pair(halo, cur, chunk):
    """Merged (halo, current) sorted planes.  Chunk i positions rebase to
    [chunk, 2*chunk); combo is the final key, so halo records keep sorting
    ahead of current-chunk records inside equal-20-byte groups (pos order
    preserved)."""
    cur_list = list(cur)
    cur_list[5] = (cur[5].view(jnp.int32) + chunk).view(jnp.uint32)
    planes = [jnp.concatenate([h, c]) for h, c in zip(halo, cur_list)]
    return sortnet.sort_records(*planes, n_keys=6, unique=True)


def _place(p_key, p_pay, chunk):
    """Back to position order: (key >> 4) is the local position of every
    current-chunk record (a permutation of [0, chunk)); halo records carry
    16*chunk and scatter out of range.  Returns (flags, lens, dists)."""
    at = p_key >> 4
    s_key = jnp.zeros(chunk, jnp.int32).at[at].set(p_key, mode="drop")
    s_pay = jnp.zeros(chunk, jnp.int32).at[at].set(p_pay, mode="drop")
    return s_key & 15, (s_pay >> 16) & 0xFFFF, s_pay & 0xFFFF


def _certify(flags0, lens0, dists0, cut_pos, valid_lo, valid_hi,
             match_limit, chunk):
    """Position-order claims -> (lens u16, dists u16, conv, lk): chain
    doubling, block caps and the convergence certificates."""
    # same-distance doubling: 20-byte claims extend to exact full lengths
    # (distance-1 byte runs resolve here too); claims stay byte-verified
    lens1 = lens0
    s = 1
    for _ in range(CHAIN_STEPS):
        nb_len = _flat_shift(lens1, s, 0)
        nb_dist = _flat_shift(dists0, s, 0)
        grow = (nb_dist == dists0) & (dists0 >= 1) & (lens1 >= s)
        lens1 = jnp.where(grow, jnp.maximum(lens1, s + nb_len), lens1)
        s *= 2

    pos = jnp.arange(chunk, dtype=jnp.int32)
    valid = (pos >= valid_lo) & (pos < valid_hi)
    cap = jnp.maximum(match_limit - pos, 0)
    lens2 = jnp.minimum(lens1, cap)
    match = valid & (lens2 >= fmt.MIN_MATCH)
    lens = jnp.where(match, lens2, 1)
    dists = jnp.where(match, dists0, 0)

    truncated = (flags0 & 1) != 0
    cert_fail = (flags0 & 2) != 0
    len_fail = (flags0 & 4) != 0
    gap_hit = (flags0 & 8) != 0
    conv = (~truncated & ~cert_fail) | ~valid
    # a d=1 claim at the true block cap is complete and provably the
    # nearest achiever; farther at-cap claims stay unconverged (the
    # reference keeps the nearest among equally long matches)
    conv = conv | (match & (lens2 >= cap) & (dists0 == 1))

    # Backward induction certificate (proof in docs/PARITY.md): a byte-
    # verified claim (L, d) at p with an EXACT (L-1, d) at p+1 and L
    # strictly below p's block cap is itself exact — any longer window
    # candidate at p would shift to a >L-1 candidate at p+1 (same d,
    # still in-window), contradicting p+1's exactness, and every exact-L
    # achiever at p shifts into p+1's (L-1)-achiever set, so p+1's
    # nearest-achiever distance lower-bounds p's, which claim d attains.
    # Certifies whole match runs from their certified tails (the per-
    # position reach/edge rules only certify claims with LCP < 20 or at
    # the block cap — without induction every position covered by a very
    # long match funnels to host refine on match-dense corpora).  log-step
    # propagation over the decay-chain relation.  Disabled when a
    # boundary chain cut is live in this chunk: the shift argument needs
    # candidate reachability to carry from p to p+1, which a cut on
    # gram(p+1) can break (1/64 of chunks at the default layout).
    chain_ok = (match & (lens2 >= fmt.MIN_MATCH + 1) & (lens2 < cap)
                & (_flat_shift(lens2, 1, 0) == lens2 - 1)
                & (_flat_shift(dists, 1, 0) == dists)
                & (cut_pos < 0))
    c = conv
    ok = chain_ok
    s = 1
    for _ in range(CHAIN_STEPS):
        c = c | (ok & _flat_shift(c, s, False))
        ok = ok & _flat_shift(ok, s, False)
        s *= 2
    conv = c

    # --- length-known certificate (LK): the length/distance split ---
    # The optimal parser consumes only LENGTHS (an LZ4 match costs the
    # same bytes at any distance; the sole distance-sensitive DP rule is
    # the MaxSameLetter run shortcut, excluded below), so DP bit-parity
    # needs exact lengths everywhere but exact nearest-of-max distances
    # only at DP-chosen positions (fixed post-DP by an early-stop host
    # walk).  Anchors — positions whose claim LENGTH is provably the
    # reference's max:
    #   * conv (fully exact),
    #   * split edge rule: elcp < clip(L+1, 4, 12) on both sides means
    #     nothing unseen shares L+1 bytes — a tie at exactly L spoils
    #     only the distance (byte-verified claims below the doubling
    #     reach and below cap),
    #   * at-cap claims: the claim's own doubling-verified candidate
    #     reaches the cap, so the clamped length is exact.
    # Adoption (candidate-shift lemma): L*(p) <= L*(p+1) + 1 whenever
    # L*(p) >= 2 — any achiever r of p shifts to candidate r+1 of p+1
    # with the same in-window distance.  Claims are genuine matches, so
    # claim(p) == claim(p+1) + 1 with LK(p+1) forces L*(p) == claim(p).
    # Guards: below cap (cap clamping breaks the shift), below
    # MaxSameLetter (the DP run shortcut reads the distance there), and
    # no live boundary cut (a cut on gram(r+1) breaks the shift lemma).
    msl_ok = lens2 < fmt.MAX_SAME_LETTER
    lenok = ~len_fail & ~truncated & (lens2 < cap) & match
    anchors = (conv | (lenok & msl_ok)
               | (match & (lens2 >= cap) & msl_ok & (cut_pos < 0)))
    adopt_ok = (match & (lens2 >= fmt.MIN_MATCH + 1) & (lens2 < cap)
                & msl_ok
                & (_flat_shift(lens2, 1, 0) == lens2 - 1)
                & (cut_pos < 0))
    lk = anchors
    ok = adopt_ok
    s = 1
    for _ in range(CHAIN_STEPS):
        lk = lk | (ok & _flat_shift(lk, s, False))
        ok = ok & _flat_shift(ok, s, False)
        s *= 2

    # nearest-sharer distance rule: with LK and L >= 12, any candidate
    # nearer than the -1 in-group gap shares < 12 <= L bytes and cannot
    # achieve the max; the claim's own candidate does — so claim_d ==
    # gap IS the nearest achiever.  Lifts LK to full convergence.
    conv = conv | (lk & match & (lens2 >= KEY_REACH) & gap_hit
                   & (cut_pos < 0))
    lk = lk | conv

    saturated = lens > 65535
    conv = conv & ~saturated
    lk = lk & ~saturated
    return (jnp.minimum(lens, 65535).astype(jnp.uint16),
            dists.astype(jnp.uint16), conv, lk)
