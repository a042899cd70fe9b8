"""Host-parallel exact encoder: LZ4 blocks *and sub-block chunks* across
CPU threads.

Two independence properties drive the layout (both proven bit-exact, see
tests/test_host_parallel.py):

1. **Block independence** (64 KB halo => blocks compress independently,
   bit-identical to the sequential stream; same property as the device
   mesh layer, parallel.sharding).
2. **Intra-block chunk independence**: at the non-skipping levels (7-9)
   the match search result at each position depends only on the data in
   its 64 KB window (candidate-set theorem, SURVEY.md) — never on where
   the scan started — so one block's match stage splits into independent
   chunks, each seeded from its own halo.  The only scan-order dependence
   in the reference at those levels is the giant-run shortcut
   (smallz4.h:631-643, triggers when > MaxSameLetter equal bytes remain),
   which is handled by snapping chunk cuts out of shortcut zones.

Chunking removes the load-imbalance tail of whole-block scheduling (e.g.
a 10 MB input is 3 unequal 4 MB blocks — poison for 2 workers) while the
emitted frame keeps full-size blocks: the stream is bit-identical to the
sequential encoder at ANY thread/chunk granularity.

The native matcher releases the GIL, so a thread pool scales the *exact*
-9 search across cores.  This is the framework's fast path when no (or
one slow) accelerator is available, and the post-processing stage
(DP + emit) of the hybrid device pipeline.

Bit-parity domain (same as the sharded path): block_size >= 65548 so the
sequential encoder's lookback at each boundary is the full 12 bytes, and
no byte-run longer than MaxSameLetter crosses a block boundary window.
"""
from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np

from .. import format as fmt

# Sub-block chunk floor: must exceed MAX_DISTANCE + BLOCK_END_NO_MATCH so a
# frame-block boundary cut can only fall inside the window of the block's
# *first* chunk, and large enough that the per-chunk 64 KB halo seeding
# stays a small fraction of the match work.
_MIN_CHUNK = 1 << 19
_RUN_MARGIN = 64  # safety margin around the MaxSameLetter threshold


def _snap_cut(arr: np.ndarray, c: int, end: int) -> int:
    """Move a chunk cut out of a giant-run shortcut zone.

    The sequential encoder copies the previous position's match inside an
    equal-byte run while more than MaxSameLetter run bytes remain
    (smallz4.h:631-643); a chunk base inside that zone would full-search
    instead.  Positions with <= MaxSameLetter - margin run bytes remaining
    are full-searched by both, so cuts snap forward to there.
    """
    if c <= 0 or c >= end or arr[c] != arr[c - 1]:
        return c
    b = arr[c]
    k = c
    while k < end:  # find the run end (vectorized strides)
        stop = min(end, k + (1 << 20))
        nz = np.nonzero(arr[k:stop] != b)[0]
        if nz.size:
            k += int(nz[0])
            break
        k = stop
    if k - c <= fmt.MAX_SAME_LETTER - _RUN_MARGIN:
        return c
    return min(k - (fmt.MAX_SAME_LETTER - _RUN_MARGIN), end)


def compress(
    data: bytes,
    level: int = 9,
    block_size: int = fmt.MAX_BLOCK_SIZE,
    dictionary: bytes | None = None,
    threads: int | None = None,
    chunk_size: int | None = None,
    progress=None,
) -> bytes:
    """Thread-parallel modern-frame compression, bit-identical to the
    sequential native encoder for block_size >= 64 KB + 12."""
    from .. import native

    if block_size < fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH + 1:
        raise ValueError("host-parallel path needs block_size > 64 KB + 12")
    max_chain = fmt.level_to_max_chain(level)
    if level == 0:
        return native.compress(data, 0, block_size=block_size)
    data = bytes(data)
    dict_tail = bytes(dictionary)[-fmt.MAX_DISTANCE:] if dictionary else b""
    d = len(dict_tail)
    n = len(data)
    # one shared buffer, zero-copy views per task; 8 pad bytes keep the
    # matcher's 8-byte-wide gram loads near the end inside the allocation
    varr = np.frombuffer(dict_tail + data + b"\0" * 8, np.uint8)[: d + n]
    darr = varr[d:]

    nthreads = threads or min(32, os.cpu_count() or 1)
    # Levels 7-9 have no skip bookkeeping => the match stage chunks freely;
    # greedy/lazy levels stay block-granular (their scan is order-dependent).
    chunkable = max_chain > fmt.SHORT_CHAINS_LAZY and nthreads > 1
    if chunk_size is None:
        chunk_size = max(_MIN_CHUNK, -(-n // (4 * nthreads)))
    chunk_size = max(chunk_size, _MIN_CHUNK)

    pool = _pool(threads)

    def match_chunk(c0: int, c1: int, block_start: int, block_end: int,
                    lens: np.ndarray, dists: np.ndarray):
        """Fill lens/dists[c0-block_start : c1-block_start] (data coords)."""
        lo = max(c0 + d - fmt.MAX_DISTANCE, 0)
        base = c0 + d - lo
        ctx = varr[lo : block_end + d]
        cut = -1
        if c0 == block_start and block_start >= fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH:
            # sequential boundary chain cut (re-insertion anomaly) at the
            # frame-block boundary; only the first chunk's window sees it
            cut = base - fmt.BLOCK_END_NO_MATCH
        o = c0 - block_start
        native.match_chunk(ctx, base=base, bs=c1 - c0, level=level,
                           lookback=base, cut_pos=cut,
                           block_end=(block_end + d) - lo,
                           lens=lens[o : o + (c1 - c0)],
                           dists=dists[o : o + (c1 - c0)])

    def match_block(start: int, end: int, lens: np.ndarray, dists: np.ndarray):
        bs = end - start
        lo = max(start + d - fmt.MAX_DISTANCE, 0)
        base = start + d - lo
        cut = start >= fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH
        native.match_block_ex(
            varr[lo : end + d], base=base, bs=bs, level=level, lookback=base,
            cut_pos=(base - fmt.BLOCK_END_NO_MATCH) if cut else -1,
            lens=lens, dists=dists,
        )

    # schedule every match task up front; finish blocks in frame order
    blocks = []  # (start, end, lens, dists, [futures])
    for start in range(0, n, block_size):
        end = min(start + block_size, n)
        bs = end - start
        lens = np.zeros(bs, np.int32)
        dists = np.zeros(bs, np.int32)
        futs = []
        if chunkable and bs > chunk_size + _MIN_CHUNK // 2:
            cuts = [start]
            c = start + chunk_size
            while c < end - _MIN_CHUNK // 2:
                c = _snap_cut(darr, c, end)
                if c <= cuts[-1] or c >= end:
                    break
                cuts.append(c)
                c += chunk_size
            cuts.append(end)
            for c0, c1 in zip(cuts, cuts[1:]):
                futs.append(pool.submit(match_chunk, c0, c1, start, end,
                                        lens, dists))
        else:
            futs.append(pool.submit(match_block, start, end, lens, dists))
        blocks.append((start, end, lens, dists, futs))

    out = bytearray(fmt.build_frame_header(False))
    for start, end, lens, dists, futs in blocks:
        for f in futs:
            f.result()
        bs = end - start
        if bs > fmt.BLOCK_END_NO_MATCH and max_chain > fmt.SHORT_CHAINS_GREEDY:
            native.estimate_costs(lens, dists)
        payload = native.emit_block(darr[start:end], lens, dists)
        if len(payload) < bs:
            out += fmt.build_block_header(len(payload), False, False)
            out += payload
        else:
            out += fmt.build_block_header(bs, True, False)
            out += darr[start:end].tobytes()
        if progress is not None:
            progress(end, len(out))
    out += fmt.build_end_mark(False)
    return bytes(out)


_POOL: cf.ThreadPoolExecutor | None = None
_POOL_SIZE = 0


def _pool(threads: int | None) -> cf.ThreadPoolExecutor:
    """Persistent executor: the native matcher keeps ~90 MB of thread-local
    tables warm per worker (reset-free reuse), so threads must outlive
    individual compress() calls."""
    global _POOL, _POOL_SIZE
    want = threads or min(32, os.cpu_count() or 1)
    if _POOL is None or _POOL_SIZE < want:
        _POOL = cf.ThreadPoolExecutor(max_workers=want)
        _POOL_SIZE = want
    return _POOL
