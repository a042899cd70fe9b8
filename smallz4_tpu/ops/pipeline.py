"""The 'tpu' engine: hybrid device/host LZ4 pipeline.

Encode:  device match finder (ops.chunkmatch; ops.match_finder for block
sizes the chunk geometry cannot tile) feeds the host optimal-parse DP +
emitter (native runtime; serial byte-stream
glue stays on the host by design — SURVEY.md §7).  Decode: host sequence
parse feeds the device expansion kernel (ops.decoder).

Stream compatibility: identical framing to the sequential engines; with
the default 4 MB blocks and a fully converged search the compressed stream
is bit-identical to `smallz4 -9`.  Unconverged lanes (more than
``max_candidates`` same-gram occurrences in the window with improvements
still possible) fall back per-block to the native exact matcher when
``parity=True``; otherwise the near-optimal match is kept (stream stays
valid; ratio within noise of -9).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .. import format as fmt
from . import match_finder, decoder

HALO = fmt.MAX_DISTANCE  # 64 KB - 1: the dependent-block history window


def _blocks(n: int, block_size: int):
    return [(i, min(i + block_size, n)) for i in range(0, n, block_size)]


def _deep_run_rule(ctxb, base_r, bs, lens, dists, conv, lk):
    """Host certificate for giant byte runs: when a position's whole 64 KB
    window lies inside one equal-byte run, every window candidate ties at
    e = min(run_rest, cap) and the reference keeps the d=1 achiever —
    except at the single shortcut-lapse position e == MaxSameLetter-1,
    where the reference's insert-skip (smallz4.h:631-643: run interiors
    are never inserted) makes the outcome depend on distant inserts; that
    one position stays refined.  Exact values need no device claim at
    all: run extents come from the raw bytes.  Guards: the position must
    also clear the block-boundary replay/cut region (>= 64 KB + 12 into
    the block).  Validated against the exact matcher in
    exp/cheap_rules_sim.py (V1) and tests/test_chunkmatch.py."""
    a = ctxb
    n_ctx = len(a)
    if n_ctx == 0:
        return
    new = np.empty(n_ctx, bool)
    new[0] = True
    np.not_equal(a[1:], a[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    ends = np.append(starts[1:], n_ctx)
    if int((ends - starts).max()) <= fmt.MAX_DISTANCE:
        return  # no run can contain a whole window
    rid = np.cumsum(new, dtype=np.int32) - 1
    sl = slice(base_r, base_r + bs)
    rs = starts[rid[sl]]
    re_ = ends[rid[sl]]
    i = np.arange(bs, dtype=np.int64)
    j = base_r + i
    capv = np.maximum(bs - fmt.BLOCK_END_LITERALS - i, 0)
    # rs is clamped at the context start, which only under-reports run
    # depth: sound (misses fall through to the refine path)
    deep = ((j - rs >= fmt.MAX_DISTANCE)
            & (i >= fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH))
    e = np.minimum(re_ - j, capv)
    ok = deep & (e != fmt.MAX_SAME_LETTER - 1)
    if not ok.any():
        return
    m4 = ok & (e >= fmt.MIN_MATCH)
    lens[m4] = e[m4]
    dists[m4] = 1
    m1 = ok & (e < fmt.MIN_MATCH)
    lens[m1] = 1
    dists[m1] = 0
    conv[ok] = True
    lk[ok] = True


def compress(
    data,
    level: int = 9,
    legacy: bool = False,
    dictionary=None,
    block_size: int | None = None,
    max_candidates: int = 64,
    parity: bool = True,
    report=None,
    kernel: str | None = None,
    progress=None,
) -> bytes:
    """Compress via the device match kernel.  ``level`` selects only the
    frame metadata path here — the device search is always the optimal
    (level-9) configuration; lower levels delegate to the native engine.

    ``report``: optional utils.profiling.RunReport — filled with bytes,
    block count and per-stage wall time (dispatch / device sync / host
    refine+DP+emit) for the observability surface (SURVEY.md §5).

    ``kernel``: device search kernel — "chunk" (chunk-merge path,
    ops.chunkmatch: sort each 64 Ki chunk once, merge with its
    predecessor, device-packed results; the default) or "walk" (lockstep
    candidate walk, ops.match_finder).  None reads $SMALLZ4_TPU_KERNEL."""
    import os as _os
    import time as _time

    from .. import native

    t_run = _time.perf_counter()
    data = bytes(data) if not isinstance(data, (bytes, bytearray)) else bytes(data)
    if legacy and dictionary:
        raise ValueError("legacy format doesn't support dictionaries")
    if level != 9:
        # capped-chain levels have serial skip/probe semantics: host path
        return native.compress(data, level, legacy=legacy, dictionary=dictionary,
                               block_size=block_size)
    if (legacy and block_size not in (None, fmt.MAX_BLOCK_SIZE_LEGACY)
            and len(data) > block_size):
        # a short non-final legacy block would end the stream early
        # (smallz4cat.c:325-327); single-block streams are fine
        raise ValueError(
            "legacy multi-block streams require the fixed 8 MB block size")
    if block_size is None:
        block_size = fmt.MAX_BLOCK_SIZE_LEGACY if legacy else fmt.MAX_BLOCK_SIZE

    # Parity fine print: for multi-block streams with blocks smaller than
    # the window, the reference's insertion set diverges from any
    # halo-context reconstruction (the per-block 12-byte replay,
    # smallz4.h:616-624, skips earlier blocks' tail literals, and no
    # replay happens at all while dataZero == 0).  Blocks >= 64 KB + 12
    # keep at most one predecessor in-window, whose tail the replay does
    # re-insert — there the halo model is exact (round-1 parity proofs).
    # Small-block parity streams go to the sequential native encoder.
    if (parity and not legacy and len(data) > block_size
            and block_size < fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH):
        return native.compress(data, level, legacy=legacy,
                               dictionary=dictionary, block_size=block_size)

    dict_tail = b""
    if dictionary and not legacy:
        dict_tail = bytes(dictionary)[-fmt.MAX_DISTANCE:]

    out = bytearray(fmt.build_frame_header(legacy))
    n = len(data)
    SEG, SEG_BUF, TAIL, B = (match_finder.SEG, match_finder.SEG_BUF,
                             match_finder.TAIL, 8)
    # virtual stream: dictionary tail is a prefix of block 0's history
    vdata = dict_tail + data
    d = len(dict_tail)
    blocks = _blocks(n, block_size)

    # Blocks are processed in windows: within a window every segment group
    # is dispatched up front (the device works ahead while the host runs
    # DP/emit on earlier blocks); the window bound keeps in-flight device
    # memory constant for arbitrarily large inputs.
    if kernel is None:
        kernel = _os.environ.get("SMALLZ4_TPU_KERNEL", "") or "chunk"
    if kernel not in ("chunk", "walk"):
        raise ValueError(f"unknown device kernel {kernel!r}")
    if kernel == "chunk":
        from . import chunkmatch as _cm

        # chunk-engine contract: block starts align with match_chunks
        # call boundaries (the boundary cut binds to a call's chunk 0)
        if block_size % (_cm.GROUP * _cm.CHUNK) != 0:
            import warnings

            warnings.warn(
                f"kernel='chunk' requires block_size % "
                f"{_cm.GROUP * _cm.CHUNK} == 0 (got {block_size}); "
                f"falling back to kernel='walk'",
                stacklevel=2,
            )
            kernel = "walk"

    stages: dict = {}
    if kernel == "chunk":
        _compress_chunked(out, data, vdata, d, blocks, legacy, parity,
                          native, stages, progress=progress)
    else:
        WINDOW = 8  # blocks (~32 MB of input at the default block size)
        for w0 in range(0, len(blocks), WINDOW):
            _process_block_window(
                out, data, vdata, d, blocks[w0 : w0 + WINDOW], legacy,
                max_candidates, parity, native, stages,
                progress=progress,
            )
    out += fmt.build_end_mark(legacy)
    if report is not None:
        report.operation = "encode"
        report.engine = "tpu"
        report.bytes_in = n
        report.bytes_out = len(out)
        report.blocks = len(blocks)
        report.wall_s = _time.perf_counter() - t_run
        for k, v in stages.items():
            # "n_*" entries are integer engine counters (refine volume
            # etc.), not wall times — route them to report.counters
            if k.startswith("n_"):
                report.counters[k] = report.counters.get(k, 0) + v
            else:
                report.stages[k] = report.stages.get(k, 0.0) + v
    return bytes(out)


def _compress_chunked(out, data, vdata, d, blocks, legacy, parity, native,
                      stages, progress=None):
    """Chunk-engine stream driver: one match_chunks call per GROUP chunks;
    within a block each call hands its last chunk's sorted planes to the
    next call as its halo (zero host round-trips on the search's critical
    path).
    Each BLOCK's leading halo is re-sorted from its raw history bytes —
    sort_chunk is deterministic, so this equals the carried planes while
    making blocks fully independent: they round-robin across every local
    device (data parallelism over blocks with no cross-device traffic).
    Head/delta-packed results stream back; refine (parity mode) + DP +
    emit run in the worker pool.

    Contract (checked by the caller): block_size % (GROUP*CHUNK) == 0, so
    every block starts at a call boundary and the boundary cut binds to
    that call's chunk 0.
    """
    import os as _os
    import time as _time

    import jax
    import jax.numpy as jnp

    from . import chunkmatch as cm
    from ..parallel import host as host_par

    CH, G, CAP = cm.CHUNK, cm.GROUP, cm.HEAD_CAP
    # speculative packed prefix: must cover the realized head count or the
    # collect pays BOTH the wasted async prefix AND a counts-synchronized
    # round trip per group.  Text-heavy corpora run ~7 K heads per 64 Ki
    # chunk with the saturation-aware predictor, so cover 8 K
    PREFETCH = min(CAP, max(256, CH // 8))
    n = len(data)
    arr = np.frombuffer(data, np.uint8)
    devices = jax.local_devices()

    import threading as _threading

    count_lock = _threading.Lock()  # finish() runs in the worker pool

    def block_halo(start, dev):
        """Sorted halo planes for the block at ``start``, on ``dev``."""
        if legacy or (start == 0 and not d):
            return jax.device_put(cm.empty_halo(chunk=CH), dev)
        hb = np.zeros(CH + cm.LOOK, np.uint8)
        if start == 0:  # dictionary tail, right-aligned (virtual prefix)
            lo_valid = CH - d
            hb[lo_valid:CH] = np.frombuffer(vdata[:d], np.uint8)
        else:           # preceding 64 KiB of the stream
            lo_valid = 0
            hb[:CH] = arr[start - CH : start]
        take = min(cm.LOOK, n - start)
        if take > 0:
            hb[CH : CH + take] = arr[start : start + take]
        return cm.sort_chunk(jax.device_put(hb, dev), jnp.int32(lo_valid),
                             jnp.int32(CH), chunk=CH)

    def dispatch_block(bi, start, end):
        """Queue every match_chunks call of one block on its round-robin
        device."""
        dev = devices[bi % len(devices)]
        bs = end - start
        n_groups = -(-bs // (G * CH))
        block_cut = (not legacy) and start >= fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH
        halo = block_halo(start, dev)
        entries = []
        for gi in range(n_groups):
            g0 = gi * G
            bufs = np.zeros((G, CH + cm.LOOK), np.uint8)
            cand = np.zeros(G, np.int32)
            vhi = np.zeros(G, np.int32)
            lim = np.zeros(G, np.int32)
            for j in range(G):
                cs = start + (g0 + j) * CH
                take = max(0, min(CH + cm.LOOK, n - cs))
                if take:
                    bufs[j, :take] = arr[cs : cs + take]
                real = max(0, min(CH, bs - (g0 + j) * CH))
                cand[j] = real
                vhi[j] = real
                lim[j] = bs - (g0 + j) * CH - fmt.BLOCK_END_LITERALS
            if gi == 0 and block_cut:
                cg = cm.pack_cut_gram(
                    data[start - fmt.BLOCK_END_NO_MATCH :
                         start - fmt.BLOCK_END_NO_MATCH + 4])
                cut_gram, cut_pos = jnp.int32(cg), jnp.int32(
                    CH - fmt.BLOCK_END_NO_MATCH)
            else:
                cut_gram, cut_pos = jnp.int32(0), jnp.int32(-1)
            halo, ys = cm.match_chunks(
                halo, jax.device_put(bufs, dev), jax.device_put(cand, dev),
                jax.device_put(vhi, dev), jax.device_put(lim, dev),
                cut_gram, cut_pos, n_chunks=G, head_cap=CAP, chunk=CH)
            stages["n_h2d_bytes"] = stages.get("n_h2d_bytes", 0) + (
                bufs.nbytes + cand.nbytes + vhi.nbytes + lim.nbytes)
            bits, packed, counts, cbits, kbits = ys
            # start the host copies now: the packed prefix covers the
            # common case, so by drain time only rare head-heavy chunks
            # still pay a counts-dependent round trip.  certificate bits
            # are only consumed by the parity refine — fast mode never
            # fetches them
            pk_head = packed[:, :PREFETCH]
            for a in (bits, counts, pk_head) + (
                    (cbits, kbits) if parity else ()):
                try:
                    a.copy_to_host_async()
                except Exception:
                    pass
            entries.append((g0, (bits, packed, counts, cbits, kbits,
                                 pk_head)))
        return entries

    def collect_block(start, end, entries):
        """Fetch one block's device results (main thread; the dispatch-time
        copy_to_host_async means only the counts-dependent packed slice
        still pays a round trip here).  Unpacking happens in the pool."""
        fetched = []
        for g0, (bits, packed, counts, cbits, kbits, pk_head) in entries:
            counts_np = np.asarray(counts)
            maxp = max(1, int(counts_np.max()))
            if maxp <= PREFETCH:
                pk = np.asarray(pk_head)  # already in flight since dispatch
            else:
                pk = np.asarray(packed[:, : min(maxp, CAP)])
            bits_np = np.asarray(bits)
            cbits_np = np.asarray(cbits) if parity else None
            kbits_np = np.asarray(kbits) if parity else None
            stages["n_d2h_bytes"] = stages.get("n_d2h_bytes", 0) + (
                bits_np.nbytes + pk.nbytes + counts_np.nbytes
                + (cbits_np.nbytes if cbits_np is not None else 0)
                + (kbits_np.nbytes if kbits_np is not None else 0))
            fetched.append((g0, bits_np, pk, counts_np, cbits_np, kbits_np))
        return fetched

    def unpack_block(start, end, fetched):
        bs = end - start
        lens = np.ones(bs, np.int32)
        dists = np.zeros(bs, np.int32)
        conv = np.ones(bs, bool)
        lk = np.ones(bs, bool)
        redo = np.zeros(bs, bool)
        for g0, bits_np, pk, counts_np, cbits_np, kbits_np in fetched:
            cv_rows = (cm.unpack_bits_rows(cbits_np, CH)
                       if cbits_np is not None else None)
            lk_rows = (cm.unpack_bits_rows(kbits_np, CH)
                       if kbits_np is not None else None)
            for j in range(G):
                o = (g0 + j) * CH
                if o >= bs:
                    break
                w = min(CH, bs - o)
                if counts_np[j] > CAP:  # head overflow: host redoes chunk
                    redo[o : o + w] = True
                    conv[o : o + w] = False
                    lk[o : o + w] = False
                    continue
                l, dd = native.unpack_claims(
                    bits_np[j], pk[j, : counts_np[j]], CH)
                lens[o : o + w] = l[:w]
                dists[o : o + w] = dd[:w]
                if cv_rows is not None:
                    conv[o : o + w] = cv_rows[j, :w]
                if lk_rows is not None:
                    lk[o : o + w] = lk_rows[j, :w]
        return lens, dists, conv, lk, redo

    def finish(start, end, fetched):
        """Worker-pool tail: unpack + pre-DP length refine (parity /
        overflow) + DP + post-DP distance fix + emit.  ``fetched is
        None`` = CPU-assist block: the whole search runs on the host
        matcher (exact, so parity-mode output is independent of which
        engine a block landed on).

        Parity-mode refine is SPLIT (the LK certificate,
        ops/chunkmatch.py): the DP consumes only lengths, so the full
        host re-search runs only at ~length-known positions; the exact
        nearest-of-max distance is then fixed after the DP, only at the
        positions the DP actually chose, by an early-stop walk
        (native.match_refine_dist) — bit-exact either way."""
        bs = end - start
        vstart, vend = start + d, end + d
        block_cut = (not legacy) and start >= fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH
        if fetched is None:
            lens = np.ones(bs, np.int32)
            dists = np.zeros(bs, np.int32)
            conv = np.zeros(bs, bool)
            lk = np.zeros(bs, bool)
            redo = np.ones(bs, bool)
        else:
            lens, dists, conv, lk, redo = unpack_block(start, end, fetched)
        lo = vstart if legacy else max(vstart - HALO, 0)
        base_r = vstart - lo
        ctxb = np.frombuffer(vdata[lo:vend], np.uint8)
        cut = (base_r - fmt.BLOCK_END_NO_MATCH) if block_cut else -1
        if fetched is not None:
            _deep_run_rule(ctxb, base_r, bs, lens, dists, conv, lk)
        tail = min(fmt.BLOCK_END_NO_MATCH - 1, bs)
        lens[bs - tail :] = 1
        dists[bs - tail :] = 0
        conv[bs - tail :] = True
        lk[bs - tail :] = True
        redo[bs - tail :] = False
        mask = ~lk if parity else redo
        if fetched is not None:  # certificate miss rate: device blocks only
            with count_lock:
                stages["n_refine_positions"] = stages.get(
                    "n_refine_positions", 0) + int(mask.sum())
                stages["n_positions"] = stages.get("n_positions", 0) + bs
        wholesale = False
        if mask.any():
            if parity and mask.mean() > 0.5:
                # refine-volume routing (high-miss regime): a wholesale
                # exact search beats per-position refine bookkeeping and
                # leaves every position fully exact (no post-DP fix)
                wholesale = True
                native.match_block_ex(
                    ctxb, base=base_r, bs=bs, level=9, lookback=base_r,
                    cut_pos=cut, lens=lens, dists=dists)
                conv[:] = True
                if fetched is not None:
                    with count_lock:
                        stages["n_wholesale_blocks"] = stages.get(
                            "n_wholesale_blocks", 0) + 1
            else:
                native.match_refine(
                    ctxb, base=base_r, bs=bs, lookback=base_r,
                    mask=mask, lens=lens, dists=dists, cut_pos=cut)
                conv |= mask  # refined positions are fully exact
        lens_claim = lens.copy() if parity else None
        native.estimate_costs(lens, dists)
        if parity and not wholesale and fetched is not None:
            # post-DP distance fix: the emitter reads distances only at
            # chosen match starts; LK positions there carry a genuine
            # max-length match whose distance may not be the nearest —
            # walk nearest-first, stop at the first achiever of the
            # certified length (== the reference's kept candidate)
            need = native.chosen_mask(lens) & ~conv
            if need.any():
                native.match_refine_dist(
                    ctxb, base=base_r, bs=bs, lookback=base_r,
                    mask=need, targets=lens_claim,
                    lens=lens_claim, dists=dists, cut_pos=cut)
                with count_lock:
                    stages["n_dist_fix_positions"] = stages.get(
                        "n_dist_fix_positions", 0) + int(need.sum())
        payload = native.emit_block(data[start:end], lens, dists)
        if len(payload) < bs or legacy:
            return payload, False
        return data[start:end], True

    # in-flight blocks: bounds device + host result memory while keeping
    # every local device busy
    WINDOW = max(8, 2 * len(devices))
    n_cores = min(32, _os.cpu_count() or 1)
    pending = []  # (bi, start, end, entries)
    jobs = {}     # bi -> future -> (payload, stored)

    # CPU-assist (hybrid scheduling): in parity mode every block encodes
    # to the same exact bytes whichever engine it lands on, so idle host
    # cores take whole blocks from the BACK of the stream while the
    # device works from the front.  Off in fast mode by default (device
    # claims differ from exact host claims, which would make the output
    # scheduling-dependent).
    import os as _os
    import threading

    # Default: every pool worker may steal whole blocks from the back —
    # the device side needs almost no CPU (async dispatch/fetch), so idle
    # cores full-compressing back blocks is pure gain.  Measured on the
    # 2-vCPU bench host: assist=2 gives 16.4-16.5 MB/s parity vs 12.4-13.9
    # at assist=1 and 15.7-16.0 for the host pool alone — the hybrid
    # strictly dominates both engines once assists match the cores.
    assist_default = str(min(32, _os.cpu_count() or 1)) if parity else "0"
    n_assist = max(0, int(_os.environ.get("SMALLZ4_TPU_CPU_ASSIST",
                                          assist_default)))
    fence = threading.Lock()
    claim = {"front": 0, "back": len(blocks)}

    def claim_front():
        with fence:
            if claim["front"] >= claim["back"]:
                return -1
            bi = claim["front"]
            claim["front"] += 1
            return bi

    def assist_loop():
        while True:
            with fence:
                if claim["back"] - 1 < claim["front"]:
                    return
                claim["back"] -= 1
                bi = claim["back"]
            start, end = blocks[bi]
            jobs[bi] = _Done(finish(start, end, None))

    class _Done:
        def __init__(self, value):
            self._value = value

        def result(self):
            return self._value

    # one thread per core for the finish/refine tail PLUS one per assist:
    # an assist loop occupies its worker for a whole block, and a pool
    # sized to the cores alone starves device-block finishes behind the
    # assists (measured: best-of-3 drops ~25% on the 2-vCPU host).  The
    # native stages release the GIL, so oversubscription schedules fine.
    n_assist = min(n_assist, max(0, len(blocks) - 1))
    pool = host_par._pool(n_cores + n_assist)

    assist_futures = [pool.submit(assist_loop) for _ in range(n_assist)]

    def drain(limit):
        nonlocal pending
        t = _time.perf_counter()
        while len(pending) > limit:
            bi, start, end, entries = pending.pop(0)
            fetched = collect_block(start, end, entries)
            jobs[bi] = pool.submit(finish, start, end, fetched)
        stages["device_sync"] = stages.get("device_sync", 0.0) + (
            _time.perf_counter() - t)

    t0 = _time.perf_counter()
    while True:
        bi = claim_front()
        if bi < 0:
            break
        start, end = blocks[bi]
        entries = dispatch_block(bi, start, end)
        pending.append((bi, start, end, entries))
        stages["device_dispatch"] = stages.get("device_dispatch", 0.0) + (
            _time.perf_counter() - t0)
        drain(WINDOW)
        t0 = _time.perf_counter()
    drain(0)
    for f in assist_futures:
        f.result()

    t0 = _time.perf_counter()
    for bi, (start, end) in enumerate(blocks):
        payload, stored = jobs[bi].result()
        out += fmt.build_block_header(len(payload), stored, legacy)
        out += payload
        if progress is not None:
            progress(end, len(out))
    stages["host_refine_dp_emit"] = stages.get("host_refine_dp_emit", 0.0) + (
        _time.perf_counter() - t0)


def _process_block_window(out, data, vdata, d, blocks, legacy,
                          max_candidates, parity, native, stages=None,
                          progress=None):
    import time as _time

    stages = {} if stages is None else stages
    t0 = _time.perf_counter()
    SEG, SEG_BUF, TAIL, B = (match_finder.SEG, match_finder.SEG_BUF,
                             match_finder.TAIL, 8)
    # phase 1 — dispatch every segment group in the window
    per_block: dict[int, list] = {}
    for bi, (start, end) in enumerate(blocks):
        vstart, vend = start + d, end + d
        block_cut = (not legacy) and start >= fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH
        seg_starts = list(range(vstart, vend, SEG))
        for g0 in range(0, len(seg_starts), B):
            group = seg_starts[g0 : g0 + B]
            bufs = np.zeros((B, SEG_BUF), np.uint8)
            sv = np.full(B, SEG_BUF, np.int32)  # padding rows: nothing valid
            ev = np.zeros(B, np.int32)
            cf = np.zeros(B, bool)
            for r, s0 in enumerate(group):
                lo = max(s0 - HALO, vstart if legacy else 0)
                hi = min(s0 + SEG + TAIL, vend)
                hl = s0 - lo
                arr = np.frombuffer(vdata[lo:hi], np.uint8)
                bufs[r, HALO - hl : HALO - hl + len(arr)] = arr
                sv[r] = HALO - hl
                ev[r] = HALO - hl + len(arr)
                cf[r] = block_cut and s0 == vstart
            res = match_finder.match_segments(
                jnp.asarray(bufs), jnp.asarray(sv), jnp.asarray(ev),
                jnp.asarray(cf), max_candidates=max_candidates,
            )
            per_block.setdefault(bi, []).append((group, res))
    stages["device_dispatch"] = stages.get("device_dispatch", 0.0) + (
        _time.perf_counter() - t0)

    # phase 2 — collect (device sync, main thread) and finish each block's
    # refine/DP/emit in a thread pool (the native runtime releases the GIL)
    import concurrent.futures as cf

    def finish(bi, start, end, lens, dists, conv):
        bs = end - start
        vstart, vend = start + d, end + d
        block_cut = (not legacy) and start >= fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH
        if parity:
            mask = ~conv
            if mask.any():
                lo = vstart if legacy else max(vstart - HALO, 0)
                base_r = vstart - lo
                ctxb = np.frombuffer(vdata[lo:vend], np.uint8)
                native.match_refine(
                    ctxb, base=base_r, bs=bs, lookback=base_r,
                    mask=mask, lens=lens, dists=dists,
                    cut_pos=(base_r - fmt.BLOCK_END_NO_MATCH) if block_cut else -1,
                )
        native.estimate_costs(lens, dists)
        payload = native.emit_block(data[start:end], lens, dists)
        if len(payload) < bs or legacy:
            return payload, False
        return data[start:end], True

    from ..parallel import host as host_par

    pool = host_par._pool(None)  # persistent: workers keep warm match tables
    jobs = []
    t0 = _time.perf_counter()
    for bi, (start, end) in enumerate(blocks):
        bs = end - start
        vstart, vend = start + d, end + d
        lens = np.empty(bs, np.int32)
        dists = np.empty(bs, np.int32)
        conv = np.ones(bs, bool)
        for group, (lens_d, dists_d, conv_d) in per_block[bi]:
            lens_np = np.asarray(lens_d).astype(np.int32)
            dists_np = np.asarray(dists_d).astype(np.int32)
            conv_np = np.asarray(conv_d)
            for r, s0 in enumerate(group):
                w = min(SEG, vend - s0)
                o = s0 - vstart
                lens[o : o + w] = lens_np[r, :w]
                dists[o : o + w] = dists_np[r, :w]
                conv[o : o + w] = conv_np[r, :w]
        # block-tail rule: the last 11 positions are literals
        tail = min(fmt.BLOCK_END_NO_MATCH - 1, bs)
        lens[bs - tail :] = 1
        dists[bs - tail :] = 0
        conv[bs - tail :] = True
        jobs.append(pool.submit(finish, bi, start, end, lens, dists, conv))
    stages["device_sync"] = stages.get("device_sync", 0.0) + (
        _time.perf_counter() - t0)
    t0 = _time.perf_counter()
    for (start, end), job in zip(blocks, jobs):
        payload, stored = job.result()  # frame order preserved
        out += fmt.build_block_header(len(payload), stored, legacy)
        out += payload
        if progress is not None:
            progress(end, len(out))
    stages["host_refine_dp_emit"] = stages.get("host_refine_dp_emit", 0.0) + (
        _time.perf_counter() - t0)


import functools as _functools


@_functools.lru_cache(maxsize=None)
def _device_resident_step_fn():
    """Build (once) the jitted device-resident block step:
    match (chunk matcher, raw claims) -> DP (policy iteration) -> emit."""
    import jax

    from . import chunkmatch as cm
    from . import emit as dev_emit
    from . import parse as dev_parse

    @_functools.partial(jax.jit, static_argnames=("n_chunks", "bs"))
    def step(halo, bufs, cand, vhi, lim, cut_gram, cut_pos, blk,
             n_chunks, bs):
        CH = cm.CHUNK
        halo2, (lens_u, dists_u, _conv, _lk) = cm.match_chunks_raw(
            halo, bufs, cand, vhi, lim, cut_gram, cut_pos,
            n_chunks=n_chunks, chunk=CH)
        lens = lens_u.reshape(-1)[:bs].astype(jnp.int32)
        dists = dists_u.reshape(-1)[:bs].astype(jnp.int32)
        pos = jnp.arange(bs, dtype=jnp.int32)
        tail = pos >= bs - (fmt.BLOCK_END_NO_MATCH - 1)
        lens = jnp.where(tail, 1, lens)
        dists = jnp.where(tail, 0, dists)
        choice, _cost, ok = dev_parse.estimate_costs_device(lens, dists, bs)
        payload, n_out = dev_emit.emit_block_device(
            blk, choice, jnp.where(choice > 1, dists, 0))
        return halo2, payload, n_out, ok

    return step


def _device_resident_block_step(halo, bufs, cand, vhi, lim, cg, cp, blk,
                                n_chunks, bs):
    return _device_resident_step_fn()(halo, bufs, cand, vhi, lim, cg, cp,
                                      blk, n_chunks=n_chunks, bs=bs)


def compress_device_resident(data, block_size: int | None = None,
                             report=None) -> bytes:
    """Fully device-resident -9-class encode: match (chunk engine) ->
    optimal parse (ops.parse policy iteration) -> sequence emit
    (ops.emit), all on device — only the compressed bytes cross the
    host link (~0.2-0.5 d2h bytes per input byte at -9 ratios, vs
    ~1.5-2.0 for shipping claims).  SURVEY.md §7 steps 5-6 complete.

    Raw-claims semantics: device claims saturate at 65535 and skip the
    host refine, so streams are valid, decode-verified and -9-class,
    not bit-parity (use the default hybrid engine for bit-exact
    streams).  Modern frames, no dictionary.  The device DP (see
    ops/parse.py) is gather work — this mode exists for link-constrained
    deployments and completeness, and bench reports its rate."""
    import time as _time

    import jax

    from . import chunkmatch as cm
    from . import emit as dev_emit
    from . import parse as dev_parse

    t_run = _time.perf_counter()
    data = bytes(data)
    CH = cm.CHUNK
    if block_size is None:
        block_size = min(fmt.MAX_BLOCK_SIZE, 16 * CH)
    if block_size % CH != 0:
        raise ValueError(f"device-resident path needs block_size % {CH} == 0")
    n = len(data)
    arr = np.frombuffer(data, np.uint8)
    out = bytearray(fmt.build_frame_header(False))
    stages: dict = {}
    blocks = _blocks(n, block_size)

    halo = None
    for bi, (start, end) in enumerate(blocks):
        bs = end - start
        n_chunks = -(-bs // CH)
        t0 = _time.perf_counter()
        if halo is None:
            if start == 0:
                halo = cm.empty_halo(chunk=CH)
            else:
                hb = np.zeros(CH + cm.LOOK, np.uint8)
                hb[:CH] = arr[start - CH : start]
                take = min(cm.LOOK, n - start)
                hb[CH : CH + take] = arr[start : start + take]
                halo = cm.sort_chunk(jnp.asarray(hb), jnp.int32(0),
                                     jnp.int32(CH), chunk=CH)
        bufs = np.zeros((n_chunks, CH + cm.LOOK), np.uint8)
        cand = np.zeros(n_chunks, np.int32)
        lim = np.zeros(n_chunks, np.int32)
        for j in range(n_chunks):
            cs = start + j * CH
            take = max(0, min(CH + cm.LOOK, n - cs))
            bufs[j, :take] = arr[cs : cs + take]
            cand[j] = max(0, min(CH, bs - j * CH))
            lim[j] = bs - j * CH - fmt.BLOCK_END_LITERALS
        block_cut = start >= fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH
        if block_cut:
            cg = jnp.int32(cm.pack_cut_gram(
                data[start - fmt.BLOCK_END_NO_MATCH :
                     start - fmt.BLOCK_END_NO_MATCH + 4]))
            cp = jnp.int32(CH - fmt.BLOCK_END_NO_MATCH)
        else:
            cg, cp = jnp.int32(0), jnp.int32(-1)
        blk = jnp.asarray(arr[start:end])
        stages["n_h2d_bytes"] = stages.get("n_h2d_bytes", 0) + (
            bufs.nbytes + bs)
        halo, payload, n_out, ok = _device_resident_block_step(
            halo, jnp.asarray(bufs), jnp.asarray(cand), jnp.asarray(cand),
            jnp.asarray(lim), cg, cp, blk, n_chunks=n_chunks, bs=bs)
        stages["device_total"] = stages.get("device_total", 0.0) + (
            _time.perf_counter() - t0)
        t0 = _time.perf_counter()
        m = int(n_out)
        if not bool(ok):
            # DP round cap hit (the documented safety net, ops/parse.py):
            # redo this block on the host — exact matcher + host DP +
            # emit; the stream stays valid, only this block's bytes
            # differ from the device path's
            from .. import native

            lo = max(start - HALO, 0)
            ctx = np.frombuffer(data[lo:end], np.uint8)
            base = start - lo
            lens = np.ones(bs, np.int32)
            dists = np.zeros(bs, np.int32)
            native.match_block_ex(
                ctx, base=base, bs=bs, level=9, lookback=base,
                cut_pos=(base - fmt.BLOCK_END_NO_MATCH
                         if start >= fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH
                         else -1),
                lens=lens, dists=dists)
            native.estimate_costs(lens, dists)
            pay = native.emit_block(data[start:end], lens, dists)
            if len(pay) < bs:
                out += fmt.build_block_header(len(pay), False, False)
                out += pay
            else:
                out += fmt.build_block_header(bs, True, False)
                out += data[start:end]
            stages["fetch_assemble"] = stages.get("fetch_assemble", 0.0) + (
                _time.perf_counter() - t0)
            continue
        if m < bs:
            pay = np.asarray(payload[:m]).tobytes()
            stages["n_d2h_bytes"] = stages.get("n_d2h_bytes", 0) + m + 8
            out += fmt.build_block_header(m, False, False)
            out += pay
        else:  # stored-block fallback (smallz4.h:765-775)
            stages["n_d2h_bytes"] = stages.get("n_d2h_bytes", 0) + 8
            out += fmt.build_block_header(bs, True, False)
            out += data[start:end]
        stages["fetch_assemble"] = stages.get("fetch_assemble", 0.0) + (
            _time.perf_counter() - t0)
    out += fmt.build_end_mark(False)
    if report is not None:
        report.operation = "encode"
        report.engine = "tpu-device-resident"
        report.bytes_in = n
        report.bytes_out = len(out)
        report.blocks = len(blocks)
        report.wall_s = _time.perf_counter() - t_run
        for k, v in stages.items():
            if k.startswith("n_"):
                report.counters[k] = report.counters.get(k, 0) + v
            else:
                report.stages[k] = report.stages.get(k, 0.0) + v
    return bytes(out)


def decompress(data, dictionary=None) -> bytes:
    """Decode a frame with the device expansion kernel.

    The sequence parse runs on the host up front; block expansions chain
    through a device-resident 64 KB history window, so consecutive blocks
    dispatch without host round-trips and materialize once at the end."""
    import jax.numpy as jnp

    import struct

    data = bytes(data)
    # leading skippable frames (LZ4 spec; capability superset of the
    # reference — see format.MAGIC_SKIPPABLE_BASE)
    while len(data) >= 8:
        magic = struct.unpack_from("<I", data, 0)[0]
        if (magic & fmt.MAGIC_SKIPPABLE_MASK) != fmt.MAGIC_SKIPPABLE_BASE:
            break
        size = struct.unpack_from("<I", data, 4)[0]
        if 8 + size > len(data):
            raise fmt.FormatError("out of data")
        data = data[8 + size:]
    info = fmt.parse_frame_header(data)
    pos = info.header_size
    block_cap = fmt.MAX_BLOCK_SIZE_LEGACY if info.legacy else fmt.MAX_BLOCK_SIZE
    dec = decoder.DeviceBlockDecoder(out_cap=block_cap)
    hist_dev = dec.hist_device(bytes(dictionary)[-65536:] if dictionary else b"")
    out = bytearray()
    pending = []  # (device array | bytes, out_len): bounded dispatch window

    def materialize(limit: int) -> None:
        while len(pending) > limit:
            item, ln = pending.pop(0)
            out.extend(item if isinstance(item, bytes)
                       else np.asarray(item)[:ln].tobytes())

    while True:
        if pos + 4 > len(data):
            if info.legacy:
                break
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
            out_dev, out_len = dec.decode_dev(payload, hist_dev)
            pending.append((out_dev, out_len))
            hist_dev = decoder._update_hist(hist_dev, out_dev, jnp.int32(out_len))
        else:
            pending.append((payload, size))
            take = min(size, 65536)
            stored = np.zeros(65536, np.uint8)  # left-aligned tail
            stored[:take] = np.frombuffer(payload[-take:], np.uint8)
            hist_dev = decoder._update_hist(hist_dev, jnp.asarray(stored),
                                            jnp.int32(take))
            out_len = size
        if info.has_block_checksum:
            pos += 4
        materialize(4)  # keep a small device pipeline in flight
        if info.legacy and is_compressed and out_len < fmt.MAX_BLOCK_SIZE_LEGACY:
            break
    materialize(0)
    return bytes(out)
