"""Multi-chip scale-out: LZ4 blocks data-parallel over a jax.sharding.Mesh.

The reference is single-threaded (SURVEY.md §2 "Parallelism: none"); this
module is the framework's from-scratch distribution layer:

* **DP over blocks** — the frame's blocks are independent given a 64 KB
  halo (the dependent-block history carry, smallz4.h:798-805).  A batch of
  fixed-size blocks is sharded across the mesh's ``blocks`` axis.
* **Halo exchange** — each device receives its left neighbor's trailing
  64 KB via ``jax.lax.ppermute`` (the "context parallelism" analog), so
  the sharded output is bit-identical to the sequential
  stream (chain-cut semantics included, ops.match_finder).
* **Ragged outputs** — per-block compressed sizes are data-dependent; the
  device path returns fixed-shape match arrays, and the host packs the
  ragged token streams in frame order (ordered concat on host 0).

The device step (match search) is the hot loop; the serial byte-stream
glue (DP + emit) stays on the host and runs per-block in a thread pool —
the native runtime releases the GIL.
"""
from __future__ import annotations

import concurrent.futures as cf
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import format as fmt
from ..ops import match_finder

HALO = fmt.MAX_DISTANCE


def make_mesh(n_devices: int | None = None, axis: str = "blocks") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def _local_rows(arr: np.ndarray, mesh: Mesh, axis: str) -> np.ndarray:
    """Rows of the leading (sharded) axis owned by this process, in mesh
    order — the process-local chunk for make_array_from_process_local_data."""
    pid = jax.process_index()
    devs = list(mesh.devices.flat)
    per = arr.shape[0] // len(devs)
    rows = [
        arr[i * per : (i + 1) * per]
        for i, d in enumerate(devs)
        if d.process_index == pid
    ]
    return np.concatenate(rows, axis=0)


def _match_batch(ctx, start_valid, end_valid, cut, max_candidates):
    """vmapped single-block search: ctx [B, HALO+S]."""
    fn = functools.partial(
        match_finder.match_block,
        base=HALO,
        max_candidates=max_candidates,
    )
    return jax.vmap(
        lambda c, s, e, k: fn(c, start_valid=s, end_valid=e, cut_boundary=k)
    )(ctx, start_valid, end_valid, cut)


def sharded_match_step(mesh: Mesh, block_size: int, max_candidates: int = 64):
    """Build the jitted multi-device step: blocks sharded over the mesh,
    halo exchanged with ppermute.

    In:  blocks  uint8[B, S]   (B divisible by mesh size),
         lengths int32[B]      (valid bytes per block; 0 = padding block),
         first_hist int32      (history bytes available to block 0: 0 or
                                the dictionary length)
    Out: lens, dists, converged  int32[B, S]
    """
    axis = mesh.axis_names[0]

    def step(blocks, lengths, first_hist):
        def local(blocks_l, lengths_l, first_hist_l):
            nd = jax.lax.axis_size(axis)
            idx = jax.lax.axis_index(axis)
            bl, s = blocks_l.shape
            # tail of each local block -> halo of the next; device boundary
            # tails travel left->right around the ring (neighbor hop).
            # Blocks smaller than the 64 KB window (dry-run shapes) carry a
            # zero-padded, truncated halo.
            halo_w = min(HALO, s)
            tails = blocks_l[:, -halo_w:]
            prev_tail_remote = jax.lax.ppermute(
                tails[-1], axis, perm=[(i, (i + 1) % nd) for i in range(nd)]
            )
            halos = jnp.concatenate(
                [prev_tail_remote[None], tails[:-1]], axis=0
            )
            if halo_w < HALO:
                halos = jnp.concatenate(
                    [jnp.zeros((bl, HALO - halo_w), blocks_l.dtype), halos],
                    axis=1,
                )
            ctx = jnp.concatenate([halos, blocks_l], axis=1)
            # per-block valid ranges inside the fixed ctx buffer
            gidx = idx * bl + jnp.arange(bl, dtype=jnp.int32)
            hist_len = jnp.where(
                gidx == 0,
                jnp.minimum(first_hist_l, halo_w),
                halo_w,
            )
            # padding blocks (lengths 0) and short final blocks
            start_valid = (HALO - hist_len).astype(jnp.int32)
            end_valid = (HALO + lengths_l).astype(jnp.int32)
            # boundary chain cut for carried-history blocks (reference
            # re-insertion anomaly) — same gate as pipeline/native: only
            # when the block start clears the full window + tail rule
            cut = gidx * s >= HALO + fmt.BLOCK_END_NO_MATCH
            lens, dists, conv = _match_batch(ctx, start_valid, end_valid, cut,
                                             max_candidates)
            return lens, dists, conv

        # the kernel's while-loop carries start as replicated constants;
        # skip the varying-manual-axes check (outputs are still sharded
        # exactly per out_specs)
        wrapped = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(axis, None), P(axis), P()),
            out_specs=(P(axis, None), P(axis, None), P(axis, None)),
            check_vma=False)
        return wrapped(blocks, lengths, first_hist)

    return jax.jit(step)


def sharded_chunk_step(mesh: Mesh, n_local: int, chunk: int | None = None,
                       head_cap: int | None = None, group: int | None = None):
    """Build the jitted multi-chip step for the PRODUCTION chunk-merge
    kernel (ops.chunkmatch): the stream's chunks are sharded contiguously
    over the mesh, each device ppermutes its last raw chunk to its right
    neighbor (the 64 KB window halo travels as bytes — one chunk/device/
    step, re-sorted locally: sort_chunk is deterministic, so this equals
    the sequential path's carried planes bit-for-bit), then runs its local
    match_chunks.  There is no sequential dependency across
    devices: the halo is a pure function of the neighbor's bytes.

    Each device scans its ``n_local`` chunks ``group`` at a time (default
    ``min(n_local, chunkmatch.GROUP)``; it must divide ``n_local``), one
    batched match_chunks call per step with the sorted halo carried, so
    the device's working memory is that of one group whatever its share
    of the stream.

    In:  bufs        uint8[nd*n_local, chunk+LOOK]  (sharded rows)
         cand_hi, valid_hi, match_limit, cut_gram, cut_pos
                     int32[nd*n_local]            (sharded; per-chunk cuts
                     encode block starts — chunkmatch.match_chunks array
                     cut contract)
         halo0_buf   uint8[chunk+LOOK]  (replicated: stream-start history,
                     right-aligned dictionary tail or zeros)
         halo0_lo    int32            (first valid halo position; chunk =
                     empty halo)
    Out: bits [B, chunk//32], packed [B, head_cap], n_heads [B],
         conv_bits [B, chunk//32], lk_bits [B, chunk//32]
         (B = nd*n_local, sharded)
    """
    from ..ops import chunkmatch as cm

    chunk = chunk or cm.CHUNK
    head_cap = head_cap or cm.HEAD_CAP
    group = group or min(n_local, cm.GROUP)
    if n_local % group:
        raise ValueError(f"n_local={n_local} is not a multiple of "
                         f"group={group}")
    axis = mesh.axis_names[0]
    nd = mesh.devices.size

    def step(bufs, cand_hi, valid_hi, match_limit, cut_gram, cut_pos,
             halo0_buf, halo0_lo):
        def local(bufs_l, ch_l, vh_l, ml_l, cg_l, cp_l, h0b, h0lo):
            idx = jax.lax.axis_index(axis)
            # left neighbor's last raw chunk -> my halo (ring ppermute);
            # device 0 takes the stream-start halo instead of the wrap
            prev_buf = jax.lax.ppermute(
                bufs_l[-1], axis, perm=[(i, (i + 1) % nd) for i in range(nd)])
            halo_buf = jnp.where(idx == 0, h0b, prev_buf)
            halo_lo = jnp.where(idx == 0, h0lo, jnp.int32(0))
            halo = cm.sort_chunk(halo_buf, halo_lo, jnp.int32(chunk),
                                 chunk=chunk)

            def one_group(halo, xs):
                return cm.match_chunks(halo, *xs, n_chunks=group,
                                       head_cap=head_cap, chunk=chunk)

            xs = tuple(a.reshape(n_local // group, group, *a.shape[1:])
                       for a in (bufs_l, ch_l, vh_l, ml_l, cg_l, cp_l))
            _, ys = jax.lax.scan(one_group, halo, xs)
            return tuple(y.reshape(n_local, *y.shape[2:]) for y in ys)

        wrapped = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(axis, None), P(axis), P(axis), P(axis), P(axis),
                      P(axis), P(), P()),
            out_specs=(P(axis, None), P(axis, None), P(axis),
                       P(axis, None), P(axis, None)),
            check_vma=False)
        return wrapped(bufs, cand_hi, valid_hi, match_limit, cut_gram,
                       cut_pos, halo0_buf, halo0_lo)

    return jax.jit(step)


def compress_sharded_chunks(
    data: bytes,
    mesh: Mesh | None = None,
    block_size: int = fmt.MAX_BLOCK_SIZE,
    dictionary: bytes | None = None,
    parity: bool = True,
) -> bytes:
    """Level-9 compression with the production chunk kernel sharded over a
    device mesh: the same match_chunks the single-device engine runs,
    split contiguously across devices with the 64 KB halo hand-off.
    Output framing (and, in parity mode, every byte)
    is identical to the sequential engines.  Modern frames only (legacy
    resets history per block and has no halo to exchange — use the host
    or single-chip paths)."""
    from .. import native
    from ..ops import chunkmatch as cm

    data = bytes(data)
    mesh = mesh or make_mesh()
    nd = mesh.devices.size
    n = len(data)
    CH, CAP = cm.CHUNK, cm.HEAD_CAP
    if block_size % CH != 0:
        raise ValueError(f"sharded chunk path needs block_size % {CH} == 0")
    if (parity and n > block_size
            and block_size < fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH):
        # small-block multi-block streams hit the reference's shallow-
        # lookback replay fine print, where the halo model is not exact —
        # same delegation as ops.pipeline.compress
        return native.compress(data, 9, dictionary=dictionary,
                               block_size=block_size)
    dict_tail = bytes(dictionary)[-fmt.MAX_DISTANCE:] if dictionary else b""
    d = len(dict_tail)

    nblocks = max(1, -(-n // block_size))
    blocks = [(b * block_size, min(n, (b + 1) * block_size))
              for b in range(nblocks)]
    n_chunks = max(1, -(-n // CH))
    n_local = -(-n_chunks // nd)
    if n_local > cm.GROUP:  # whole groups per device (padding rows at the end)
        n_local = -(-n_local // cm.GROUP) * cm.GROUP
    B = n_local * nd

    arr = np.frombuffer(data, np.uint8)
    bufs = np.zeros((B, CH + cm.LOOK), np.uint8)
    cand = np.zeros(B, np.int32)
    vhi = np.zeros(B, np.int32)
    lim = np.full(B, -(CH + cm.LOOK), np.int32)
    cgs = np.zeros(B, np.int32)
    cps = np.full(B, -1, np.int32)
    for j in range(n_chunks):
        cs = j * CH
        take = min(CH + cm.LOOK, n - cs)
        bufs[j, :take] = arr[cs : cs + take]
        b = cs // block_size
        bstart, bend = blocks[b]
        real = max(0, min(CH, bend - cs))
        cand[j] = real
        vhi[j] = real
        lim[j] = bend - cs - fmt.BLOCK_END_LITERALS
        if cs == bstart and bstart >= fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH:
            # boundary chain cut (reference re-insertion anomaly); same
            # gate as the sequential engines
            cgs[j] = cm.pack_cut_gram(
                data[bstart - fmt.BLOCK_END_NO_MATCH :
                     bstart - fmt.BLOCK_END_NO_MATCH + 4])
            cps[j] = CH - fmt.BLOCK_END_NO_MATCH

    halo0 = np.zeros(CH + cm.LOOK, np.uint8)
    if d:
        halo0[CH - d : CH] = np.frombuffer(dict_tail, np.uint8)
        halo0[CH : CH + min(cm.LOOK, n)] = arr[: min(cm.LOOK, n)]
        halo0_lo = CH - d
    else:
        halo0_lo = CH  # empty halo (stream start)

    step = sharded_chunk_step(mesh, n_local, chunk=CH, head_cap=CAP)
    args = (bufs, cand, vhi, lim, cgs, cps)
    if jax.process_count() > 1:
        from jax.sharding import NamedSharding
        from jax.experimental import multihost_utils

        axis = mesh.axis_names[0]
        g_args = []
        for a in args:
            spec = P(axis, None) if a.ndim == 2 else P(axis)
            g_args.append(jax.make_array_from_process_local_data(
                NamedSharding(mesh, spec), _local_rows(a, mesh, axis)))
        ys = step(*g_args, jnp.asarray(halo0), jnp.int32(halo0_lo))
        fetched = [np.asarray(multihost_utils.process_allgather(y, tiled=True))
                   for y in ys]
    else:
        ys = step(*(jnp.asarray(a) for a in args), jnp.asarray(halo0),
                  jnp.int32(halo0_lo))
        fetched = [np.asarray(y) for y in jax.block_until_ready(ys)]
    bits, packed, counts, cbits, _kbits = fetched

    # host tail: unpack claims, per-block refine (parity / overflow) + DP +
    # emit — the sharded path refines the FULL certificate (~conv) rather
    # than the split-LK mask the single-chip engine uses: every position
    # is exact before the DP, so no post-DP distance fix is needed here
    conv_rows = cm.unpack_bits_rows(cbits, CH)

    def finish(b: int) -> tuple[bytes, bool]:
        bstart, bend = blocks[b]
        bs = bend - bstart
        lens = np.ones(bs, np.int32)
        dists = np.zeros(bs, np.int32)
        conv = np.ones(bs, bool)
        redo = np.zeros(bs, bool)
        for j in range(bstart // CH, -(-bend // CH)):
            o = j * CH - bstart
            w = min(CH, bs - o)
            if counts[j] > CAP:  # head overflow: host redoes the chunk
                redo[o : o + w] = True
                conv[o : o + w] = False
                continue
            l, dd = native.unpack_claims(bits[j], packed[j, : counts[j]], CH)
            lens[o : o + w] = l[:w]
            dists[o : o + w] = dd[:w]
            conv[o : o + w] = conv_rows[j, :w]
        tail = min(fmt.BLOCK_END_NO_MATCH - 1, bs)
        lens[bs - tail :] = 1
        dists[bs - tail :] = 0
        conv[bs - tail :] = True
        redo[bs - tail :] = False
        mask = ~conv if parity else redo
        block_cut = bstart >= fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH
        if mask.any():
            hist = dict_tail if b == 0 else data[max(0, bstart - HALO):bstart]
            ctx = np.frombuffer(hist + data[bstart:bend], np.uint8)
            native.match_refine(
                ctx, base=len(hist), bs=bs, lookback=len(hist),
                mask=mask, lens=lens, dists=dists,
                cut_pos=(len(hist) - fmt.BLOCK_END_NO_MATCH) if block_cut
                else -1,
            )
        native.estimate_costs(lens, dists)
        payload = native.emit_block(data[bstart:bend], lens, dists)
        if len(payload) < bs:
            return payload, False
        return data[bstart:bend], True

    from . import host as host_par

    out = bytearray(fmt.build_frame_header(False))
    pool = host_par._pool(None)
    for payload, stored in pool.map(finish, range(nblocks)):
        out += fmt.build_block_header(len(payload), stored=stored,
                                      legacy=False)
        out += payload
    out += fmt.build_end_mark(False)
    return bytes(out)


def compress_sharded(
    data: bytes,
    mesh: Mesh | None = None,
    block_size: int = fmt.MAX_BLOCK_SIZE,
    max_candidates: int = 64,
    dictionary: bytes | None = None,
    parity: bool = True,
) -> bytes:
    """Block-data-parallel level-9 compression over a device mesh.

    Output framing is identical to the sequential engines; with converged
    search (or parity=True) the stream is bit-identical to `smallz4 -9`
    when block_size is the 4 MB default."""
    from .. import native

    data = bytes(data)
    mesh = mesh or make_mesh()
    nd = mesh.devices.size
    n = len(data)
    dict_tail = bytes(dictionary)[-fmt.MAX_DISTANCE:] if dictionary else b""

    if block_size < HALO + 1:
        raise ValueError("sharded path needs block_size >= 64 KB (halo span)")
    nblocks = max(1, -(-n // block_size))
    batch = -(-nblocks // nd) * nd  # pad to a multiple of the mesh size
    if dict_tail and batch == nblocks:
        batch += nd  # need a padding block to carry the dictionary halo
    blocks = np.zeros((batch, block_size), np.uint8)
    lengths = np.zeros(batch, np.int32)
    for b in range(nblocks):
        chunk = data[b * block_size : (b + 1) * block_size]
        blocks[b, : len(chunk)] = np.frombuffer(chunk, np.uint8)
        lengths[b] = len(chunk)
    if dict_tail:
        # the dictionary is block 0's halo: place it as the "previous
        # block" tail by prepending a virtual block is unnecessary — the
        # device step takes first_hist and block 0 reads its halo from the
        # ring ppermute (the last, padding block), so we inject it there.
        last = batch - 1
        blocks[last, block_size - len(dict_tail):] = np.frombuffer(dict_tail, np.uint8)

    step = sharded_match_step(mesh, block_size, max_candidates)
    if jax.process_count() > 1:
        # multi-host: every process holds `data`; build the global sharded
        # batch from each process's own rows and allgather the results
        from jax.sharding import NamedSharding
        from jax.experimental import multihost_utils

        axis = mesh.axis_names[0]
        row_sh = NamedSharding(mesh, P(axis, None))
        vec_sh = NamedSharding(mesh, P(axis))
        blocks_g = jax.make_array_from_process_local_data(
            row_sh, _local_rows(blocks, mesh, axis))
        lengths_g = jax.make_array_from_process_local_data(
            vec_sh, _local_rows(lengths, mesh, axis))
        lens_d, dists_d, conv_d = step(blocks_g, lengths_g,
                                       jnp.int32(len(dict_tail)))
        lens_all = np.asarray(
            multihost_utils.process_allgather(lens_d, tiled=True)
        ).astype(np.int32)
        dists_all = np.asarray(
            multihost_utils.process_allgather(dists_d, tiled=True)
        ).astype(np.int32)
        conv_all = np.asarray(
            multihost_utils.process_allgather(conv_d, tiled=True))
    else:
        lens_d, dists_d, conv_d = step(
            jnp.asarray(blocks), jnp.asarray(lengths), jnp.int32(len(dict_tail))
        )
        lens_all = np.asarray(lens_d).astype(np.int32)
        dists_all = np.asarray(dists_d).astype(np.int32)
        conv_all = np.asarray(conv_d)

    def finish(b: int) -> tuple[bytes, bool]:
        bs = int(lengths[b])
        block = data[b * block_size : b * block_size + bs]
        lens = lens_all[b, :bs].copy()
        dists = dists_all[b, :bs].copy()
        if parity:
            mask = ~conv_all[b, :bs]
            if mask.any():
                if b == 0:
                    hist = dict_tail
                else:
                    hist = data[max(0, b * block_size - HALO) : b * block_size]
                ctx = np.frombuffer(hist + block, np.uint8)
                cut = (b > 0 and b * block_size >= HALO + fmt.BLOCK_END_NO_MATCH)
                native.match_refine(
                    ctx, base=len(hist), bs=bs, lookback=len(hist),
                    mask=mask, lens=lens, dists=dists,
                    cut_pos=(len(hist) - fmt.BLOCK_END_NO_MATCH) if cut else -1,
                )
        native.estimate_costs(lens, dists)
        payload = native.emit_block(block, lens, dists)
        if len(payload) < bs:
            return payload, False
        return block, True

    from . import host as host_par

    out = bytearray(fmt.build_frame_header(False))
    pool = host_par._pool(None)  # persistent: warm native match tables
    results = list(pool.map(finish, range(nblocks)))
    for payload, stored in results:  # ordered concat: frame order preserved
        out += fmt.build_block_header(len(payload), stored=stored, legacy=False)
        out += payload
    out += fmt.build_end_mark(False)
    return bytes(out)
