"""Device decoder: the reference's branchy copy loop (smallz4cat.c:207-343)
re-designed as a gather-based expansion kernel.

Stage split (SURVEY.md §7 step 3):
  (a) sequence parse — an inherently serial byte walk — runs on the host
      through the native runtime (tlz4_parse_sequences, ~1 GB/s);
  (b) expansion runs on device: every output position resolves its source
      through *pointer doubling* — literals terminate in the payload, match
      positions point ``offset`` back; log2(depth) gather rounds turn
      arbitrary dependency chains (including overlap/RLE, where the chain
      depth equals the run length) into direct loads from a source pool.

The source pool is ``concat(history, payload)``: terminal pointers are
encoded as ``-(pool_index + 1)``, so one final gather materializes the
block.  History covers dependent blocks and dictionaries (64 KB prefix).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

HIST_CAP = 65536


@functools.partial(jax.jit, static_argnames=("out_cap",))
def expand_block(
    payload: jnp.ndarray,     # uint8[payload_cap]
    hist: jnp.ndarray,        # uint8[HIST_CAP] (right-aligned valid bytes)
    lit_len: jnp.ndarray,     # int32[seq_cap]  (padded with zeros)
    match_len: jnp.ndarray,   # int32[seq_cap]
    match_off: jnp.ndarray,   # int32[seq_cap]  (padded with 1s)
    lit_src: jnp.ndarray,     # int32[seq_cap]
    out_cap: int,
):
    """Expand one block's sequence table into output bytes.

    Returns uint8[out_cap]; the caller slices the true output length
    (= sum(lit_len) + sum(match_len), known on host)."""
    spans = lit_len + match_len
    seq_start = jnp.cumsum(spans) - spans          # output offset of each sequence
    match_start = seq_start + lit_len

    pos = jnp.arange(out_cap, dtype=jnp.int32)
    # which sequence does each output position belong to?
    sid = jnp.searchsorted(seq_start + spans, pos, side="right").astype(jnp.int32)
    sid = jnp.clip(sid, 0, lit_len.shape[0] - 1)

    is_lit = pos < match_start[sid]
    # pool = [hist (HIST_CAP, right-aligned), payload]: terminals are
    # encoded as -(pool_index + 1)
    lit_pool = HIST_CAP + lit_src[sid] + (pos - seq_start[sid])
    # overlap contraction: byte k of a self-overlapping match (offset <
    # span) repeats the first `offset` source bytes, so point it there
    # directly — chain depth becomes the match *nesting* depth instead of
    # the run length (an RLE run would otherwise need ~log2(len) rounds)
    k = pos - match_start[sid]
    # a literals-only final sequence has match_off == 0; padding positions
    # past the real output can clip onto it — guard the divisor (mod-by-0
    # is implementation-defined in XLA) and force those lanes terminal (a
    # self-referential ptr would spin the pointer-doubling loop forever;
    # the lanes are sliced away by the caller anyway)
    off = match_off[sid]
    raw = match_start[sid] - off + k % jnp.maximum(off, 1)
    hist_pool = HIST_CAP + raw                     # raw < 0: right-aligned hist
    ptr = jnp.where(
        is_lit,
        -(lit_pool + 1),
        jnp.where((raw >= 0) & (off > 0), raw,
                  jnp.where(off > 0, -(hist_pool + 1), -1)),
    )

    def body(p):
        live = p >= 0
        hop = p[jnp.clip(p, 0, out_cap - 1)]
        return jnp.where(live, hop, p)

    ptr = jax.lax.while_loop(
        lambda p: jnp.any(p >= 0), lambda p: body(p), ptr
    )
    pool = jnp.concatenate([hist, payload])
    src = jnp.clip(-ptr - 1, 0, pool.shape[0] - 1)
    return pool[src]


@jax.jit
def _update_hist(hist: jnp.ndarray, out: jnp.ndarray, out_len) -> jnp.ndarray:
    """Right-aligned 64 Ki history window advanced by ``out_len`` bytes of
    ``out`` — device-resident so chained block decodes never round-trip
    through the host."""
    cat = jnp.concatenate([hist, out])
    return jax.lax.dynamic_slice(cat, (out_len,), (HIST_CAP,))


class DeviceBlockDecoder:
    """Pads host sequence tables to static shapes and drives expand_block.

    Shapes are bucketed so repeated calls hit the jit cache: payload,
    sequence and output capacities round up to powers of two (full-size
    blocks of one frame land in one bucket)."""

    def __init__(self, out_cap: int):
        self.out_cap = out_cap

    @staticmethod
    def _bucket(n: int, lo: int = 1024) -> int:
        c = lo
        while c < n:
            c *= 2
        return c

    def decode_dev(self, payload: bytes, hist_dev: jnp.ndarray):
        """Dispatch one block expansion; history and output stay on device.
        Returns (out_dev[out_bucket], out_len)."""
        from .. import native

        lit_len, match_len, match_off, lit_src = native.parse_sequences(payload)
        out_len = int(lit_len.sum() + match_len.sum())
        if out_len > self.out_cap:
            raise ValueError("block exceeds declared maximum size")
        oc = min(self._bucket(out_len, 4096), self._bucket(self.out_cap, 4096))
        pc = self._bucket(len(payload))
        sc = self._bucket(len(lit_len), 256)
        pay = np.zeros(pc, np.uint8)
        pay[: len(payload)] = np.frombuffer(payload, np.uint8)

        def pad(a, fill):
            out = np.full(sc, fill, np.int32)
            out[: len(a)] = a
            return out

        res = expand_block(
            jnp.asarray(pay), hist_dev,
            jnp.asarray(pad(lit_len, 0)), jnp.asarray(pad(match_len, 0)),
            jnp.asarray(pad(match_off, 1)), jnp.asarray(pad(lit_src, 0)),
            out_cap=oc,
        )
        return res, out_len

    @staticmethod
    def hist_device(hist: bytes) -> jnp.ndarray:
        h = np.zeros(HIST_CAP, np.uint8)
        hl = min(len(hist), HIST_CAP)
        if hl:
            h[HIST_CAP - hl :] = np.frombuffer(hist[-hl:], np.uint8)
        return jnp.asarray(h)

    def decode(self, payload: bytes, hist: bytes) -> bytes:
        res, out_len = self.decode_dev(payload, self.hist_device(hist))
        return np.asarray(res)[:out_len].tobytes()


# ---------------------------------------------------------------------------
# batched multi-frame decode — parallelism across frames
# ---------------------------------------------------------------------------

def _bucket(n: int, lo: int) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


@functools.partial(jax.jit, static_argnames=("out_cap",))
def _expand_batch(payload, hist, lit_len, match_len, match_off, lit_src,
                  out_cap: int):
    out = jax.vmap(functools.partial(expand_block, out_cap=out_cap))(
        payload, hist, lit_len, match_len, match_off, lit_src)
    return out


@jax.jit
def _update_hist_batch(hist, out, out_len):
    return jax.vmap(_update_hist)(hist, out, out_len)


def decompress_batch(frames, dictionary: bytes | None = None) -> list:
    """Decode MANY independent LZ4 frames with batched device expansion.

    Single-stream device decode is a chain of dependent gathers
    (docs/PARITY.md "Decode path decision"); this decode parallelism is
    across frames: round r expands block r of EVERY
    frame in one vmapped dispatch, with each frame's 64 KB history
    chained device-resident between rounds.  Host work per block is the
    serial sequence parse (native runtime, ~1 GB/s).

    Stored blocks ride the same kernel as a single literal run, so
    mixed stored/compressed batches stay uniform.  Returns the decoded
    payload of each frame (list of bytes, frame order preserved)."""
    from .. import format as fmt
    from .. import native

    B = len(frames)
    if B == 0:
        return []
    # host parse: every frame -> per-block sequence tables
    per_frame = []  # list of lists of (payload bytes, tables, out_len)
    for data in frames:
        data = bytes(data)
        # leading skippable frames (LZ4 spec) — same acceptance as the
        # single-stream decode paths (pipeline.decompress, native)
        import struct as _struct

        while len(data) >= 8:
            magic = _struct.unpack_from("<I", data, 0)[0]
            if (magic & fmt.MAGIC_SKIPPABLE_MASK) != fmt.MAGIC_SKIPPABLE_BASE:
                break
            skip = _struct.unpack_from("<I", data, 4)[0]
            if 8 + skip > len(data):
                raise fmt.FormatError("out of data")
            data = data[8 + skip:]
        info = fmt.parse_frame_header(data)
        block_cap = (fmt.MAX_BLOCK_SIZE_LEGACY if info.legacy
                     else fmt.MAX_BLOCK_SIZE)
        pos = info.header_size
        blocks = []
        while True:
            if pos + 4 > len(data):
                if info.legacy:
                    break
                raise fmt.FormatError("out of data")
            size, is_comp = fmt.parse_block_header(data[pos:pos + 4],
                                                   info.legacy)
            pos += 4
            if size == 0:
                break
            if pos + size > len(data):
                raise fmt.FormatError("out of data")
            payload = data[pos:pos + size]
            pos += size
            if is_comp:
                ll, ml, mo, ls = native.parse_sequences(payload)
                out_len = int(ll.sum() + ml.sum())
                if out_len > block_cap:
                    # same guard as DeviceBlockDecoder.decode_dev: a corrupt
                    # frame must not size the batch buffers
                    raise fmt.FormatError(
                        "block exceeds declared maximum size")
            else:  # stored block = one literal-run sequence
                ll = np.asarray([size], np.int32)
                ml = np.zeros(1, np.int32)
                mo = np.zeros(1, np.int32)
                ls = np.zeros(1, np.int32)
                out_len = size
            blocks.append((payload, (ll, ml, mo, ls), out_len))
            if info.has_block_checksum:
                pos += 4
            if (info.legacy and is_comp
                    and out_len < fmt.MAX_BLOCK_SIZE_LEGACY):
                break
        per_frame.append(blocks)

    hist = jnp.stack([DeviceBlockDecoder.hist_device(
        bytes(dictionary)[-HIST_CAP:] if dictionary else b"")] * B)
    rounds = max((len(b) for b in per_frame), default=0)
    outs: list[list[bytes]] = [[] for _ in range(B)]
    for r in range(rounds):
        rows = [pf[r] if r < len(pf) else (b"", (np.zeros(0, np.int32),) * 4, 0)
                for pf in per_frame]
        oc = _bucket(max(max((o for _, _, o in rows), default=1), 1), 4096)
        pc = _bucket(max(max((len(p) for p, _, _ in rows), default=1), 1),
                     1024)
        sc = _bucket(max(max((len(t[0]) for _, t, _ in rows), default=1), 1),
                     256)
        pay = np.zeros((B, pc), np.uint8)
        tabs = [np.zeros((B, sc), np.int32) for _ in range(4)]
        tabs[2][:] = 1  # match_off padding
        for i, (p, (ll, ml, mo, ls), _o) in enumerate(rows):
            pay[i, :len(p)] = np.frombuffer(p, np.uint8)
            for t, a in zip(tabs, (ll, ml, mo, ls)):
                t[i, :len(a)] = a
        out = _expand_batch(jnp.asarray(pay), hist,
                            *(jnp.asarray(t) for t in tabs), out_cap=oc)
        lens = jnp.asarray([o for _, _, o in rows], jnp.int32)
        hist = _update_hist_batch(hist, out, lens)
        out_np = np.asarray(out)
        for i, (_p, _t, o) in enumerate(rows):
            if o:
                outs[i].append(out_np[i, :o].tobytes())
    return [b"".join(o) for o in outs]
