"""Walk match finder: the reference's hot loop (smallz4.h:173-255,603-744)
re-designed as a lockstep vectorized candidate walk over fixed-shape
segments.

Design (device-first, not a translation):

* The hash-chain build becomes a *sort*: a stable argsort of the 4-byte
  grams groups equal grams with positions ascending, from which the
  previous-occurrence table ``prev`` falls out with one scatter.  No
  serial table updates, no hash collisions.
* The chain walk becomes a lockstep loop over all positions at once:
  every lane holds its current candidate; each round does one
  previous-occurrence hop (gather), one cheap-reject byte compare
  (gather), and a bounded vectorized common-prefix extension for lanes
  whose candidate could improve.  Distance-1 candidates (byte runs — the
  pathological case) resolve analytically from a precomputed run-length
  array instead of looping.
* Fixed-shape segments: a block is processed as a batch of 64 KB segments,
  each with its 64 KB halo (the LZ4 window bound makes segments
  self-contained).  vmap supplies the batch dimension; shapes never depend
  on the input, so the kernel compiles once per machine (persistent cache).
* Convergence flags: a lane is *converged* when its walk ended for a
  benign reason (chain exhausted, window edge, no longer match can fit)
  with no truncation (extension cap, segment-tail cap, candidate cap).
  Converged lanes equal the reference's -9 search bit-for-bit; unconverged
  lanes hold a valid, near-optimal match and can be refined on the host
  (native.match_refine) for exact parity.

Role: the pipeline's matcher for block sizes the chunk matcher
(ops/chunkmatch.py) cannot tile, and the sharded block-parallel path.
Each walk round is gathers; its rate on the card is not measured yet.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import format as fmt
from . import grams

SEG = 65536                 # positions searched per segment
HALO = fmt.MAX_DISTANCE     # window history carried into each segment
TAIL = 2048                 # segment read-ahead (match headroom; > ext_cap)
SEG_BUF = HALO + SEG + TAIL  # fixed segment buffer size


def build_prev(g: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """int32 previous position with the same gram (-1 if none), via stable
    sort — the device analog of the reference's lastHash/previousExact
    chains (candidate-set theorem, oracle.py docstring)."""
    n = g.shape[0]
    order = jnp.argsort(g, stable=True).astype(jnp.int32)
    sg = g[order]
    same = jnp.concatenate([jnp.zeros(1, bool), sg[1:] == sg[:-1]])
    prev_sorted = jnp.where(same, jnp.roll(order, 1), -1)
    prev = jnp.zeros(n, jnp.int32).at[order].set(prev_sorted)
    # a chain hop must never land on a masked position (padding)
    safe_prev = jnp.clip(prev, 0, n - 1)
    return jnp.where((prev >= 0) & valid[safe_prev], prev, -1)


def _run_lengths(ctx32: jnp.ndarray) -> jnp.ndarray:
    """R[i] = length of the maximal equal-byte run starting at i (device
    analog of the reference's byte-run handling: a distance-1 candidate has
    LCP exactly R[q] - 1)."""
    n = ctx32.shape[0]
    boundary = jnp.concatenate([ctx32[:-1] != ctx32[1:], jnp.ones(1, bool)])
    idx = jnp.where(boundary, jnp.arange(n, dtype=jnp.int32), n - 1)
    nxt = jax.lax.associative_scan(jnp.minimum, idx, reverse=True)
    return nxt - jnp.arange(n, dtype=jnp.int32) + 1


def _match_core(
    ctx: jnp.ndarray,
    start_valid: jnp.ndarray,
    end_valid: jnp.ndarray,
    base: int,
    search_len: int,
    max_candidates: int,
    cut_boundary,
    ext_cap: int,
):
    """Single-segment search core (see module docstring).  ``ctx`` is the
    fixed-size segment buffer; positions [base, base+search_len) are
    searched; [start_valid, end_valid) bounds the real bytes."""
    n = ctx.shape[0]
    g = grams.grams4(ctx)
    pos = jnp.arange(n, dtype=jnp.int32)
    valid = (pos >= start_valid) & (pos + fmt.BLOCK_END_NO_MATCH <= end_valid)
    prev = build_prev(g, valid)
    # block-boundary chain cut (reference re-insertion anomaly; oracle.py):
    # applied when this segment starts a block whose history carries over
    cut_pos = base - fmt.BLOCK_END_NO_MATCH
    prev = jnp.where(
        cut_boundary & (pos == cut_pos), jnp.int32(-1), prev
    )

    ctx32 = ctx.astype(jnp.int32)
    runs = _run_lengths(ctx32)
    match_limit = end_valid - fmt.BLOCK_END_LITERALS
    cap = jnp.maximum(match_limit - pos, 0)

    q0 = prev
    best0 = jnp.ones(n, jnp.int32)
    dist0 = jnp.zeros(n, jnp.int32)
    searchable = valid & (pos >= base) & (pos < base + search_len)

    def take(arr, idx):
        return arr[jnp.clip(idx, 0, n - 1)]

    def lane_active(q, best):
        return searchable & (q >= 0) & (pos - q <= fmt.MAX_DISTANCE) & (best + 1 <= cap)

    def round_fn(state):
        q, best, dist, hit_cap, i = state
        active = lane_active(q, best)
        # cheap reject: candidate must extend the current best by >= 1
        maybe = active & (take(ctx32, q + best) == take(ctx32, pos + best))
        # distance-1 candidates are byte runs: LCP is analytic
        d1 = maybe & (pos - q == 1)
        lcp_d1 = jnp.minimum(take(runs, q) - 1, cap)

        # bounded common-prefix extension via the overlapping-u32 view
        eff_cap = jnp.minimum(cap, ext_cap)
        mex = maybe & ~d1

        def ext_round(est):
            k, open_ = est
            x = take(g, pos + k) ^ take(g, q + k)
            step = jnp.where(x == 0, 4, grams.mismatch_bytes_in_u32(x))
            k2 = jnp.minimum(k + jnp.where(open_, step, 0), eff_cap)
            return k2, open_ & (x == 0) & (k2 < eff_cap)

        k0 = jnp.where(mex, jnp.minimum(4, eff_cap), 0)
        ext = jax.lax.while_loop(
            lambda e: jnp.any(e[1]), ext_round, (k0, mex & (k0 < eff_cap))
        )
        lcp_ext = ext[0]
        truncated = mex & (lcp_ext >= eff_cap) & (eff_cap < cap)

        lcp = jnp.where(d1, lcp_d1, lcp_ext)
        improved = maybe & (lcp >= best + 1)
        best = jnp.where(improved, lcp, best)
        dist = jnp.where(improved, pos - q, dist)
        hit_cap = hit_cap | truncated
        q = jnp.where(active, take(prev, q), q)
        return q, best, dist, hit_cap, i + 1

    def round_cond(state):
        q, best, _, _, i = state
        return (i < max_candidates) & jnp.any(lane_active(q, best))

    state = (q0, best0, dist0, jnp.zeros(n, bool), jnp.int32(0))
    q, best, dist, hit_cap, _ = jax.lax.while_loop(round_cond, round_fn, state)

    # benign walk end, no truncation, and the match didn't slam into the
    # (possibly segment-clamped) cap
    exhausted = (q < 0) | (pos - q > fmt.MAX_DISTANCE) | (best + 1 > cap)
    at_limit = best >= cap
    converged = (exhausted & ~hit_cap & ~at_limit) | ~searchable

    lens = jnp.where(searchable, best, jnp.where(pos >= base, 1, 0))
    dists = jnp.where(searchable, dist, 0)
    s = slice(base, base + search_len)
    return lens[s], dists[s], converged[s]


@functools.partial(
    jax.jit,
    static_argnames=("base", "search_len", "max_candidates", "ext_cap"),
)
def match_block(
    ctx: jnp.ndarray,
    base: int,
    start_valid=None,
    end_valid=None,
    search_len: int | None = None,
    max_candidates: int = 64,
    cut_boundary: bool | jnp.ndarray = True,
    ext_cap: int = 512,
):
    """Whole-buffer search (tests and small blocks): positions
    [base, base+search_len) of ctx are searched in one shot."""
    n = ctx.shape[0]
    if start_valid is None:
        start_valid = jnp.int32(0)
    if end_valid is None:
        end_valid = jnp.int32(n)
    if search_len is None:
        search_len = n - base
    return _match_core(
        ctx, jnp.asarray(start_valid, jnp.int32), jnp.asarray(end_valid, jnp.int32),
        base, search_len, max_candidates, jnp.asarray(cut_boundary, bool), ext_cap
    )


@functools.partial(jax.jit, static_argnames=("max_candidates", "ext_cap"))
def match_segments(
    bufs: jnp.ndarray,         # uint8[B, SEG_BUF]
    start_valid: jnp.ndarray,  # int32[B]
    end_valid: jnp.ndarray,    # int32[B]
    cut_boundary: jnp.ndarray,  # bool[B]
    max_candidates: int = 16,
    ext_cap: int = 512,
):
    """Batched fixed-shape segment search: the production encode kernel.
    Each row is one segment buffer [halo | 64 Ki positions | read-ahead].

    Returns compact host-transfer-friendly arrays of shape [B, SEG]:
    lens uint16 (saturated at 65535 — a saturated lane is never marked
    converged, so parity mode re-searches it), dists uint16, converged
    bool.  Compact dtypes matter: the hybrid pipeline ships these to the
    host DP stage for every block."""
    fn = functools.partial(
        _match_core,
        base=HALO,
        search_len=SEG,
        max_candidates=max_candidates,
        ext_cap=ext_cap,
    )
    lens, dists, conv = jax.vmap(
        lambda b, s, e, c: fn(b, s, e, cut_boundary=c)
    )(bufs, start_valid, end_valid, cut_boundary)
    saturated = lens >= 65536
    lens16 = jnp.minimum(lens, 65535).astype(jnp.uint16)
    return lens16, dists.astype(jnp.uint16), conv & ~saturated
