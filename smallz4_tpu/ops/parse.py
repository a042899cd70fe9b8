"""Device optimal parser: the backward cost DP as policy iteration.

The reference's `estimateCosts` (smallz4.h:376-472) is a backward scan:
cost[i] = min(literal via cost[i+1] + extra-byte accounting, match via
cost[i+len] + extra(len) for every len in [4, L[i]], ascending scan with
`<=` acceptance).  That recurrence is serial through cost[i+1], and its
serial chain length is the token count of the optimal parse — a CPU core
wins that race (native/src/tlz4.cpp:496-559 runs it at ~166 MB/s/core).

This module gives the same parse ON DEVICE — for device-resident
pipelines where claims should never cross the host link — via **policy
iteration**, which replaces the O(#tokens) serial chain with a handful
of global rounds:

  1. *Policy evaluation*: the current per-position decision array (take
     the match of length choice[i], or a literal) forms a functional
     jump graph; its exact cost-to-block-end is evaluated in log2(n)
     pointer-doubling rounds (gathers), with the literal extra-byte
     accounting resolved by a suffix run-length scan (the num_lit
     thresholds at 15, 270, 525, ... — smallz4.h:398-404).
  2. *Policy improvement*: every position re-decides in parallel with
     the reference's exact rule against the evaluated costs: tier-1
     lengths (4..18) as static shifts, tiers >= 2 as range-min lookups
     in a doubling sparse table keyed (cost, last-argmin), the
     ascending `<=` tie-break (longer length wins equal cost,
     smallz4.h:431-448), and the MaxSameLetter distance-1 run shortcut
     (smallz4.h:409-416).

Termination: decisions unchanged => the pair (cost, choice) satisfies
the reference's backward-induction equations at every position, and that
system has a unique solution (induction from the block tail) — so the
converged decisions equal `estimateCosts`' element-wise.  Bit-parity is
asserted by differential tests against the native DP
(tests/test_parse.py).

Economics: each round costs ~36 gathers/position, so the rate follows
the device's gather rate (not measured on the card yet); the hybrid
host-DP default remains the throughput path; this kernel exists for
device-resident completeness (SURVEY.md §7 step 5) and as the base of
the device emitter.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import format as fmt

TIER0_HI = 18          # lengths 4..18 cost 3 extra bytes (smallz4.h:419)
TIER_W = 255           # each further tier adds one extra byte
TABLE_LEVELS = 8       # doubling range-min table covers widths <= 255


def _shift_up(x: jnp.ndarray, s: int, fill):
    """out[i] = x[i + s] with static s (slice + pad)."""
    if s >= x.shape[0]:
        return jnp.full_like(x, fill)
    return jnp.concatenate([x[s:], jnp.full((s,), fill, x.dtype)])


def _extra_match(length: jnp.ndarray) -> jnp.ndarray:
    """Token + offset + length-extension bytes for a match of ``length``
    (smallz4.h:419-456): 3 for lengths 4..18, then +1 per 255."""
    return jnp.where(length <= TIER0_HI, 3,
                     4 + (length - (TIER0_HI + 1)) // TIER_W)


def _lit_runs(lit: jnp.ndarray) -> jnp.ndarray:
    """r[i] = length of the consecutive True run starting at i
    (suffix run-length, log-step doubling)."""
    n = lit.shape[0]
    r = lit.astype(jnp.int32)
    s = 1
    while s < n:
        r = jnp.where(r == s, s + _shift_up(r, s, 0), r)
        s *= 2
    return r


def _floor_log2_255(w: jnp.ndarray) -> jnp.ndarray:
    """floor(log2(w)) for w in [1, 255] via compares."""
    k = jnp.zeros_like(w)
    for p in (2, 4, 8, 16, 32, 64, 128):
        k = k + (w >= p).astype(jnp.int32)
    return k


def _lit_extra(num_lit: jnp.ndarray) -> jnp.ndarray:
    """1 when this literal starts another length-extension byte
    (num_lit thresholds 15, 270, 525, ... — smallz4.h:398-404)."""
    return ((num_lit == 15)
            | ((num_lit >= 15 + TIER_W)
               & ((num_lit - 15) % TIER_W == 0))).astype(jnp.int32)


def _policy_eval(choice: jnp.ndarray, limit, n_end) -> jnp.ndarray:
    """Exact cost-to-end of following ``choice`` from every position.

    choice[i] = 1 (literal) or the match length (4 <= len <= limit-i).
    Positions >= limit (= n - BLOCK_END_LITERALS) are the zero-cost
    absorbing tail (smallz4.h:507-511)."""
    N = choice.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    term = idx >= limit
    # the literal-run flag stops at the real block end: the reference's
    # num_lit base is exactly the BLOCK_END_LITERALS tail bytes
    # (smallz4.h:515); padding beyond n must not extend the run
    lit = ((choice <= 1) | term) & (idx < n_end)

    # num_lit at the moment position i is processed = 1 + run of literal
    # decisions at i+1.. (the run extends through the real tail
    # literals, giving the reference's kBlockEndLiterals base —
    # smallz4.h:515,517)
    num_lit = 1 + _shift_up(_lit_runs(lit), 1, 0)
    step = jnp.where(lit, 1 + _lit_extra(num_lit), _extra_match(choice))
    span = jnp.where(lit, 1, choice)
    nxt = jnp.minimum(idx + span, jnp.int32(N - 1))
    step = jnp.where(term, 0, step)      # absorbing tail: zero-cost
    nxt = jnp.where(term, idx, nxt)      # self-loop

    acc = step
    s = 1
    while s < N:
        acc = acc + jnp.take(acc, nxt)
        nxt = jnp.take(nxt, nxt)
        s *= 2
    return acc


def _range_min_table(cost: jnp.ndarray):
    """Doubling sparse table over (cost[j], j) with last-argmin
    semantics: level k holds (min cost, largest argmin) over
    [j, j + 2^k), flattened for single-gather lookups."""
    N = cost.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    BIG = jnp.int32(1 << 30)
    cs, js = [cost], [idx]
    c, j = cost, idx
    for k in range(TABLE_LEVELS - 1):
        c2 = _shift_up(c, 1 << k, BIG)
        j2 = _shift_up(j, 1 << k, 0)
        take2 = (c2 < c) | ((c2 == c) & (j2 > j))
        c = jnp.where(take2, c2, c)
        j = jnp.where(take2, j2, j)
        cs.append(c)
        js.append(j)
    return jnp.concatenate(cs), jnp.concatenate(js)


@functools.partial(jax.jit, static_argnames=("max_iters",))
def estimate_costs_device(lens: jnp.ndarray, dists: jnp.ndarray, n,
                          max_iters: int = 48):
    """Device optimal parse: returns (choice, cost, converged).

    ``choice`` element-wise equals the lens array `tlz4_estimate_costs`
    writes back (1 = literal, else the shortened match length) for the
    first ``n`` positions; ``cost[0]`` is the reference's cost[0].
    ``converged`` False means the iteration cap was hit (callers fall
    back to the host DP — a safety net, not observed in practice)."""
    N = lens.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    limit = jnp.asarray(n, jnp.int32) - fmt.BLOCK_END_LITERALS
    term = idx >= limit
    # clamp claims to the DP's legal range (reference finders guarantee
    # this; defensive for device claims)
    L = jnp.minimum(lens.astype(jnp.int32), jnp.maximum(limit - idx, 0))
    L = jnp.where((L >= fmt.MIN_MATCH) & ~term, L, 1)
    run_sc = (L >= fmt.MAX_SAME_LETTER) & (dists.astype(jnp.int32) == 1)

    # tiers needed = tier of the largest scanned (non-shortcut) length
    maxL = jnp.max(jnp.where(run_sc, 0, L))
    n_tiers = jnp.where(maxL > TIER0_HI,
                        2 + (maxL - (TIER0_HI + 1)) // TIER_W,
                        jnp.int32(1))

    n_end = jnp.asarray(n, jnp.int32)

    def improve(choice):
        cost = _policy_eval(choice, limit, n_end)

        # literal candidate with the current policy's run accounting
        lit_now = ((choice <= 1) | term) & (idx < n_end)
        num_lit = 1 + _shift_up(_lit_runs(lit_now), 1, 0)
        best_c = _shift_up(cost, 1, 0) + 1 + _lit_extra(num_lit)
        best_l = jnp.ones_like(choice)

        # tier 1: lengths 4..18, static shifts, ascending `<=` scan
        for ln in range(fmt.MIN_MATCH, TIER0_HI + 1):
            tot = _shift_up(cost, ln, 1 << 30) + 3
            ok = (L >= ln) & (tot <= best_c)
            best_c = jnp.where(ok, tot, best_c)
            best_l = jnp.where(ok, jnp.int32(ln), best_l)

        # tiers >= 2: range-min with last-argmin over the sparse table
        tc, tj = _range_min_table(cost)

        def tier_body(t, carry):
            bc, bl = carry
            lo = TIER0_HI + 1 + TIER_W * (t - 2)
            e = jnp.minimum(L, lo + TIER_W - 1)
            w = e - lo + 1
            active = w >= 1
            k = _floor_log2_255(jnp.maximum(w, 1))
            a = jnp.clip(idx + lo, 0, N - 1)
            b = jnp.clip(idx + e - (1 << k) + 1, 0, N - 1)
            c1, j1 = jnp.take(tc, k * N + a), jnp.take(tj, k * N + a)
            c2, j2 = jnp.take(tc, k * N + b), jnp.take(tj, k * N + b)
            take2 = (c2 < c1) | ((c2 == c1) & (j2 > j1))
            mc = jnp.where(take2, c2, c1)
            mj = jnp.where(take2, j2, j1)
            tot = mc + 2 + t  # tier t extra bytes = 3 + (t - 1)
            ok = active & (tot <= bc)
            return (jnp.where(ok, tot, bc), jnp.where(ok, mj - idx, bl))

        best_c, best_l = jax.lax.fori_loop(
            2, n_tiers + 1, tier_body, (best_c, best_l))

        # MaxSameLetter distance-1 run shortcut OVERRIDES the scan
        # (smallz4.h:409-416: the full match is taken without comparing
        # to the literal; its cost re-evaluates next round)
        best_l = jnp.where(run_sc & ~term, L, jnp.where(term, 1, best_l))
        return best_l

    def body(carry):
        choice, it, _ = carry
        new_choice = improve(choice)
        return new_choice, it + 1, jnp.any(new_choice != choice)

    def cond(carry):
        _, it, changed = carry
        return changed & (it < max_iters)

    init = jnp.where(run_sc & ~term, L,
                     jnp.where(term | (L < fmt.MIN_MATCH), 1, L))
    choice, iters, changed = jax.lax.while_loop(
        cond, body, (init, jnp.int32(0), jnp.bool_(True)))
    cost = _policy_eval(choice, limit, n_end)
    return choice, cost, ~changed
