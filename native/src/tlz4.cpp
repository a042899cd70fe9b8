/* tlz4.cpp — native host runtime: LZ4 block codec + streaming frame layer.
 *
 * Clean-room implementation against the framework's behavioral spec
 * (smallz4_tpu/oracle.py docstring); golden-tested bit-exact against both
 * the oracle and the reference binaries.
 *
 * Matcher design: a single same-hash chain over a 64 Ki ring of *absolute*
 * positions, with 4-byte verification at walk time.  This is semantically
 * identical to the reference's two-level chains (smallz4.h:515-529): hash
 * collisions only add walk steps, never change outcomes (candidate-set
 * theorem, SURVEY.md).  Absolute positions + window checks make ring-slot
 * staleness impossible for any block size.
 */
#include "../include/tlz4.h"

#include <cassert>
#include <cstring>
#include <vector>
#include <algorithm>
#include <memory>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int64_t kMinMatch = 4;
constexpr int64_t kBlockEndNoMatch = 12;
constexpr int64_t kBlockEndLiterals = 5;
constexpr int64_t kMaxDistance = 65535;
constexpr int64_t kMaxSameLetter = 19 + 255 * 256;
constexpr int64_t kMaxBlock = 4 * 1024 * 1024;
constexpr int64_t kMaxBlockLegacy = 8 * 1024 * 1024;
constexpr int kHashBits = 20;
constexpr uint32_t kHashMul = 48271;  /* LCG multiplier (smallz4.h:164-169) */
constexpr int kGreedyLevels = 3;      /* smallz4.h:77 */
constexpr int kLazyLevels = 6;        /* smallz4.h:79 */

inline uint32_t load32(const uint8_t *p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t load64(const uint8_t *p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
inline void store32(uint8_t *p, uint32_t v) { std::memcpy(p, &v, 4); }

inline uint32_t hash_gram(uint32_t g) {
  return (g * kHashMul) >> (32 - kHashBits);
}

/* Auxiliary long-gram skip chains (see MatchTables).  kAuxLen[j] is the
 * prefix length that defines chain j; the chain is usable once the walk's
 * best reaches kAuxLen[j]-1 (any further improver must share best+1 >=
 * kAuxLen[j] bytes).  Hashes sample the prefix's first and last 8 bytes —
 * positions sharing the full prefix always collide into the same bucket,
 * and false bucket-mates are filtered by the walk's cheap reject, so any
 * mixer is correct. */
constexpr int kNumAux = 3;
constexpr int64_t kAuxLen[kNumAux] = {5, 9, 32}; /* tuned; see PERF.md */
constexpr int kAuxBits = 22;
inline uint32_t mix64(uint64_t g) {
  return uint32_t((g * 0x9E3779B97F4A7C15ull) >> (64 - kAuxBits));
}
inline uint32_t aux_hash(int j, const uint8_t *pp) {
  if (j == 0) return mix64(load64(pp) & 0xFFFFFFFFFFull); /* 5 bytes */
  return mix64(load64(pp) ^
               (load64(pp + kAuxLen[j] - 8) * 0xC2B2AE3D27D4EB4Full));
}

inline int64_t max_chain_of_level(int level) {
  return level == 9 ? kMaxDistance : level;
}

/* common-prefix length of a vs b, capped; little-endian ctz trick */
inline int64_t lcp(const uint8_t *a, const uint8_t *b, int64_t cap) {
  int64_t i = 0;
#if defined(__AVX2__)
  while (i + 32 <= cap) {
    __m256i va = _mm256_loadu_si256((const __m256i *)(a + i));
    __m256i vb = _mm256_loadu_si256((const __m256i *)(b + i));
    uint32_t eq = uint32_t(_mm256_movemask_epi8(_mm256_cmpeq_epi8(va, vb)));
    if (eq != 0xFFFFFFFFu) return i + __builtin_ctz(~eq);
    i += 32;
  }
#endif
  while (i + 8 <= cap) {
    uint64_t x = load64(a + i) ^ load64(b + i);
    if (x) return i + (__builtin_ctzll(x) >> 3);
    i += 8;
  }
  while (i < cap && a[i] == b[i]) i++;
  return i;
}

/* ------------------------------------------------------------------ */
/* match finder                                                        */
/* ------------------------------------------------------------------ */

/* Chain tables.  The 4-byte chain reproduces the reference's candidate
 * order exactly.  The 8- and 16-byte chains are *skip lists over the same
 * candidate sequence*: once the walk's best match reaches 8 (resp. 16)
 * bytes, every further improvement must share an 8- (16-) byte prefix
 * with the current position, so hopping the longer-gram chain visits a
 * superset of all remaining improvers in the same nearest-first order —
 * the improvement sequence (and thus the output) is bit-identical while
 * skipping candidates that can no longer matter. */
struct MatchTables {
  std::vector<int64_t> head;  /* (1<<20) hash -> last inserted abs position */
  std::vector<int64_t> link;  /* 64 Ki ring: previous same-hash abs position */
  std::vector<int64_t> aux_head[kNumAux], aux_link[kNumAux];
  /* live boundary chain cuts (pos, 4-byte-chain hash): a skip-chain hop
   * for a position whose 4-chain passes through a cut must not jump past
   * it (see find_longest).  At most ~window/block_size entries. */
  std::vector<std::pair<int64_t, uint32_t>> cuts;
  /* most recent position whose level-j gram wasn't readable at insert
   * time (streaming: the block was emitted before enough input arrived).
   * While such a position is inside the search window that chain may be
   * incomplete, so walks use the next complete level down. */
  int64_t deferred[kNumAux];

  MatchTables()
      : head(size_t(1) << kHashBits, -1), link(kMaxDistance + 1, -1) {
    for (int j = 0; j < kNumAux; j++) {
      aux_head[j].assign(size_t(1) << kAuxBits, -1);
      aux_link[j].assign(kMaxDistance + 1, -1);
      deferred[j] = INT64_MIN;
    }
  }
  void reset() {
    std::fill(head.begin(), head.end(), int64_t(-1));
    std::fill(link.begin(), link.end(), int64_t(-1));
    for (int j = 0; j < kNumAux; j++) {
      std::fill(aux_head[j].begin(), aux_head[j].end(), int64_t(-1));
      std::fill(aux_link[j].begin(), aux_link[j].end(), int64_t(-1));
      deferred[j] = INT64_MIN;
    }
    cuts.clear();
  }
  void add_cut(int64_t pos, uint32_t h4) {
    /* drop cuts that fell out of every future window */
    size_t w = 0;
    for (size_t r = 0; r < cuts.size(); r++)
      if (cuts[r].first + kMaxDistance >= pos) cuts[w++] = cuts[r];
    cuts.resize(w);
    cuts.emplace_back(pos, h4);
  }
  int64_t barrier_for(int64_t p, uint32_t h4) const {
    int64_t b = -1;
    for (const auto &c : cuts)
      if (c.second == h4 && c.first <= p) b = std::max(b, c.first);
    return b;
  }
};

/* Table insert for abs position p; returns the nearest prior occurrence of
 * p's gram within the window (>= min_pos), or -1 when the gate fails.
 * A re-insertion (block-boundary lookback) cuts p's chain link — the
 * reference's stored-distance-0 anomaly (smallz4.h:667,676,720). */
inline int64_t insert_and_gate(MatchTables &t, const uint8_t *buf,
                               int64_t buf_zero, int64_t min_pos,
                               int64_t p, uint32_t gram, int64_t buf_end,
                               int aux_levels, bool need_gate = true) {
  const uint8_t *pp = buf + (p - buf_zero);
  const int64_t slot = p & kMaxDistance;
  /* skip-list chains: same insertion set, sparser keys.  A position whose
   * level-j gram reaches past the readable buffer is left off that chain
   * (and deferred); it can only become a >=kAuxLen[j]+1-byte improver for
   * searches that see more buffered bytes, which fall back via deferred.
   * Greedy/lazy levels never walk far enough to amortize the inserts, so
   * aux maintenance is skipped there (the 4-chain walk alone is already
   * the reference's exact walk). */
  for (int j = 0; j < aux_levels; j++) {
    if (p + kAuxLen[j] > buf_end) {
      for (; j < kNumAux; j++) t.deferred[j] = p;
      break;
    }
    uint32_t hj = aux_hash(j, pp);
    int64_t qj = t.aux_head[j][hj];
    t.aux_head[j][hj] = p;
    if (qj != p) /* boundary re-insert keeps the original link (the cut is
                    enforced by the walk barrier, not the aux rings) */
      t.aux_link[j][slot] =
          (qj >= 0 && p - qj <= kMaxDistance && qj >= min_pos) ? qj : -1;
  }
  uint32_t h = hash_gram(gram);
  int64_t q = t.head[h];
  t.head[h] = p;
  if (q == p) {  /* boundary re-insert */
    t.link[slot] = -1;
    t.add_cut(p, h);
    return -1;
  }
  bool in_window = q >= 0 && p - q <= kMaxDistance && q >= min_pos;
  t.link[slot] = in_window ? q : -1;
  if (!in_window) return -1;
  /* the exact-gram walk below only serves the caller's candidate gate —
   * positions whose result is unused (masked-out refine positions,
   * lookback seeding) stop here with the tables fully updated */
  if (!need_gate) return -1;
  /* hop same-hash entries until the gram matches exactly */
  while (load32(buf + (q - buf_zero)) != gram) {
    q = t.link[q & kMaxDistance];
    if (q < 0 || p - q > kMaxDistance || q < min_pos) return -1;
  }
  return q;
}

/* findLongestMatch parity (smallz4.h:173-255): walk same-gram candidates
 * nearest-first; a candidate improves iff its common prefix extends the
 * current best by >= 1; improvements consume the level's step budget. */
inline void find_longest(const MatchTables &t, const uint8_t *buf,
                         int64_t buf_zero, int64_t min_pos, int64_t p,
                         int64_t q0, int64_t cap, int64_t max_chain,
                         int64_t run_start, int64_t run_ins_tail,
                         int aux_levels, int32_t *out_len,
                         int32_t *out_dist,
                         int64_t early_stop = INT64_MAX) {
  const uint8_t *cur = buf + (p - buf_zero);
  const uint32_t gram = load32(cur);
  /* Boundary chain cuts (block-boundary re-insert, smallz4.h:667,676,720)
   * break the re-inserted position's 4-byte chain.  The 4-chain honors
   * them naturally (its ring link is -1); skip-list hops must not jump
   * past the nearest cut that lies on p's own 4-chain. */
  const int64_t barrier = t.barrier_for(p, hash_gram(gram));
  /* Byte-run interval skip: when p sits in an equal-byte run with a pure
   * 4-gram, every candidate q in (run_start, p) has the same common
   * prefix (run end minus p) — none can improve after the nearest one is
   * evaluated, so hops jump from the snap target's links instead of
   * crawling the run (quadratic -> constant).  The snap target must be a
   * LEGAL hop source: an actually-inserted position within the window,
   * >= min_pos and >= barrier.  An out-of-window (or never-inserted) run
   * head's 64 Ki ring slot belongs to a newer position, so hopping from
   * it can return a candidate above the snap point and cycle forever; a
   * head below a chain cut would leak candidates past the cut (both seen
   * on >64 KiB runs, regression a52b318).  The head itself is the best
   * target when legal; otherwise snap to the earliest legal member of
   * the run's contiguously-inserted suffix [run_ins_tail, p) — skipped
   * candidates are still all same-prefix non-improvers, and the hop
   * source's ring slot is guaranteed its own. */
  int64_t rskip = INT64_MAX;
  if (run_start < p && cur[0] == cur[1] && cur[1] == cur[2] &&
      cur[2] == cur[3]) {
    const int64_t lo =
        std::max({p - kMaxDistance, min_pos, barrier});
    int64_t s = run_start;
    if (s < lo) s = std::max(run_ins_tail, lo);
    if (s < p) rskip = s;
  }
  int64_t best = 1, best_dist = 0, steps = max_chain;
  int64_t q = q0;
  int lvl = -1; /* -1 = 4-byte hash chain; j >= 0 = aux chain kAuxLen[j] */
  while (q >= 0) {
    if (best + 1 > cap) break;
    const uint8_t *cand = buf + (q - buf_zero);
    if (cand[best] == cur[best]) {  /* cheap reject of non-improvers */
      int64_t len = lcp(cur, cand, cap);
      if (len >= best + 1) {
        best = len;
        best_dist = p - q;
        /* early_stop: the caller certified the exact max length, so the
         * first achiever (nearest-first walk order) IS the reference's
         * kept candidate — later candidates can only tie and the
         * reference's '>' acceptance would discard them anyway. */
        if (best >= early_stop) break;
        if (--steps == 0) break;
      }
    }
    /* hop the sparsest chain that still holds every possible improver:
     * once best >= kAuxLen[j], (a) any improver shares a kAuxLen[j]-byte
     * prefix with p, and (b) the walk's current position does too (it was
     * the last improver or a bucket-mate), so it sits on the same chain-j
     * bucket as every remaining improver — hopping chain j skips
     * candidates that can no longer matter without changing the
     * improvement sequence (bit parity preserved).  Hash colliders on aux
     * chains are not re-verified: a collider's common prefix
     * (< kAuxLen[j] <= best) can't reach best+1, so the cheap reject +
     * lcp test filters it with no effect on the output. */
    while (lvl + 1 < aux_levels && best >= kAuxLen[lvl + 1] &&
           t.deferred[lvl + 1] < p - kMaxDistance)
      lvl++;
    if (q > rskip) q = rskip; /* run interval: hop from the run head */
    if (lvl >= 0) {
      q = t.aux_link[lvl][q & kMaxDistance];
      if (q < 0 || q < barrier || p - q > kMaxDistance || q < min_pos)
        q = -1;
    } else {
      /* next same-gram candidate along the same-hash chain */
      do {
        q = t.link[q & kMaxDistance];
        if (q < 0 || q < barrier || p - q > kMaxDistance || q < min_pos) {
          q = -1;
          break;
        }
        if (q > rskip) q = rskip;
      } while (load32(buf + (q - buf_zero)) != gram);
    }
  }
  *out_len = int32_t(best);
  *out_dist = int32_t(best_dist);
}

/* Per-block scan (smallz4.h:603-747): byte-run shortcut, table inserts,
 * candidate gate, greedy/lazy skip bookkeeping, trailing literals. */
void match_block(MatchTables &t, const uint8_t *buf, int64_t buf_zero,
                 int64_t min_pos, int64_t base, int64_t bs, int level,
                 int64_t lookback, int64_t buf_end, int32_t *lens,
                 int32_t *dists, const uint8_t *refine_mask = nullptr,
                 int64_t cut_pos = -1, int64_t block_end = -1,
                 const int32_t *targets = nullptr) {
  /* refine_mask: when set (level-9 only, no skip interdependence), run the
   * search only at flagged positions; unflagged keep their incoming
   * (len, dist) — the host side of the device parity fallback.
   * block_end: absolute end of the enclosing LZ4 block.  Defaults to
   * base+bs (the classic whole-block call).  When base+bs < block_end this
   * is a *chunk* call: positions [base, base+bs) of a larger block are
   * searched with the block's own end rules (match_limit, 12-byte no-match
   * tail), enabling bit-exact intra-block parallelism at the non-skipping
   * levels (7-9), where per-position results depend only on the data
   * (candidate-set theorem, SURVEY.md). */
  const int64_t max_chain = max_chain_of_level(level);
  const bool is_greedy = max_chain <= kGreedyLevels;
  const bool is_lazy = !is_greedy && max_chain <= kLazyLevels;
  /* greedy walks stop after <= 3 improvements — aux upkeep can't pay for
   * itself there; lazy levels keep just the cheap 5-byte chain; the
   * optimal levels (7-9) walk enough to profit from all of them */
  const int aux_levels =
      max_chain <= kGreedyLevels ? 0 : (max_chain <= kLazyLevels ? 1 : kNumAux);
  if (block_end < 0) block_end = base + bs;
  const int64_t match_limit = block_end - kBlockEndLiterals;
  if (!refine_mask) {
    std::memset(lens, 0, sizeof(int32_t) * size_t(bs));
    std::memset(dists, 0, sizeof(int32_t) * size_t(bs));
  }

  int64_t skip = 0;
  bool lazy_eval = false;
  int64_t i = -lookback;
  int64_t i_end = std::min(bs, block_end - base - kBlockEndNoMatch + 1);
  if (refine_mask) {
    /* Masked mode: a walk at masked p consults only candidates in
     * [p - kMaxDistance, p), so inserts outside
     * [first_masked - (kMaxDistance + kBlockEndNoMatch), last_masked]
     * cannot influence any output — clamp the scan to that range (the
     * fixed table-insert cost dominates sparse refines).  The boundary
     * cut must stay inside the range when live: it rewrites chain
     * structure that in-range walks may traverse. */
    int64_t first = -1, last = -1;
    for (int64_t j = 0; j < bs; j++)
      if (refine_mask[j]) { first = j; break; }
    for (int64_t j = bs - 1; j >= 0; j--)
      if (refine_mask[j]) { last = j; break; }
    if (first < 0) return;
    int64_t lo = first - (kMaxDistance + kBlockEndNoMatch);
    if (cut_pos >= 0) lo = std::min(lo, cut_pos - base);
    i = std::max(i, lo);
    i_end = std::min(i_end, last + 1);
  }
  int64_t run_start = base + i; /* head of the current equal-byte run */
  /* start of the run's contiguously-inserted suffix: every position in
   * [run_ins_tail, p) went through insert_and_gate (only the byte-run
   * shortcut skips the insert) — legal snap targets for find_longest's
   * run interval skip */
  int64_t run_ins_tail = run_start;
  constexpr int64_t kPF = 8; /* head-table prefetch distance */
  /* last scanned i: within this call's range AND >= 12 before block end
     (i_end may be clamped further by the masked-mode range above) */
  for (; i < i_end; i++) {
    const int64_t p = base + i;
    const uint8_t *pp = buf + (p - buf_zero);
    if (i > -lookback && pp[0] != pp[-1]) run_start = run_ins_tail = p;
    if (i + kPF < i_end) {
      /* the insert keys of position p+kPF are already computable: hide
       * the head tables' cache latency behind the current walk */
      const uint8_t *fp = pp + kPF;
      __builtin_prefetch(&t.head[hash_gram(load32(fp))], 1);
      if (aux_levels > 0)
        __builtin_prefetch(&t.aux_head[0][aux_hash(0, fp)], 1);
      if (aux_levels > 1) {
        if (p + kPF + kAuxLen[1] <= buf_end)
          __builtin_prefetch(&t.aux_head[1][aux_hash(1, fp)], 1);
        if (p + kPF + kAuxLen[2] <= buf_end)
          __builtin_prefetch(&t.aux_head[2][aux_hash(2, fp)], 1);
      }
    }
    if (i > 0 && pp[0] == pp[-1]) {  /* byte-run shortcut: skips the insert */
      int32_t plen = lens[i - 1];
      if (dists[i - 1] == 1 && plen > kMaxSameLetter) {
        lens[i] = plen - 1;
        dists[i] = 1;
        run_ins_tail = p + 1; /* p skips the insert */
        continue;
      }
    }
    /* the gate result is consumed only when this position will search (or
     * drive skip bookkeeping, which needs i >= 0); skipping the exact-gram
     * walk for the rest cuts the refine path's fixed per-position cost */
    const bool need_gate =
        i >= 0 && (!refine_mask || refine_mask[i] != 0);
    int64_t q0 = insert_and_gate(t, buf, buf_zero, min_pos, p, load32(pp),
                                 buf_end, aux_levels, need_gate);
    if (p == cut_pos) {
      /* emulate the sequential boundary chain cut (re-insertion anomaly,
       * smallz4.h:667,676,720) when running stateless on a halo context */
      t.link[p & kMaxDistance] = -1;
      t.add_cut(p, hash_gram(load32(pp)));
      continue;
    }
    if (q0 < 0) continue;  /* gate: no skip bookkeeping without a candidate */
    if (i < 0) continue;   /* lookback seeding only updates tables */
    if (refine_mask && !refine_mask[i]) continue;
    if (skip > 0) {
      skip--;
      if (!lazy_eval) continue;
      lazy_eval = false;
    }
    find_longest(t, buf, buf_zero, min_pos, p, q0, match_limit - p, max_chain,
                 run_start, run_ins_tail, aux_levels, &lens[i], &dists[i],
                 (targets && refine_mask) ? int64_t(targets[i]) : INT64_MAX);
    if ((is_lazy || is_greedy) && lens[i] != 1) {
      lazy_eval = skip == 0;
      skip = lens[i];
    }
  }
  if (!refine_mask) {
    for (; i < bs; i++) {  /* trailing positions are always literals */
      if (i >= 0) { lens[i] = 1; dists[i] = 0; }
    }
  }
}

/* ------------------------------------------------------------------ */
/* optimal parse DP (smallz4.h:376-472)                                */
/* ------------------------------------------------------------------ */

#if defined(__AVX2__)
/* min over cost[lo..hi] (inclusive) and the LAST index attaining it.
 * Exactness note: the reference's ascending-length scan with its '<='
 * acceptance (smallz4.h:431-448) ends on the last length whose cost equals
 * the global minimum, so (min, last-argmin) per extra-byte tier reproduces
 * its decisions bit-for-bit. */
static inline void range_min_last(const uint32_t *c, int64_t lo, int64_t hi,
                                  uint32_t *min_out, int64_t *idx_out) {
  __m256i vmin = _mm256_set1_epi32(-1);
  int64_t j = lo;
  for (; j + 8 <= hi + 1; j += 8)
    vmin = _mm256_min_epu32(vmin,
                            _mm256_loadu_si256((const __m256i *)(c + j)));
  alignas(32) uint32_t tmp[8];
  _mm256_store_si256((__m256i *)tmp, vmin);
  uint32_t m = tmp[0];
  for (int k = 1; k < 8; k++) m = std::min(m, tmp[k]);
  for (; j <= hi; j++) m = std::min(m, c[j]);
  /* last index == m, scanning 8-wide from the top */
  const __m256i vm = _mm256_set1_epi32(int32_t(m));
  int64_t k = hi - 7;
  for (; k >= lo; k -= 8) {
    __m256i eq = _mm256_cmpeq_epi32(
        _mm256_loadu_si256((const __m256i *)(c + k)), vm);
    uint32_t mask = uint32_t(_mm256_movemask_ps(_mm256_castsi256_ps(eq)));
    if (mask) {
      *min_out = m;
      *idx_out = k + (31 - __builtin_clz(mask));
      return;
    }
  }
  for (int64_t e = std::min(hi, k + 7); e >= lo; e--) {
    if (c[e] == m) {
      *min_out = m;
      *idx_out = e;
      return;
    }
  }
  *min_out = m;
  *idx_out = lo; /* unreachable: m occurs in range */
}
#else
static inline void range_min_last(const uint32_t *c, int64_t lo, int64_t hi,
                                  uint32_t *min_out, int64_t *idx_out) {
  uint32_t m = c[lo];
  int64_t idx = lo;
  for (int64_t j = lo + 1; j <= hi; j++) {
    if (c[j] <= m) { m = c[j]; idx = j; }
  }
  *min_out = m;
  *idx_out = idx;
}
#endif

/* Violation-indexed tier queries.
 *
 * The backward cost scan queries "min cost over [i+lo, i+hi], LAST argmin
 * on ties" with tier widths <= 255 (the reference's ascending '<=' scan,
 * smallz4.h:419-456).  Key structural fact: cost[] is *almost always
 * non-increasing backwards* (appending a byte to the span can't usually
 * cheapen it; exceptions arise where a long match starts just left of a
 * match-poor stretch).  Wherever cost[a..b] is non-increasing, the
 * reference's ascending '<=' scan provably ends on the window's right
 * endpoint: every candidate passes the '<=' test, so the last one (len =
 * hi) is kept with m = cost[i+hi].  So instead of a range-min structure
 * we maintain V[j] = the smallest k >= j with cost[k] < cost[k+1] (the
 * next backward-monotonicity violation), updated with one compare per
 * position: V[i] = (cost[i] < cost[i+1]) ? i : V[i+1].  A tier window
 * [i+lo, i+hi] with V[i+lo] >= i+hi is violation-free -> endpoint answer,
 * O(1).  Windows that do contain a violation (measured: a few dozen per
 * 256 KB of text; zero on random data) take the exact AVX scan.  Either
 * way the (min, last-argmin) pair is bit-exact — the certificate only
 * decides which exact method answers the query. */
void estimate_costs(int32_t *lens, const int32_t *dists, int64_t n) {
  /* Scratch is retained per worker thread (bounded by the pool size) and
   * only the <= 7-entry literal tail is re-initialized per block: every
   * other slot is written by the descending scan before any read.
   * viol stores positions as int32 (kNoViol = INT32_MAX sentinel): blocks
   * are capped far below 2^31 (LZ4 blocks are <= 8 MB), assert it. */
  assert(n < INT32_MAX);
  constexpr int32_t kNoViol = INT32_MAX;
  thread_local std::vector<uint32_t> cost_store;
  thread_local std::vector<int32_t> viol_store;
  if (int64_t(cost_store.size()) < n + 1) cost_store.resize(size_t(n) + 1);
  if (int64_t(viol_store.size()) < n + 2) viol_store.resize(size_t(n) + 2);
  uint32_t *cost = cost_store.data();
  int32_t *viol = viol_store.data();
  for (int64_t a = std::max<int64_t>(0, n - kBlockEndLiterals - 1); a <= n;
       a++) {
    cost[a] = 0;        /* the always-literal tail */
    viol[a] = kNoViol;  /* zero cost tail: violation-free */
  }
  viol[n + 1] = kNoViol;
  const int32_t *V = viol;

  int64_t num_lit = kBlockEndLiterals;
  for (int64_t i = n - 1 - kBlockEndLiterals; i >= 0; i--) {
    num_lit++;
    int64_t best_len = 1;
    uint32_t min_cost = cost[i + 1] + 1;
    if (num_lit == 15 ||
        (num_lit >= 15 + 255 && (num_lit - 15) % 255 == 0))
      min_cost++;  /* this literal starts another length-extension byte */
    const int64_t L = lens[i];
    if (L >= kMaxSameLetter && dists[i] == 1) {
      /* long distance-1 runs: take the full match without scanning */
      best_len = L;
      min_cost = cost[i + L] + 4 + uint32_t((L - 19) / 255);
    } else if (L >= kMinMatch) {
      /* tiered scan: extra(len) is 3 for len in [4,18], then +1 per 255
       * (smallz4.h:419-456); within a tier the winner is the min cost with
       * the largest len, across tiers later tiers win '<=' ties — exactly
       * the reference's ascending '<=' scan (see range_min_last note) */
      uint32_t extra = 3; /* token + offset */
      int64_t lo = kMinMatch, tier_hi = 18;
      while (lo <= L) {
        const int64_t hi = std::min(L, tier_hi);
        uint32_t m;
        int64_t idx;
        if (V[i + lo] >= i + hi) { /* window is non-increasing: endpoint */
          m = cost[size_t(i + hi)];
          idx = hi;
        } else {
          range_min_last(cost + i, lo, hi, &m, &idx);
        }
        if (m + extra <= min_cost) {
          min_cost = m + extra;
          best_len = idx;
        }
        lo = tier_hi + 1;
        tier_hi += 255;
        extra++;
      }
    }
    cost[i] = min_cost;
    viol[size_t(i)] = min_cost < cost[size_t(i + 1)] ? int32_t(i) : V[i + 1];
    lens[i] = int32_t(best_len);
    if (best_len != 1) num_lit = 0;
  }
}

/* ------------------------------------------------------------------ */
/* sequence emitter (smallz4.h:259-371)                                */
/* ------------------------------------------------------------------ */

int64_t emit_block(const uint8_t *block, int64_t bs, const int32_t *lens,
                   const int32_t *dists, uint8_t *out, int64_t cap) {
  int64_t op = 0, lit_from = 0, num_lit = 0;
  auto put = [&](uint8_t b) -> bool {
    if (op >= cap) return false;
    out[op++] = b;
    return true;
  };
  auto put_ext = [&](int64_t v) -> bool {  /* 255-chained length bytes */
    while (v >= 255) {
      if (!put(255)) return false;
      v -= 255;
    }
    return put(uint8_t(v));
  };
  for (int64_t off = 0; off < bs;) {
    int64_t mlen = lens[off];
    bool last_token = false;
    if (mlen <= 1) {
      if (num_lit == 0) lit_from = off;
      num_lit++;
      off++;
      if (off < bs) continue;
      last_token = true;
    } else {
      off += mlen;
    }
    int64_t ml_code = last_token ? 0 : mlen - kMinMatch;
    uint8_t token = uint8_t(ml_code < 15 ? ml_code : 15);
    if (num_lit < 15) {
      if (!put(token | uint8_t(num_lit << 4))) return TLZ4_E_CAP;
    } else {
      if (!put(token | 0xF0) || !put_ext(num_lit - 15)) return TLZ4_E_CAP;
    }
    if (num_lit > 0) {
      if (op + num_lit > cap) return TLZ4_E_CAP;
      std::memcpy(out + op, block + lit_from, size_t(num_lit));
      op += num_lit;
      if (last_token) break;
      num_lit = 0;
    }
    int32_t d = dists[off - mlen];
    if (!put(uint8_t(d & 0xFF)) || !put(uint8_t(d >> 8))) return TLZ4_E_CAP;
    if (ml_code >= 15 && !put_ext(ml_code - 15)) return TLZ4_E_CAP;
  }
  return op;
}

/* ------------------------------------------------------------------ */
/* block decode (smallz4cat.c:207-343 semantics, contiguous-output)    */
/* ------------------------------------------------------------------ */

int64_t decode_block(const uint8_t *payload, int64_t n, const uint8_t *hist,
                     int64_t hist_n, uint8_t *out, int64_t cap) {
  int64_t ip = 0, op = 0;
  while (ip < n) {
    const uint8_t token = payload[ip++];
    int64_t num_lit = token >> 4;
    if (num_lit == 15) {
      uint8_t c;
      do {
        if (ip >= n) return TLZ4_E_DATA;
        c = payload[ip++];
        num_lit += c;
      } while (c == 255);
    }
    if (num_lit < 15 && ip + 16 <= n && op + 16 <= cap) {
      /* wild 16-byte copy covers any short literal run; bytes past
       * num_lit are scratch that later writes overwrite */
      std::memcpy(out + op, payload + ip, 16);
      ip += num_lit;
      op += num_lit;
    } else {
      if (ip + num_lit > n) return TLZ4_E_DATA;
      if (op + num_lit > cap) return TLZ4_E_CAP;
      std::memcpy(out + op, payload + ip, size_t(num_lit));
      ip += num_lit;
      op += num_lit;
    }
    if (ip == n) break;  /* final literals-only token */
    if (ip + 2 > n) return TLZ4_E_DATA;
    const int64_t delta = payload[ip] | (int64_t(payload[ip + 1]) << 8);
    ip += 2;
    if (delta == 0) return TLZ4_E_OFFSET;
    int64_t mlen = 4 + (token & 0x0F);
    if (mlen == 19) {
      uint8_t c;
      do {
        if (ip >= n) return TLZ4_E_DATA;
        c = payload[ip++];
        mlen += c;
      } while (c == 255);
    }
    if (op + mlen > cap) return TLZ4_E_CAP;
    int64_t ref = op - delta;
    if (ref >= 0 && delta >= 8 && op + mlen + 16 <= cap) {
      uint8_t *dst = out + op;
      const uint8_t *s = out + ref;
      std::memcpy(dst, s, 8);
      std::memcpy(dst + 8, s + 8, 8);
      for (int64_t k = 16; k < mlen; k += 8) std::memcpy(dst + k, s + k, 8);
      op += mlen;
      continue;
    }
    if (ref < 0) {  /* reach into history / dictionary */
      int64_t hpos = hist_n + ref;
      if (hpos < 0) return TLZ4_E_OFFSET;
      int64_t take = std::min(mlen, -ref);
      std::memcpy(out + op, hist + hpos, size_t(take));
      op += take;
      mlen -= take;
      ref += take;
    }
    if (op - ref >= 8 && op + mlen + 8 <= cap) {
      /* wildcopy: 8-byte strides never read unwritten bytes (src stays
       * >= 8 behind dst) and the slack check keeps stores in bounds */
      uint8_t *dst = out + op;
      const uint8_t *srcp = out + ref;
      for (int64_t k = 0; k < mlen; k += 8) std::memcpy(dst + k, srcp + k, 8);
      op += mlen;
      mlen = 0;
    }
    while (mlen > 0) {  /* overlap => chunked doubling copy (RLE) */
      int64_t take = std::min(mlen, op - ref);
      std::memcpy(out + op, out + ref, size_t(take));
      op += take;
      mlen -= take;
      ref += take;
    }
  }
  return op;
}

/* ------------------------------------------------------------------ */
/* xxHash32 — clean-room from the public spec; validated against the    */
/* reference's precomputed header byte (0xDF for descriptor 40 70) and  */
/* the published vectors.                                               */
/* ------------------------------------------------------------------ */

constexpr uint32_t kXP1 = 2654435761u, kXP2 = 2246822519u,
                   kXP3 = 3266489917u, kXP4 = 668265263u, kXP5 = 374761393u;

inline uint32_t xrotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }
inline uint32_t xround(uint32_t acc, uint32_t lane) {
  return xrotl(acc + lane * kXP2, 13) * kXP1;
}

struct Xxh32 {
  uint32_t a1, a2, a3, a4;
  uint8_t buf[16];
  size_t buffered = 0;
  uint64_t total = 0;
  uint32_t seed;

  explicit Xxh32(uint32_t s = 0) : seed(s) { reset(); }
  void reset() {
    a1 = seed + kXP1 + kXP2; a2 = seed + kXP2; a3 = seed; a4 = seed - kXP1;
    buffered = 0; total = 0;
  }
  void update(const uint8_t *p, size_t n) {
    total += n;
    if (buffered) {
      size_t take = std::min(n, sizeof(buf) - buffered);
      std::memcpy(buf + buffered, p, take);
      buffered += take; p += take; n -= take;
      if (buffered < sizeof(buf)) return;
      a1 = xround(a1, load32(buf)); a2 = xround(a2, load32(buf + 4));
      a3 = xround(a3, load32(buf + 8)); a4 = xround(a4, load32(buf + 12));
      buffered = 0;
    }
    while (n >= 16) {
      a1 = xround(a1, load32(p)); a2 = xround(a2, load32(p + 4));
      a3 = xround(a3, load32(p + 8)); a4 = xround(a4, load32(p + 12));
      p += 16; n -= 16;
    }
    if (n) { std::memcpy(buf, p, n); buffered = n; }
  }
  uint32_t digest() const {
    uint32_t acc;
    if (total >= 16)
      acc = xrotl(a1, 1) + xrotl(a2, 7) + xrotl(a3, 12) + xrotl(a4, 18);
    else
      acc = seed + kXP5;
    acc += uint32_t(total);
    const uint8_t *p = buf;
    size_t n = buffered;
    while (n >= 4) { acc = xrotl(acc + load32(p) * kXP3, 17) * kXP4; p += 4; n -= 4; }
    while (n) { acc = xrotl(acc + *p * kXP5, 11) * kXP1; p++; n--; }
    acc ^= acc >> 15; acc *= kXP2;
    acc ^= acc >> 13; acc *= kXP3;
    acc ^= acc >> 16;
    return acc;
  }
};

inline uint32_t xxh32(const uint8_t *p, size_t n, uint32_t seed = 0) {
  Xxh32 h(seed);
  h.update(p, n);
  return h.digest();
}

constexpr uint8_t kMagicModern[4] = {0x04, 0x22, 0x4D, 0x18};
constexpr uint8_t kMagicLegacy[4] = {0x02, 0x21, 0x4C, 0x18};
/* FLG 0x40 (v1, dependent blocks, no checksums) + BD 0x70 (4 MB) + the
 * precomputed xxhash header byte (smallz4.h:486-495) */
constexpr uint8_t kModernHeader[7] = {0x04, 0x22, 0x4D, 0x18, 0x40, 0x70, 0xDF};

}  // namespace

/* ================================================================== */
/* streaming encoder                                                   */
/* ================================================================== */

struct tlz4_enc {
  int level = 9;
  bool legacy = false;
  int64_t block_size = kMaxBlock;
  int64_t dict_len = 0;

  std::vector<uint8_t> buf;  /* virtual-stream window: [buf_zero, ...) */
  int64_t buf_zero = 0;      /* abs position of buf[0] */
  int64_t appended = 0;      /* abs position after last appended byte */
  int64_t next_block = 0;    /* abs position of the next block start */
  int64_t data_zero = 0;     /* reference dataZero (lookback control) */
  bool header_sent = false;
  bool first_block = true;
  bool finished = false;

  bool content_checksum = false;
  bool block_checksum = false;
  Xxh32 content_hash;

  MatchTables tables;
  std::vector<int32_t> lens, dists;
};

tlz4_enc *tlz4_enc_new(int level, int legacy, const uint8_t *dict,
                       int64_t dict_n, int64_t block_size) {
  return tlz4_enc_new2(level, legacy, dict, dict_n, block_size, 0);
}

tlz4_enc *tlz4_enc_new2(int level, int legacy, const uint8_t *dict,
                        int64_t dict_n, int64_t block_size, int flags) {
  if (level < 0 || level > 9) return nullptr;
  if (legacy && (dict_n > 0 || level == 0)) return nullptr;
  if (legacy && flags) return nullptr;  /* legacy has no checksums */
  auto *e = new tlz4_enc();
  e->content_checksum = flags & TLZ4_F_CONTENT_CHECKSUM;
  e->block_checksum = flags & TLZ4_F_BLOCK_CHECKSUM;
  e->level = level;
  e->legacy = legacy != 0;
  e->block_size = block_size > 0 ? block_size
                                 : (legacy ? kMaxBlockLegacy : kMaxBlock);
  if (dict && dict_n > 0) {
    int64_t take = std::min<int64_t>(dict_n, kMaxDistance);
    e->buf.assign(dict + dict_n - take, dict + dict_n);
    e->dict_len = take;
  }
  e->appended = e->next_block = e->dict_len;
  return e;
}

void tlz4_enc_free(tlz4_enc *e) { delete e; }

int64_t tlz4_enc_bound(const tlz4_enc *e, int64_t n) {
  if (!e) return TLZ4_E_ARG;
  int64_t pending = (e->appended - e->next_block) + std::max<int64_t>(n, 0);
  int64_t blocks = pending / e->block_size + 2;
  /* per block: size word (4) + the emit-pause slack (64, see
   * tlz4_enc_write) + extension-byte worst case; plus header + end mark */
  return pending + pending / 255 + blocks * 96 + 32;
}

static int64_t enc_emit_block(tlz4_enc *e, int64_t block_end, uint8_t *out,
                              int64_t cap) {
  const int64_t base = e->next_block;
  const int64_t bs = block_end - base;
  const uint8_t *block = e->buf.data() + (base - e->buf_zero);
  int64_t op = 0;

  bool stored = e->level == 0;
  int64_t payload_n = bs;
  if (!stored) {
    e->lens.resize(size_t(bs));
    e->dists.resize(size_t(bs));
    int64_t lookback;
    if (e->legacy) {
      e->tables.reset();
      lookback = 0;
    } else if (e->first_block) {
      lookback = e->dict_len;  /* seed the whole dictionary (spec mode) */
    } else {
      lookback = std::min<int64_t>(e->data_zero, kBlockEndNoMatch);
    }
    int64_t min_pos = e->legacy ? base : e->buf_zero;
    match_block(e->tables, e->buf.data(), e->buf_zero, min_pos, base, bs,
                e->level, lookback,
                /*buf_end=*/e->buf_zero + int64_t(e->buf.size()),
                e->lens.data(), e->dists.data());
    if (bs > kBlockEndNoMatch && max_chain_of_level(e->level) > kGreedyLevels)
      estimate_costs(e->lens.data(), e->dists.data(), bs);
    int64_t comp = emit_block(block, bs, e->lens.data(), e->dists.data(),
                              out + op + 4, cap - op - 4);
    if (comp == TLZ4_E_CAP) return TLZ4_E_CAP;
    if (comp < 0) return comp;
    if (comp < bs || e->legacy) {
      payload_n = comp;
    } else {
      stored = true;  /* compression did harm (smallz4.h:765-771) */
    }
  }
  if (op + 4 + payload_n > cap) return TLZ4_E_CAP;
  uint32_t tag = uint32_t(payload_n) |
                 ((stored && !e->legacy) ? 0x80000000u : 0u);
  store32(out + op, tag);
  op += 4;
  if (stored) std::memcpy(out + op, block, size_t(payload_n));
  /* compressed payload was already written in place after the size word */
  op += payload_n;
  if (e->block_checksum) {
    if (op + 4 > cap) return TLZ4_E_CAP;
    store32(out + op, xxh32(out + op - payload_n, size_t(payload_n)));
    op += 4;
  }

  e->next_block = block_end;
  e->first_block = false;
  if (!e->legacy)
    e->data_zero = std::max<int64_t>(e->data_zero, block_end - kMaxDistance);
  /* trim retained context (legacy keeps nothing across blocks) */
  int64_t keep_from = e->legacy ? block_end : std::max<int64_t>(e->buf_zero, block_end - kMaxDistance);
  if (keep_from > e->buf_zero) {
    e->buf.erase(e->buf.begin(), e->buf.begin() + (keep_from - e->buf_zero));
    e->buf_zero = keep_from;
  }
  return op;
}

int64_t tlz4_enc_write(tlz4_enc *e, const uint8_t *in, int64_t n, int final,
                       uint8_t *out, int64_t out_cap) {
  if (!e || n < 0 || (n > 0 && !in) || e->finished) return TLZ4_E_ARG;
  int64_t op = 0;
  if (!e->header_sent) {
    int64_t hn = e->legacy ? 4 : 7;
    if (out_cap < hn) return TLZ4_E_CAP;
    if (e->legacy) {
      std::memcpy(out, kMagicLegacy, 4);
    } else if (!e->content_checksum && !e->block_checksum) {
      std::memcpy(out, kModernHeader, 7);
    } else {
      std::memcpy(out, kMagicModern, 4);
      uint8_t flg = uint8_t(0x40 | (e->block_checksum ? 0x10 : 0) |
                            (e->content_checksum ? 0x04 : 0));
      uint8_t descriptor[2] = {flg, 0x70};
      out[4] = flg;
      out[5] = 0x70;
      out[6] = uint8_t(xxh32(descriptor, 2) >> 8);
    }
    op += hn;
    e->header_sent = true;
  }
  if (e->content_checksum && n > 0) e->content_hash.update(in, size_t(n));
  if (n > 0) {
    e->buf.insert(e->buf.end(), in, in + n);
    e->appended += n;
  }
  while (e->appended - e->next_block >= e->block_size ||
         (final && e->appended > e->next_block)) {
    int64_t block_end =
        std::min(e->appended, e->next_block + e->block_size);
    int64_t bs = block_end - e->next_block;
    /* legacy framing has no per-block size field: a block that decodes to
     * less than 8 MB ends the stream (smallz4cat.c:325-327).  Emitting a
     * short NON-final block (only possible with a custom block_size)
     * would make every later block unreachable — refuse instead. */
    if (e->legacy && bs < kMaxBlockLegacy &&
        !(final && block_end == e->appended))
      return TLZ4_E_ARG;
    /* pause (not error) when the next block couldn't fit: the caller
     * retries with n=0; encoder state is only mutated on emitted blocks */
    if (out_cap - op < 4 + bs + bs / 255 + 64) {
      if (op > 0) return op;
      return TLZ4_E_CAP;
    }
    int64_t r = enc_emit_block(e, block_end, out + op, out_cap - op);
    if (r < 0) return r;
    op += r;
  }
  if (final && e->appended == e->next_block) {
    if (!e->legacy) {
      if (op + 4 > out_cap) {
        if (op > 0) return op;  /* end mark on the next call */
        return TLZ4_E_CAP;
      }
      store32(out + op, 0);  /* end mark */
      op += 4;
      if (e->content_checksum) {
        if (op + 4 > out_cap) return TLZ4_E_CAP;
        store32(out + op, e->content_hash.digest());
        op += 4;
      }
    }
    e->finished = true;
  }
  return op;
}

/* ================================================================== */
/* streaming decoder                                                   */
/* ================================================================== */

struct tlz4_dec {
  std::vector<uint8_t> in;      /* unconsumed compressed bytes */
  std::vector<uint8_t> hist;    /* up to 64 Ki of history (dict-primed) */
  enum { HDR, SKIP, BLOCKS, CKSUM, DONE } phase = HDR;
  bool legacy = false;
  bool block_checksum = false, content_checksum = false;
  bool verify = false;          /* check checksums instead of skipping */
  Xxh32 content_hash;
  int64_t skip_remaining = 0;   /* bytes left of a skippable frame */
};

tlz4_dec *tlz4_dec_new(const uint8_t *dict, int64_t dict_n) {
  return tlz4_dec_new2(dict, dict_n, 0);
}

tlz4_dec *tlz4_dec_new2(const uint8_t *dict, int64_t dict_n, int verify) {
  auto *d = new tlz4_dec();
  d->verify = verify != 0;
  if (dict && dict_n > 0) {
    int64_t take = std::min<int64_t>(dict_n, 65536);
    d->hist.assign(dict + dict_n - take, dict + dict_n);
  }
  return d;
}

void tlz4_dec_free(tlz4_dec *d) { delete d; }

static void dec_push_history(tlz4_dec *d, const uint8_t *data, int64_t n) {
  if (n >= 65536) {
    d->hist.assign(data + n - 65536, data + n);
    return;
  }
  d->hist.insert(d->hist.end(), data, data + n);
  if (int64_t(d->hist.size()) > 65536)
    d->hist.erase(d->hist.begin(), d->hist.end() - 65536);
}

int64_t tlz4_dec_write(tlz4_dec *d, const uint8_t *in, int64_t n, int final,
                       uint8_t *out, int64_t out_cap, int *done) {
  if (!d || n < 0 || (n > 0 && !in) || !done) return TLZ4_E_ARG;
  *done = d->phase == tlz4_dec::DONE;
  if (d->phase == tlz4_dec::DONE) return 0;
  if (n > 0) d->in.insert(d->in.end(), in, in + n);
  int64_t op = 0;
  size_t ip = 0;
  const std::vector<uint8_t> &b = d->in;

  if (d->phase == tlz4_dec::SKIP) {
    int64_t take = std::min<int64_t>(d->skip_remaining, int64_t(b.size()));
    ip += size_t(take);
    d->skip_remaining -= take;
    if (d->skip_remaining > 0) {
      if (final) return TLZ4_E_DATA;
      d->in.erase(d->in.begin(), d->in.begin() + ip);
      return 0;
    }
    d->phase = tlz4_dec::HDR;
  }
  if (d->phase == tlz4_dec::HDR) {
    /* skippable frames (LZ4 spec 0x184D2A50..5F + u32 size): skipped —
     * a capability superset of the reference (smallz4cat.c:29-30) */
    while (b.size() - ip >= 8) {
      uint32_t magic = load32(b.data() + ip);
      if ((magic & 0xFFFFFFF0u) != 0x184D2A50u) break;
      int64_t sk = load32(b.data() + ip + 4);
      ip += 8;
      int64_t take = std::min<int64_t>(sk, int64_t(b.size() - ip));
      ip += size_t(take);
      if (take < sk) {
        d->skip_remaining = sk - take;
        d->phase = tlz4_dec::SKIP;
        if (final) return TLZ4_E_DATA;
        d->in.erase(d->in.begin(), d->in.begin() + ip);
        return 0;
      }
    }
    if (b.size() - ip < 4) {
      if (final) return TLZ4_E_DATA;
      d->in.erase(d->in.begin(), d->in.begin() + ip);
      return 0;
    }
    if ((load32(b.data() + ip) & 0xFFFFFFF0u) == 0x184D2A50u) {
      /* skippable magic but its size word hasn't arrived yet */
      if (final) return TLZ4_E_DATA;
      d->in.erase(d->in.begin(), d->in.begin() + ip);
      return 0;
    }
    if (!std::memcmp(b.data() + ip, kMagicLegacy, 4)) {
      d->legacy = true;
      ip += 4;
    } else if (!std::memcmp(b.data() + ip, kMagicModern, 4)) {
      if (b.size() - ip < 7) {
        if (final) return TLZ4_E_DATA;
        d->in.erase(d->in.begin(), d->in.begin() + ip);
        return 0;
      }
      uint8_t flags = b[ip + 4];
      if ((flags >> 6) != 1) return TLZ4_E_VERSION;
      d->block_checksum = flags & 16;
      d->content_checksum = flags & 4;
      size_t hdr = 7;
      if (flags & 8) hdr += 8;   /* content size: skipped */
      if (flags & 1) hdr += 4;   /* dictionary id: skipped */
      if (b.size() - ip < hdr) {
        if (final) return TLZ4_E_DATA;
        d->in.erase(d->in.begin(), d->in.begin() + ip);
        return 0;
      }
      ip += hdr;
    } else {
      return TLZ4_E_MAGIC;
    }
    d->phase = tlz4_dec::BLOCKS;
  }

  while (d->phase == tlz4_dec::BLOCKS) {
    if (b.size() - ip < 4) {
      if (final) {
        if (d->legacy) d->phase = tlz4_dec::DONE;  /* legacy: EOF ends */
        else return TLZ4_E_DATA;
      }
      break;
    }
    uint32_t raw = load32(b.data() + ip);
    bool is_compressed = d->legacy || !(raw & 0x80000000u);
    int64_t size = d->legacy ? raw : (raw & 0x7FFFFFFFu);
    if (size == 0) {
      ip += 4;
      d->phase = tlz4_dec::DONE;
      break;
    }
    int64_t need = 4 + size + (d->block_checksum ? 4 : 0);
    if (int64_t(b.size() - ip) < need) {
      if (final) return TLZ4_E_DATA;
      break;
    }
    const uint8_t *payload = b.data() + ip + 4;
    int64_t produced;
    if (is_compressed) {
      produced = decode_block(payload, size, d->hist.data(),
                              int64_t(d->hist.size()), out + op, out_cap - op);
      if (produced == TLZ4_E_CAP && op > 0) break;  /* pause; resume next call */
      if (produced < 0) return produced;
    } else {
      if (op + size > out_cap) {
        if (op > 0) break;  /* pause */
        return TLZ4_E_CAP;
      }
      std::memcpy(out + op, payload, size_t(size));
      produced = size;
    }
    if (d->block_checksum && d->verify) {
      uint32_t want = load32(payload + size);
      if (xxh32(payload, size_t(size)) != want) return TLZ4_E_CHECKSUM;
    }
    if (d->content_checksum && d->verify)
      d->content_hash.update(out + op, size_t(produced));
    dec_push_history(d, out + op, produced);
    op += produced;
    ip += need;
    if (d->legacy && is_compressed && produced < kMaxBlockLegacy) {
      d->phase = tlz4_dec::DONE;  /* non-full legacy block ends the stream */
      break;
    }
  }
  if (d->phase == tlz4_dec::DONE && d->content_checksum) {
    /* skipped by default (smallz4cat.c:352-356); verified on request */
    if (b.size() - ip >= 4) {
      if (d->verify && d->content_hash.digest() != load32(b.data() + ip))
        return TLZ4_E_CHECKSUM;
      ip += 4;
      d->content_checksum = false;  /* consumed */
    } else if (d->verify) {
      if (final) return TLZ4_E_DATA;
      d->phase = tlz4_dec::CKSUM;  /* await the checksum bytes */
    }
  }
  if (d->phase == tlz4_dec::CKSUM && b.size() - ip >= 4) {
    if (d->verify && d->content_hash.digest() != load32(b.data() + ip))
      return TLZ4_E_CHECKSUM;
    ip += 4;
    d->content_checksum = false;
    d->phase = tlz4_dec::DONE;
  } else if (d->phase == tlz4_dec::CKSUM && final) {
    return TLZ4_E_DATA;
  }
  d->in.erase(d->in.begin(), d->in.begin() + ip);
  *done = d->phase == tlz4_dec::DONE;
  return op;
}

/* ================================================================== */
/* constant-memory ring decoder                                        */
/*                                                                     */
/* The reference decoder streams any frame through a 64 KB ring plus a */
/* 4 KB read buffer (smallz4cat.c:73,162-166) — O(64 KB) memory for    */
/* arbitrarily large streams.  tlz4_rdec reproduces that profile as a  */
/* byte-resumable state machine: it retains NO input (a <=16-byte      */
/* stash for split multi-byte fields only) and reports how much of the */
/* caller's chunk it consumed, pausing whenever the output buffer      */
/* fills.  Decode semantics match smallz4cat.c:112-360 exactly         */
/* (token/length chains, ring-wrapped match copies with RLE overlap,   */
/* stored blocks streamed through the ring, dict at the ring tail,     */
/* legacy non-full-block termination).                                 */
/* ================================================================== */

struct tlz4_rdec {
  enum State {
    S_MAGIC, S_SKIP_SIZE, S_SKIP_DATA, S_FLG, S_HDR_REST,
    S_BLK_SIZE, S_STORED, S_TOKEN, S_LITLEN, S_LITERALS, S_OFFSET,
    S_MATLEN, S_MATCH, S_BLK_CKSUM, S_CONTENT_CKSUM, S_DONE,
  };
  static constexpr int64_t kRing = 65536;
  uint8_t ring[kRing];
  State state = S_MAGIC;
  uint8_t stash[16];
  int hdr_rest = 0;             /* bytes left of the skipped header tail */
  int stash_n = 0;
  bool legacy = false, block_checksum = false, content_checksum = false;
  bool verify = false;
  bool stored = false;          /* current block is uncompressed */
  int64_t skip_remaining = 0;   /* skippable-frame payload left */
  int64_t blk_remaining = 0;    /* compressed payload bytes left in block */
  int64_t blk_produced = 0;     /* decoded bytes of the current block */
  int64_t lit_remaining = 0;
  int64_t match_remaining = 0;
  int64_t delta = 0;
  uint8_t token = 0;
  int64_t pos = 0;              /* ring write cursor (mod kRing) */
  int64_t produced = 0;         /* total decoded bytes */
  int64_t hist_avail = 0;       /* dictionary bytes preloaded at ring tail */
  Xxh32 content_hash;
  Xxh32 block_hash;
};

tlz4_rdec *tlz4_rdec_new(const uint8_t *dict, int64_t dict_n, int verify) {
  auto *d = new tlz4_rdec();
  d->verify = verify != 0;
  std::memset(d->ring, 0, sizeof(d->ring));
  if (dict && dict_n > 0) {
    /* last <=64 KB of the dictionary lands at the *end* of the ring so
     * wrap-around offsets resolve into it (smallz4cat.c:169-187) */
    int64_t take = std::min<int64_t>(dict_n, tlz4_rdec::kRing);
    std::memcpy(d->ring + tlz4_rdec::kRing - take, dict + dict_n - take,
                size_t(take));
    d->hist_avail = take;
  }
  return d;
}

void tlz4_rdec_free(tlz4_rdec *d) { delete d; }

/* Pull up to `want` bytes into the stash; true once it holds `want`. */
static bool rdec_fill(tlz4_rdec *d, const uint8_t *in, int64_t n, int64_t &ip,
                      int want) {
  int64_t take = std::min<int64_t>(want - d->stash_n, n - ip);
  std::memcpy(d->stash + d->stash_n, in + ip, size_t(take));
  d->stash_n += int(take);
  ip += take;
  return d->stash_n == want;
}

int64_t tlz4_rdec_write(tlz4_rdec *d, const uint8_t *in, int64_t n, int final,
                        uint8_t *out, int64_t out_cap, int64_t *consumed,
                        int *done) {
  if (!d || n < 0 || (n > 0 && !in) || !consumed || !done || out_cap < 0)
    return TLZ4_E_ARG;
  using R = tlz4_rdec;
  int64_t ip = 0, op = 0;
  const int64_t kRing = R::kRing;

  /* Emit `take` freshly decoded ring bytes [pos, pos+take) to out and all
   * running hashes; the caller guarantees take <= out space & ring wrap. */
  auto emit = [&](int64_t take) {
    if (d->content_checksum && d->verify)
      d->content_hash.update(d->ring + d->pos, size_t(take));
    std::memcpy(out + op, d->ring + d->pos, size_t(take));
    op += take;
    d->pos = (d->pos + take) & (kRing - 1);
    d->produced += take;
    d->blk_produced += take;
  };
  auto blk_consume = [&](const uint8_t *p, int64_t take) {
    if (d->block_checksum && d->verify) d->block_hash.update(p, size_t(take));
    d->blk_remaining -= take;
  };

  for (;;) {
    switch (d->state) {
    case R::S_MAGIC: {
      if (!rdec_fill(d, in, n, ip, 4)) goto out_of_input;
      uint32_t magic = load32(d->stash);
      d->stash_n = 0;
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        d->state = R::S_SKIP_SIZE;
      } else if (!std::memcmp(d->stash, kMagicLegacy, 4)) {
        d->legacy = true;
        d->state = R::S_BLK_SIZE;
      } else if (!std::memcmp(d->stash, kMagicModern, 4)) {
        d->state = R::S_FLG;
      } else {
        return TLZ4_E_MAGIC;
      }
      break;
    }
    case R::S_SKIP_SIZE:
      if (!rdec_fill(d, in, n, ip, 4)) goto out_of_input;
      d->skip_remaining = load32(d->stash);
      d->stash_n = 0;
      d->state = R::S_SKIP_DATA;
      break;
    case R::S_SKIP_DATA: {
      int64_t take = std::min(d->skip_remaining, n - ip);
      ip += take;
      d->skip_remaining -= take;
      if (d->skip_remaining > 0) goto out_of_input;
      d->state = R::S_MAGIC;
      break;
    }
    case R::S_FLG: {
      if (!rdec_fill(d, in, n, ip, 1)) goto out_of_input;
      uint8_t flags = d->stash[0];
      d->stash_n = 0;
      if ((flags >> 6) != 1) return TLZ4_E_VERSION;
      d->block_checksum = flags & 16;
      d->content_checksum = flags & 4;
      /* BD byte + optional content size + dict id + header checksum:
       * all skipped, like smallz4cat.c:143-158 */
      d->hdr_rest = 2 + ((flags & 8) ? 8 : 0) + ((flags & 1) ? 4 : 0);
      d->state = R::S_HDR_REST;
      break;
    }
    case R::S_HDR_REST: {
      int64_t take = std::min<int64_t>(d->hdr_rest, n - ip);
      ip += take;
      d->hdr_rest -= int(take);
      if (d->hdr_rest > 0) goto out_of_input;
      d->state = R::S_BLK_SIZE;
      break;
    }
    case R::S_BLK_SIZE: {
      if (n - ip == 0 && final && d->legacy && d->stash_n == 0) {
        d->state = R::S_DONE;  /* legacy: EOF ends the stream */
        break;
      }
      if (!rdec_fill(d, in, n, ip, 4)) goto out_of_input;
      uint32_t raw = load32(d->stash);
      d->stash_n = 0;
      d->stored = !d->legacy && (raw & 0x80000000u);
      d->blk_remaining = d->legacy ? raw : (raw & 0x7FFFFFFFu);
      d->blk_produced = 0;
      d->block_hash = Xxh32();
      if (d->blk_remaining == 0) {
        d->state = d->content_checksum ? R::S_CONTENT_CKSUM : R::S_DONE;
        break;
      }
      d->state = d->stored ? R::S_STORED : R::S_TOKEN;
      break;
    }
    case R::S_STORED: {
      int64_t take = std::min(d->blk_remaining, n - ip);
      take = std::min(take, out_cap - op);
      take = std::min(take, kRing - d->pos);
      if (take == 0) {
        if (op >= out_cap) goto out_of_output;
        goto out_of_input;
      }
      std::memcpy(d->ring + d->pos, in + ip, size_t(take));
      blk_consume(in + ip, take);
      ip += take;
      emit(take);
      if (d->blk_remaining == 0)
        d->state = d->block_checksum ? R::S_BLK_CKSUM : R::S_BLK_SIZE;
      break;
    }
    case R::S_TOKEN:
      if (n - ip == 0) goto out_of_input;
      d->token = in[ip];
      blk_consume(in + ip, 1);
      ip++;
      d->lit_remaining = d->token >> 4;
      d->state = (d->lit_remaining == 15) ? R::S_LITLEN : R::S_LITERALS;
      break;
    case R::S_LITLEN: {
      uint8_t c;
      do {
        if (n - ip == 0) goto out_of_input;
        if (d->blk_remaining == 0) return TLZ4_E_DATA;
        c = in[ip];
        blk_consume(in + ip, 1);
        ip++;
        d->lit_remaining += c;
      } while (c == 255);
      d->state = R::S_LITERALS;
      break;
    }
    case R::S_LITERALS: {
      if (d->lit_remaining > d->blk_remaining) return TLZ4_E_DATA;
      while (d->lit_remaining > 0) {
        int64_t take = std::min(d->lit_remaining, n - ip);
        take = std::min(take, out_cap - op);
        take = std::min(take, kRing - d->pos);
        if (take == 0) {
          if (op >= out_cap) goto out_of_output;
          goto out_of_input;
        }
        std::memcpy(d->ring + d->pos, in + ip, size_t(take));
        blk_consume(in + ip, take);
        ip += take;
        emit(take);
        d->lit_remaining -= take;
      }
      if (d->blk_remaining == 0) {
        /* final literals-only token (smallz4cat.c:258) */
        d->state = d->block_checksum ? R::S_BLK_CKSUM : R::S_BLK_SIZE;
        /* legacy: a non-full block ends the stream (smallz4cat.c:325-327) */
        if (d->legacy && d->blk_produced < kMaxBlockLegacy)
          d->state = R::S_DONE;
        break;
      }
      d->state = R::S_OFFSET;
      break;
    }
    case R::S_OFFSET: {
      if (d->blk_remaining < 2) return TLZ4_E_DATA;
      if (!rdec_fill(d, in, n, ip, 2)) goto out_of_input;
      blk_consume(d->stash, 2);
      d->delta = d->stash[0] | (int64_t(d->stash[1]) << 8);
      d->stash_n = 0;
      if (d->delta == 0) return TLZ4_E_OFFSET;
      if (d->delta > d->produced + d->hist_avail) return TLZ4_E_OFFSET;
      d->match_remaining = 4 + (d->token & 0x0F);
      d->state = (d->match_remaining == 19) ? R::S_MATLEN : R::S_MATCH;
      break;
    }
    case R::S_MATLEN: {
      uint8_t c;
      do {
        if (n - ip == 0) goto out_of_input;
        if (d->blk_remaining == 0) return TLZ4_E_DATA;
        c = in[ip];
        blk_consume(in + ip, 1);
        ip++;
        d->match_remaining += c;
      } while (c == 255);
      d->state = R::S_MATCH;
      break;
    }
    case R::S_MATCH: {
      while (d->match_remaining > 0) {
        if (op >= out_cap) goto out_of_output;
        int64_t rd = (d->pos - d->delta) & (kRing - 1);
        int64_t take = std::min(d->match_remaining, out_cap - op);
        take = std::min(take, kRing - d->pos);
        take = std::min(take, kRing - rd);
        if (d->delta >= 8 && d->delta >= take) {
          /* ranges can still overlap when the read wraps (rd > pos and
           * take > kRing - delta): memmove's as-if-temp semantics are
           * correct — every source byte predates the match — while
           * memcpy would be UB there */
          std::memmove(d->ring + d->pos, d->ring + rd, size_t(take));
        } else {
          take = std::min(take, d->delta);  /* overlap: RLE chunking */
          std::memmove(d->ring + d->pos, d->ring + rd, size_t(take));
        }
        emit(take);
        d->match_remaining -= take;
      }
      if (d->blk_remaining == 0) {
        d->state = d->block_checksum ? R::S_BLK_CKSUM : R::S_BLK_SIZE;
        if (d->legacy && d->blk_produced < kMaxBlockLegacy)
          d->state = R::S_DONE;
      } else {
        d->state = R::S_TOKEN;
      }
      break;
    }
    case R::S_BLK_CKSUM:
      if (!rdec_fill(d, in, n, ip, 4)) goto out_of_input;
      if (d->verify && d->block_hash.digest() != load32(d->stash))
        return TLZ4_E_CHECKSUM;
      d->stash_n = 0;
      d->state = R::S_BLK_SIZE;  /* legacy frames never carry checksums */
      break;
    case R::S_CONTENT_CKSUM:
      if (!rdec_fill(d, in, n, ip, 4)) {
        if (final) return TLZ4_E_DATA;
        goto out_of_input;
      }
      if (d->verify && d->content_hash.digest() != load32(d->stash))
        return TLZ4_E_CHECKSUM;
      d->stash_n = 0;
      d->state = R::S_DONE;
      break;
    case R::S_DONE:
      *consumed = ip;
      *done = 1;
      return op;
    }
    continue;
  out_of_input:
    if (final && d->state != R::S_DONE) {
      if (d->legacy && d->state == R::S_BLK_SIZE && d->stash_n == 0) {
        d->state = R::S_DONE;
        continue;
      }
      return TLZ4_E_DATA;
    }
    *consumed = ip;
    *done = 0;
    return op;
  out_of_output:
    *consumed = ip;
    *done = 0;
    return op;
  }
}

/* ================================================================== */
/* one-shot helpers                                                    */
/* ================================================================== */

int64_t tlz4_compress_bound(int64_t n) {
  /* must dominate tlz4_enc_bound for a single final write */
  return n + n / 255 + (n / kMaxBlock + 2) * 96 + 64;
}

int64_t tlz4_compress(const uint8_t *src, int64_t n, uint8_t *dst, int64_t cap,
                      int level, int legacy, const uint8_t *dict,
                      int64_t dict_n, int64_t block_size) {
  std::unique_ptr<tlz4_enc, void (*)(tlz4_enc *)> e(
      tlz4_enc_new(level, legacy, dict, dict_n, block_size), tlz4_enc_free);
  if (!e) return TLZ4_E_ARG;
  int64_t r = tlz4_enc_write(e.get(), src, n, 1, dst, cap);
  if (r >= 0 && !e->finished) return TLZ4_E_CAP;  /* paused: cap too small */
  return r;
}

int64_t tlz4_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                        int64_t cap, const uint8_t *dict, int64_t dict_n) {
  std::unique_ptr<tlz4_dec, void (*)(tlz4_dec *)> d(
      tlz4_dec_new(dict, dict_n), tlz4_dec_free);
  if (!d) return TLZ4_E_ARG;
  int done = 0;
  int64_t total = tlz4_dec_write(d.get(), src, n, 1, dst, cap, &done);
  if (total < 0) return total;
  while (!done) {
    /* a paused decoder (output cap reached mid-stream) resumes on
     * zero-length writes; no progress while undone means truncated input */
    int64_t r = tlz4_dec_write(d.get(), nullptr, 0, 1, dst + total,
                               cap - total, &done);
    if (r < 0) return r; /* E_CAP when out of output room */
    if (r == 0 && !done) return TLZ4_E_DATA;
    total += r;
  }
  return total;
}

/* ================================================================== */
/* block-level entry points (device hybrid path)                        */
/* ================================================================== */

int64_t tlz4_match_block(const uint8_t *buf, int64_t buf_n, int64_t base,
                         int64_t bs, int level, int64_t lookback,
                         int32_t *out_len, int32_t *out_dist) {
  return tlz4_match_block_ex(buf, buf_n, base, bs, level, lookback, -1,
                             out_len, out_dist);
}

/* Stateless block entries reuse one thread-local table set: each call maps
 * its buffer at a fresh position base > previous + window, so every stale
 * entry fails the walk's distance/min_pos checks — semantically identical
 * to fresh tables with zero reset cost (the tables are ~90 MB). */
struct SessionTables {
  MatchTables tables;
  int64_t next_base = 0;
  int64_t map(int64_t buf_n) {
    int64_t zero = next_base;
    next_base += buf_n + kMaxDistance + 1;
    return zero;
  }
};
SessionTables &session_tables() {
  thread_local SessionTables s;
  return s;
}

int64_t tlz4_match_block_ex(const uint8_t *buf, int64_t buf_n, int64_t base,
                            int64_t bs, int level, int64_t lookback,
                            int64_t cut_pos, int32_t *out_len,
                            int32_t *out_dist) {
  if (!buf || base < 0 || bs < 0 || base + bs > buf_n || lookback > base ||
      level < 1 || level > 9)
    return TLZ4_E_ARG;
  SessionTables &s = session_tables();
  int64_t zero = s.map(buf_n);
  match_block(s.tables, buf, /*buf_zero=*/zero, /*min_pos=*/zero, zero + base,
              bs, level, lookback, /*buf_end=*/zero + buf_n, out_len,
              out_dist, nullptr, cut_pos >= 0 ? zero + cut_pos : -1);
  return 0;
}

int64_t tlz4_match_block_ex2(const uint8_t *buf, int64_t buf_n, int64_t base,
                             int64_t bs, int level, int64_t lookback,
                             int64_t cut_pos, int64_t block_end,
                             int32_t *out_len, int32_t *out_dist) {
  /* Chunk-of-a-block search: positions [base, base+bs) with the enclosing
   * block ending at block_end (>= base+bs, <= buf_n).  Levels 7-9 only —
   * greedy/lazy skip bookkeeping makes per-position results order-
   * dependent, so those levels cannot be chunked bit-exactly. */
  if (!buf || base < 0 || bs < 0 || base + bs > buf_n || lookback > base ||
      level < 7 || level > 9 || block_end < base + bs || block_end > buf_n)
    return TLZ4_E_ARG;
  SessionTables &s = session_tables();
  int64_t zero = s.map(buf_n);
  match_block(s.tables, buf, /*buf_zero=*/zero, /*min_pos=*/zero, zero + base,
              bs, level, lookback, /*buf_end=*/zero + buf_n, out_len,
              out_dist, nullptr, cut_pos >= 0 ? zero + cut_pos : -1,
              zero + block_end);
  return 0;
}

int64_t tlz4_match_refine(const uint8_t *buf, int64_t buf_n, int64_t base,
                          int64_t bs, int64_t lookback, int64_t cut_pos,
                          const uint8_t *mask, int32_t *out_len,
                          int32_t *out_dist) {
  if (!buf || !mask || base < 0 || bs < 0 || base + bs > buf_n ||
      lookback > base)
    return TLZ4_E_ARG;
  SessionTables &s = session_tables();
  int64_t zero = s.map(buf_n);
  match_block(s.tables, buf, /*buf_zero=*/zero, /*min_pos=*/zero, zero + base,
              bs, /*level=*/9, lookback, /*buf_end=*/zero + buf_n, out_len,
              out_dist, mask, cut_pos >= 0 ? zero + cut_pos : -1);
  return 0;
}

int64_t tlz4_match_refine2(const uint8_t *buf, int64_t buf_n, int64_t base,
                           int64_t bs, int64_t lookback, int64_t cut_pos,
                           const uint8_t *mask, const int32_t *targets,
                           int32_t *out_len, int32_t *out_dist) {
  /* Distance-only refine: targets[i] is the certified exact max length at
   * masked position i (the device length-known certificate), so the walk
   * early-stops at its first achiever — the reference's nearest-of-max
   * (smallz4.h:173-255 walks nearest-first and keeps the first max). */
  if (!buf || !mask || !targets || base < 0 || bs < 0 || base + bs > buf_n ||
      lookback > base)
    return TLZ4_E_ARG;
  SessionTables &s = session_tables();
  int64_t zero = s.map(buf_n);
  match_block(s.tables, buf, /*buf_zero=*/zero, /*min_pos=*/zero, zero + base,
              bs, /*level=*/9, lookback, /*buf_end=*/zero + buf_n, out_len,
              out_dist, mask, cut_pos >= 0 ? zero + cut_pos : -1,
              /*block_end=*/-1, targets);
  return 0;
}

int64_t tlz4_chosen(const int32_t *lens, int64_t bs, uint8_t *out_mask) {
  /* Match starts of a DP-shortened lens array (the emitter's walk,
   * smallz4.h:259-371): out_mask[i] = 1 iff a match is emitted at i. */
  if (!lens || !out_mask || bs < 0) return TLZ4_E_ARG;
  std::memset(out_mask, 0, size_t(bs));
  int64_t n_chosen = 0;
  for (int64_t o = 0; o < bs;) {
    if (lens[o] >= 4) {
      out_mask[o] = 1;
      n_chosen++;
      o += lens[o];
    } else {
      o++;
    }
  }
  return n_chosen;
}

int64_t tlz4_unpack_claims(const uint32_t *bits, const int32_t *packed,
                           int64_t n_packed, int64_t n,
                           int32_t *lens, int32_t *dists) {
  if (!bits || !packed || !lens || !dists || n < 0 || (n & 31)) return TLZ4_E_ARG;
  int64_t rank = 0;
  int32_t len0 = 1, dist0 = 0;
  int64_t head_pos = 0;
  for (int64_t w = 0; w < n / 32; w++) {
    uint32_t word = bits[w];
    const int64_t base = w * 32;
    int64_t prev = -1;
    while (word) {
      const int b = __builtin_ctz(word);
      word &= word - 1;
      const int64_t p = base + b;
      /* decay-fill (prev head .. p); saturated heads (65535) hold flat
       * until the next head (giant-byte-run packing) */
      for (int64_t i = (prev < 0 ? base : prev); i < p; i++) {
        const int64_t k = i - head_pos;
        const int32_t l = len0 == 65535 ? 65535 : len0 - int32_t(k);
        lens[i] = l >= 4 ? l : 1;
        dists[i] = l >= 4 ? dist0 : 0;
      }
      if (rank >= n_packed) return TLZ4_E_ARG;
      const int32_t v = packed[rank++];
      len0 = (v >> 16) & 0xFFFF;
      dist0 = v & 0xFFFF;
      head_pos = p;
      prev = p;
    }
    const int64_t from = prev < 0 ? base : prev;
    for (int64_t i = from; i < base + 32; i++) {
      const int64_t k = i - head_pos;
      const int32_t l = len0 == 65535 ? 65535 : len0 - int32_t(k);
      lens[i] = l >= 4 ? l : 1;
      dists[i] = l >= 4 ? dist0 : 0;
    }
  }
  return rank;
}

int64_t tlz4_estimate_costs(int32_t *lens, const int32_t *dists, int64_t n) {
  if (!lens || !dists || n < 0) return TLZ4_E_ARG;
  estimate_costs(lens, dists, n);
  return 0;
}

int64_t tlz4_emit_block(const uint8_t *block, int64_t bs, const int32_t *lens,
                        const int32_t *dists, uint8_t *out, int64_t cap) {
  if (!block || !lens || !dists || bs < 0) return TLZ4_E_ARG;
  return emit_block(block, bs, lens, dists, out, cap);
}

int64_t tlz4_parse_sequences(const uint8_t *payload, int64_t n,
                             int32_t *lit_len, int32_t *match_len,
                             int32_t *match_off, int32_t *lit_src,
                             int64_t max_seq) {
  int64_t ip = 0, ns = 0;
  while (ip < n) {
    if (ns >= max_seq) return TLZ4_E_CAP;
    const uint8_t token = payload[ip++];
    int64_t nl = token >> 4;
    if (nl == 15) {
      uint8_t c;
      do {
        if (ip >= n) return TLZ4_E_DATA;
        c = payload[ip++];
        nl += c;
      } while (c == 255);
    }
    if (ip + nl > n) return TLZ4_E_DATA;
    lit_src[ns] = int32_t(ip);
    lit_len[ns] = int32_t(nl);
    ip += nl;
    if (ip == n) {  /* final literals-only token */
      match_len[ns] = 0;
      match_off[ns] = 0;
      ns++;
      break;
    }
    if (ip + 2 > n) return TLZ4_E_DATA;
    int64_t delta = payload[ip] | (int64_t(payload[ip + 1]) << 8);
    ip += 2;
    if (delta == 0) return TLZ4_E_OFFSET;
    int64_t ml = 4 + (token & 0x0F);
    if (ml == 19) {
      uint8_t c;
      do {
        if (ip >= n) return TLZ4_E_DATA;
        c = payload[ip++];
        ml += c;
      } while (c == 255);
    }
    match_len[ns] = int32_t(ml);
    match_off[ns] = int32_t(delta);
    ns++;
  }
  return ns;
}

int64_t tlz4_decode_block(const uint8_t *payload, int64_t n,
                          const uint8_t *hist, int64_t hist_n, uint8_t *out,
                          int64_t cap) {
  if (!payload || n < 0 || hist_n < 0) return TLZ4_E_ARG;
  return decode_block(payload, n, hist, hist_n, out, cap);
}

uint32_t tlz4_xxh32(const uint8_t *data, int64_t n, uint32_t seed) {
  return xxh32(data, n < 0 ? 0 : size_t(n), seed);
}

const char *tlz4_version(void) { return "1.5"; }
