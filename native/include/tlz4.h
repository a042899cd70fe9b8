/* tlz4 — native host runtime for the smallz4_tpu framework.
 *
 * A from-scratch C++ implementation of the LZ4 codec with bit-exact
 * behavioral parity to the framework's oracle (smallz4_tpu/oracle.py),
 * which is itself golden-tested against the reference encoder
 * (reference: smallz4.h:476-814) and decoder (smallz4cat.c:112-360).
 *
 * Three API layers:
 *   1. streaming contexts (tlz4_enc / tlz4_dec) — used by the CLIs;
 *   2. one-shot frame helpers;
 *   3. block-level entry points (match/parse/emit/sequence-split) — the
 *      host side of the hybrid device pipeline.
 *
 * All functions return >= 0 on success or a negative TLZ4_E_* code.
 */
#ifndef TLZ4_H
#define TLZ4_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

#define TLZ4_E_ARG        (-1) /* bad argument / unsupported combination */
#define TLZ4_E_CAP        (-2) /* output buffer too small */
#define TLZ4_E_MAGIC      (-3) /* invalid signature */
#define TLZ4_E_VERSION    (-4) /* only LZ4 file format version 1 supported */
#define TLZ4_E_OFFSET     (-5) /* invalid offset */
#define TLZ4_E_DATA       (-6) /* out of data / truncated stream */
#define TLZ4_E_CHECKSUM   (-7) /* checksum mismatch (verifying decoder) */

/* frame feature flags for tlz4_enc_new2 */
#define TLZ4_F_CONTENT_CHECKSUM 1
#define TLZ4_F_BLOCK_CHECKSUM   2

/* ---------------- streaming encoder ---------------- */

typedef struct tlz4_enc tlz4_enc;

/* level 0..9 (9 = optimal parse, reference parity: smallz4.cpp:144-155);
 * legacy != 0 selects the legacy frame format (8 MB blocks, no history
 * carry); dict may be NULL; block_size 0 means the format default
 * (4 MB modern / 8 MB legacy).  Legacy + dict and legacy + level 0 are
 * rejected (reference CLI parity: smallz4.cpp:272-279). */
tlz4_enc *tlz4_enc_new(int level, int legacy,
                       const uint8_t *dict, int64_t dict_n,
                       int64_t block_size);
/* As tlz4_enc_new plus frame feature flags (TLZ4_F_*): spec-complete
 * content/block checksums with a real xxHash32 header byte — a capability
 * superset of the reference, whose streams stay byte-identical when
 * flags == 0. */
tlz4_enc *tlz4_enc_new2(int level, int legacy,
                        const uint8_t *dict, int64_t dict_n,
                        int64_t block_size, int flags);
void tlz4_enc_free(tlz4_enc *);

/* Feed input (n may be 0); set final!=0 on the last call.  Compressed bytes
 * for every block completed by this call (plus header/end-mark) are written
 * to out.  Returns bytes written, or TLZ4_E_CAP if out_cap is smaller than
 * tlz4_enc_bound() of the data that became emittable. */
int64_t tlz4_enc_write(tlz4_enc *, const uint8_t *in, int64_t n, int final,
                       uint8_t *out, int64_t out_cap);

/* Worst-case output for feeding n more input bytes (covers header, block
 * headers, stored-block fallback and the end mark). */
int64_t tlz4_enc_bound(const tlz4_enc *, int64_t n);

/* ---------------- streaming decoder ---------------- */

typedef struct tlz4_dec tlz4_dec;

tlz4_dec *tlz4_dec_new(const uint8_t *dict, int64_t dict_n);
/* As tlz4_dec_new; verify != 0 checks block/content checksums when the
 * frame carries them (TLZ4_E_CHECKSUM on mismatch) instead of skipping
 * them like the reference (smallz4cat.c:345-356). */
tlz4_dec *tlz4_dec_new2(const uint8_t *dict, int64_t dict_n, int verify);
void tlz4_dec_free(tlz4_dec *);

/* Feed compressed bytes; decoded bytes of every block completed by this
 * call are written to out.  Returns bytes written (>= 0) or an error.
 * *done is set once the end mark was consumed (modern) — trailing input is
 * ignored, matching the reference's behavior.  For legacy frames call with
 * final!=0 at EOF.  out_cap must be >= 8 MB + 64 KB to guarantee progress
 * (largest legacy block). */
int64_t tlz4_dec_write(tlz4_dec *, const uint8_t *in, int64_t n, int final,
                       uint8_t *out, int64_t out_cap, int *done);

/* ---------------- constant-memory ring decoder ---------------- */

/* A byte-resumable decoder with the reference's memory profile: a 64 KB
 * ring plus a <=16-byte stash — no input retention, no output staging
 * (smallz4cat.c:73,162-166).  Feed any chunk; *consumed reports how much
 * was taken (< n when `out` filled: re-feed the remainder after draining).
 * Returns bytes written to out, or a TLZ4_E_* error. */
typedef struct tlz4_rdec tlz4_rdec;

tlz4_rdec *tlz4_rdec_new(const uint8_t *dict, int64_t dict_n, int verify);
void tlz4_rdec_free(tlz4_rdec *);
int64_t tlz4_rdec_write(tlz4_rdec *, const uint8_t *in, int64_t n, int final,
                        uint8_t *out, int64_t out_cap, int64_t *consumed,
                        int *done);

/* ---------------- one-shot helpers ---------------- */

int64_t tlz4_compress_bound(int64_t n);

int64_t tlz4_compress(const uint8_t *src, int64_t n,
                      uint8_t *dst, int64_t cap,
                      int level, int legacy,
                      const uint8_t *dict, int64_t dict_n,
                      int64_t block_size);

int64_t tlz4_decompress(const uint8_t *src, int64_t n,
                        uint8_t *dst, int64_t cap,
                        const uint8_t *dict, int64_t dict_n);

/* ---------------- block-level entry points (device hybrid path) ---------- */

/* Match finder over one block with left context.
 * buf       : context bytes; the block starts at buf[base] and ends at
 *             buf[base+bs]; bytes before base are history (<= 65535) or
 *             dictionary; match_limit_abs = base + bs - 5 internally.
 * lookback  : how many history positions to seed (reference lookback
 *             semantics incl. the boundary chain cut; pass base for
 *             dictionaries, min(data_zero,12) for carried history).
 * level     : 1..9.
 * out_len/out_dist : int32[bs] per-position match arrays (len<=1 literal).
 * Returns 0. */
int64_t tlz4_match_block(const uint8_t *buf, int64_t buf_n, int64_t base,
                         int64_t bs, int level, int64_t lookback,
                         int32_t *out_len, int32_t *out_dist);

/* tlz4_match_block with an explicit boundary chain-cut position (the
 * sequential re-insertion anomaly; pass base-12 for carried-history blocks
 * of a 4 MB frame, -1 for none). */
int64_t tlz4_match_block_ex(const uint8_t *buf, int64_t buf_n, int64_t base,
                            int64_t bs, int level, int64_t lookback,
                            int64_t cut_pos, int32_t *out_len,
                            int32_t *out_dist);

/* Intra-block chunk search: per-position matches for [base, base+bs) of a
 * larger block that ends at block_end (base+bs <= block_end <= buf_n), with
 * the block's own end rules (match limit block_end-5, 12-byte no-match
 * tail).  At the non-skipping levels (7-9) per-position results depend only
 * on the data, so a block's match stage splits into independent chunks —
 * bit-exact intra-block host parallelism.  Chunk bases must lie outside
 * giant-run shortcut zones (> MaxSameLetter equal bytes remaining after the
 * base; the caller snaps cuts, see parallel/host.py). */
int64_t tlz4_match_block_ex2(const uint8_t *buf, int64_t buf_n, int64_t base,
                             int64_t bs, int level, int64_t lookback,
                             int64_t cut_pos, int64_t block_end,
                             int32_t *out_len, int32_t *out_dist);

/* Selective re-search (level-9 semantics): runs the match search only at
 * positions with mask[i] != 0; others keep their incoming (len, dist).
 * Host side of the device parity fallback for unconverged lanes. */
int64_t tlz4_match_refine(const uint8_t *buf, int64_t buf_n, int64_t base,
                          int64_t bs, int64_t lookback, int64_t cut_pos,
                          const uint8_t *mask, int32_t *out_len,
                          int32_t *out_dist);

/* Distance-only refine: like tlz4_match_refine, but targets[i] carries the
 * certified exact max length at each masked position (the device length-known
 * certificate), letting the walk stop at its FIRST achiever — which is the
 * reference's nearest-of-max (smallz4.h:173-255 walks nearest-first and
 * only accepts strict improvements).  Bit-exact and far cheaper than a
 * full re-search when targets are long. */
int64_t tlz4_match_refine2(const uint8_t *buf, int64_t buf_n, int64_t base,
                           int64_t bs, int64_t lookback, int64_t cut_pos,
                           const uint8_t *mask, const int32_t *targets,
                           int32_t *out_len, int32_t *out_dist);

/* Match starts of a DP-shortened lens array (the emitter's walk,
 * smallz4.h:259-371): out_mask[i] = 1 iff a match is emitted at position i.
 * Returns the number of chosen matches. */
int64_t tlz4_chosen(const int32_t *lens, int64_t bs, uint8_t *out_mask);

/* Backward optimal-parse DP; shortens lens in place (reference parity:
 * smallz4.h:376-472). */
int64_t tlz4_estimate_costs(int32_t *lens, const int32_t *dists, int64_t n);

/* Expand the device matcher's head/delta packing (see
 * smallz4_tpu/ops/chunkmatch.py pack_results) into full per-position
 * claim arrays: bits = n/32 head bitmask words (bit i of word w = head at
 * position 32w+i), packed = (len16|dist16) words at head rank.  Decay
 * fill between heads: len decreases by 1, dist holds, flooring at the
 * literal (1, 0).  Returns the number of heads consumed, or TLZ4_E_*. */
int64_t tlz4_unpack_claims(const uint32_t *bits, const int32_t *packed,
                           int64_t n_packed, int64_t n,
                           int32_t *lens, int32_t *dists);

/* Serialize chosen matches into a token stream (smallz4.h:259-371). */
int64_t tlz4_emit_block(const uint8_t *block, int64_t bs,
                        const int32_t *lens, const int32_t *dists,
                        uint8_t *out, int64_t cap);

/* Split a compressed block payload into its sequence table:
 * lit_len[i], match_len[i] (0 for the final literals-only token),
 * match_off[i], lit_src[i] (payload offset of the literal run).
 * Returns the number of sequences, or an error. */
int64_t tlz4_parse_sequences(const uint8_t *payload, int64_t n,
                             int32_t *lit_len, int32_t *match_len,
                             int32_t *match_off, int32_t *lit_src,
                             int64_t max_seq);

/* Decode one block payload given up to 64 KB of history (+dict), appending
 * to out. Returns bytes produced. */
int64_t tlz4_decode_block(const uint8_t *payload, int64_t n,
                          const uint8_t *hist, int64_t hist_n,
                          uint8_t *out, int64_t cap);

uint32_t tlz4_xxh32(const uint8_t *data, int64_t n, uint32_t seed);

const char *tlz4_version(void);

#ifdef __cplusplus
}
#endif
#endif /* TLZ4_H */
