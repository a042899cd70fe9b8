"""Chunk-merge device matcher (ops/chunkmatch.py) on the CPU backend.

Drives a 2-chunk stream through sort_chunk + probe_pair and checks the
parity contract against a nearest-first brute-force search: every claim
byte-verified and never longer than optimal; converged positions exact.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from smallz4_tpu import format as fmt
from smallz4_tpu.ops import chunkmatch

C = 1024  # test chunk size


def _brute(data, start, end):
    """Nearest-first longest-match search (reference semantics)."""
    n = len(data)
    lens = np.ones(n, np.int64)
    dists = np.zeros(n, np.int64)
    limit = end - fmt.BLOCK_END_LITERALS
    for p in range(start, end - fmt.BLOCK_END_NO_MATCH + 1):
        cap = limit - p
        best, bd = 0, 0
        for q in range(p - 1, max(start, p - fmt.MAX_DISTANCE) - 1, -1):
            l = 0
            while l < cap and data[q + l] == data[p + l]:
                l += 1
            if l > best:
                best, bd = l, p - q
        if best >= fmt.MIN_MATCH:
            lens[p], dists[p] = best, bd
    return lens, dists


def _run_stream(data: bytes):
    """Drive n_chunks of C positions; returns lens/dists/conv/lk."""
    n = len(data)
    assert n % C == 0
    padded = np.zeros(n + chunkmatch.LOOK, np.uint8)
    padded[:n] = np.frombuffer(data, np.uint8)
    lens = np.ones(n, np.int32)
    dists = np.zeros(n, np.int32)
    conv = np.ones(n, bool)
    lk = np.ones(n, bool)
    halo = chunkmatch.empty_halo(chunk=C)
    for ci in range(n // C):
        s = ci * C
        buf = jnp.asarray(padded[s : s + C + chunkmatch.LOOK])
        hi = min(C, n - fmt.BLOCK_END_NO_MATCH + 1 - s)
        cur = chunkmatch.sort_chunk(buf, jnp.int32(0), jnp.int32(hi), chunk=C)
        l, d, cv, kk = chunkmatch.probe_pair(
            halo, cur, jnp.int32(0), jnp.int32(-1),
            jnp.int32(0), jnp.int32(hi),
            jnp.int32(n - fmt.BLOCK_END_LITERALS - s), chunk=C)
        lens[s : s + C] = np.asarray(l).astype(np.int32)
        dists[s : s + C] = np.asarray(d).astype(np.int32)
        conv[s : s + C] = np.asarray(cv)
        lk[s : s + C] = np.asarray(kk)
        halo = cur
    return lens, dists, conv, lk


def _corpus(seed, n):
    rng = np.random.default_rng(seed)
    parts = [
        bytes(rng.integers(97, 102, 400, dtype=np.uint8)),
        b"A" * 300,
        bytes(rng.integers(0, 256, 200, dtype=np.uint8)),
        bytes(rng.integers(97, 102, 200, dtype=np.uint8)),
    ]
    return (b"".join(parts) * 4)[:n]


@pytest.mark.parametrize("seed", [7, 13])
def test_chunk_stream_verified_and_converged_exact(seed):
    data = _corpus(seed, 2 * C)
    arr = np.frombuffer(data, np.uint8).astype(np.int64)
    lens, dists, conv, lk = _run_stream(data)
    bl, bd = _brute(arr, 0, len(data))

    n_conv = n_lk = 0
    for p in range(len(data)):
        if lens[p] >= 4:
            d, l = int(dists[p]), int(lens[p])
            assert 1 <= d <= fmt.MAX_DISTANCE and p - d >= 0, (p, d)
            assert (arr[p - d : p - d + l] == arr[p : p + l]).all(), (p, l, d)
            assert l <= bl[p], (p, l, bl[p])
        if conv[p]:
            assert lk[p], p  # conv implies length-known
            n_conv += 1
            want_l = bl[p] if bl[p] >= 4 else 1
            assert lens[p] == want_l, (p, lens[p], want_l)
            if want_l >= 4:
                assert dists[p] == bd[p], (p, dists[p], bd[p])
        if lk[p]:
            n_lk += 1
            want_l = bl[p] if bl[p] >= 4 else 1
            # LK certifies the LENGTH only (the distance may be a
            # farther achiever of the same max — fixed post-DP)
            assert lens[p] == want_l, (p, lens[p], want_l)
    assert n_conv > len(data) // 4  # certificate isn't vacuous
    assert n_lk >= n_conv


@pytest.mark.parametrize("seed", [21, 42])
def test_chunk_stream_induction_certificate_exact(seed):
    """Match-heavy adversarial corpus for the backward induction
    certificate: long near-identical fragments (every position sits under
    a long match, LCP >= the verification reach, so the per-position
    rules certify almost nothing and induction must carry the load) with
    single-byte perturbations that break decay chains mid-match.  Every
    converged claim must equal the brute-force reference walk."""
    rng = np.random.default_rng(seed)
    frag = bytearray(rng.integers(97, 103, 300, dtype=np.uint8).tobytes())
    parts = []
    while sum(map(len, parts)) < 2 * C:
        frag[int(rng.integers(0, len(frag)))] ^= 1
        parts.append(bytes(frag))
        if rng.random() < 0.3:  # short runs interleaved
            parts.append(bytes([int(rng.integers(97, 100))]) * 40)
    data = b"".join(parts)[: 2 * C]
    arr = np.frombuffer(data, np.uint8).astype(np.int64)
    lens, dists, conv, lk = _run_stream(data)
    bl, bd = _brute(arr, 0, len(data))
    n_conv = 0
    for p in range(len(data)):
        if conv[p]:
            n_conv += 1
            want_l = bl[p] if bl[p] >= 4 else 1
            assert lens[p] == want_l, (p, lens[p], want_l)
            if want_l >= 4:
                assert dists[p] == bd[p], (p, dists[p], bd[p])
        if lk[p]:
            want_l = bl[p] if bl[p] >= 4 else 1
            assert lens[p] == want_l, (p, lens[p], want_l)
    # the certificate must actually certify long-match interiors (the
    # per-position rules alone certify almost nothing on this corpus)
    assert n_conv > len(data) // 2, n_conv


def test_chunk_boundary_cut():
    """The boundary-cut gram's pre-cut occurrences are not candidates."""
    rng = np.random.default_rng(3)
    base = bytes(rng.integers(97, 105, C, dtype=np.uint8))
    data = base + base  # chunk 1 repeats chunk 0 at distance C
    padded = np.zeros(2 * C + chunkmatch.LOOK, np.uint8)
    padded[: 2 * C] = np.frombuffer(data, np.uint8)

    halo = chunkmatch.sort_chunk(
        jnp.asarray(padded[: C + chunkmatch.LOOK]), jnp.int32(0), jnp.int32(C), chunk=C)
    cur = chunkmatch.sort_chunk(
        jnp.asarray(padded[C : 2 * C + chunkmatch.LOOK]), jnp.int32(0), jnp.int32(C),
        chunk=C)
    cut_pos = C - fmt.BLOCK_END_NO_MATCH
    cut_gram = np.int32(chunkmatch.pack_cut_gram(
        padded[cut_pos : cut_pos + 4].tobytes()))
    limit = jnp.int32(2 * C - fmt.BLOCK_END_LITERALS - C)

    l0, d0, _, _ = chunkmatch.probe_pair(
        halo, cur, jnp.int32(0), jnp.int32(-1),
        jnp.int32(0), jnp.int32(C), limit, chunk=C)
    l1, d1, _, _ = chunkmatch.probe_pair(
        halo, cur, jnp.int32(cut_gram), jnp.int32(cut_pos),
        jnp.int32(0), jnp.int32(C), limit, chunk=C)
    l0, d0, l1, d1 = map(np.asarray, (l0, d0, l1, d1))

    arr = padded[: 2 * C].astype(np.int64)
    # claims stay byte-verified under the cut
    for p in range(C):
        if l1[p] >= 4:
            q = C + p - int(d1[p])
            assert (arr[q : q + l1[p]] == arr[C + p : C + p + l1[p]]).all()
    # the cut must suppress at least one pre-cut candidate the un-cut
    # search used (base repeats, so early chunk-1 positions match the
    # cut gram's earlier occurrences)
    assert (d0 != d1).any() or (l0 != l1).any()


def test_probe_lcp_composed_equals_direct(monkeypatch):
    """The composed probe LCP (adjacent plane + sparse min-table) must be
    bit-identical to the direct per-probe compare on every output plane —
    lens, dists, conv, lk — including under a live boundary cut (the cut
    exclusion rides a combo bit in composed mode)."""
    rng = np.random.default_rng(3)
    base = bytes(rng.integers(97, 105, C, dtype=np.uint8))
    data = base + base + _corpus(3, 2 * C)
    padded = np.zeros(len(data) + chunkmatch.LOOK, np.uint8)
    padded[: len(data)] = np.frombuffer(data, np.uint8)
    cut_pos = 100
    cut_gram = np.int32(chunkmatch.pack_cut_gram(
        padded[cut_pos : cut_pos + 4].tobytes()))

    outs = {}
    for mode in ("composed", "direct"):
        monkeypatch.setattr(chunkmatch, "PROBE_LCP", mode)
        jax.clear_caches()  # probe_pair bakes the module flag at trace time
        got = []
        halo = chunkmatch.empty_halo(chunk=C)
        for ci in range(len(data) // C):
            s = ci * C
            buf = jnp.asarray(padded[s : s + C + chunkmatch.LOOK])
            hi = min(C, len(data) - fmt.BLOCK_END_NO_MATCH + 1 - s)
            cg, cp = (cut_gram, cut_pos) if ci == 1 else (0, -1)
            planes = chunkmatch.probe_pair(
                halo, chunkmatch.sort_chunk(buf, jnp.int32(0), jnp.int32(hi),
                                            chunk=C),
                jnp.int32(cg), jnp.int32(cp), jnp.int32(0), jnp.int32(hi),
                jnp.int32(len(data) - fmt.BLOCK_END_LITERALS - s), chunk=C)
            got.append(tuple(np.asarray(p) for p in planes))
            halo = chunkmatch.sort_chunk(buf, jnp.int32(0), jnp.int32(hi),
                                         chunk=C)
        outs[mode] = got
    jax.clear_caches()
    for ca, da in zip(outs["composed"], outs["direct"]):
        for pa, pb in zip(ca, da):
            assert (pa == pb).all()


def test_pack_unpack_roundtrip():
    """Device head/delta packing inverts exactly on realistic claims."""
    rng = np.random.default_rng(11)
    n = 1024
    lens = np.ones(n, np.int32)
    dists = np.zeros(n, np.int32)
    i = 0
    while i < n:
        if rng.random() < 0.4:  # a match with chain-decay interior
            L = int(rng.integers(4, 60))
            d = int(rng.integers(1, 500))
            span = min(int(rng.integers(1, L + 3)), n - i)
            for k in range(span):
                lens[i + k] = max(L - k, 1) if L - k >= 4 else 1
                dists[i + k] = d if lens[i + k] >= 4 else 0
            i += span
        else:
            i += int(rng.integers(1, 8))
    conv = rng.random(n) < 0.8
    lk = conv | (rng.random(n) < 0.5)
    bits, packed, count, cbits, kbits = chunkmatch.pack_results(
        jnp.asarray(lens), jnp.asarray(dists), jnp.asarray(conv),
        jnp.asarray(lk), chunk=n)
    n_heads = int(np.asarray(count))
    l2, d2 = chunkmatch.unpack_results(
        np.asarray(bits), np.asarray(packed), chunk=n)
    np.testing.assert_array_equal(l2, lens)
    np.testing.assert_array_equal(d2, dists)
    np.testing.assert_array_equal(
        chunkmatch._unpack_bits(np.asarray(cbits), n), conv)
    np.testing.assert_array_equal(
        chunkmatch._unpack_bits(np.asarray(kbits), n), lk)
    assert n_heads < n  # packing actually compresses
    assert n_heads == chunkmatch._unpack_bits(np.asarray(bits), n).sum()


def test_pack_unpack_saturated_runs():
    """Saturated (65535) claims pack flat — one head per run segment, not
    one per position (the giant-byte-run head-overflow fix) — and both
    the numpy and native unpackers invert them exactly."""
    from smallz4_tpu import native

    n = 1024
    lens = np.full(n, 65535, np.int32)
    dists = np.ones(n, np.int32)
    lens[700:] = np.maximum(np.arange(65534, 65534 - (n - 700), -1), 1)
    conv = np.ones(n, bool)
    bits, packed, count, cbits, kbits = chunkmatch.pack_results(
        jnp.asarray(lens), jnp.asarray(dists), jnp.asarray(conv),
        jnp.asarray(conv), chunk=n)
    n_heads = int(np.asarray(count))
    assert n_heads <= 4, n_heads  # flat + one decay head
    l2, d2 = chunkmatch.unpack_results(
        np.asarray(bits), np.asarray(packed), chunk=n)
    np.testing.assert_array_equal(l2, lens)
    np.testing.assert_array_equal(d2, dists)
    l3, d3 = native.unpack_claims(
        np.asarray(bits), np.asarray(packed)[: n_heads], n)
    np.testing.assert_array_equal(l3, lens)
    np.testing.assert_array_equal(d3, dists)


def _mixed_stream(n, seed=5):
    rng = np.random.default_rng(seed)
    parts = []
    while sum(map(len, parts)) < n:
        r = rng.random()
        if r < 0.3:
            parts.append(bytes(rng.integers(0, 256, 200, dtype=np.uint8)))
        elif r < 0.6:
            parts.append(bytes(rng.integers(97, 103, 300, dtype=np.uint8)))
        elif r < 0.8 and parts:
            parts.append(parts[rng.integers(0, len(parts))])
        else:
            parts.append(bytes([rng.integers(0, 256)]) * int(rng.integers(5, 200)))
    return b"".join(parts)[:n]


@pytest.fixture()
def _tiny_chunks(monkeypatch):
    """Shrink the chunk engine so CPU e2e runs stay fast.

    NOTE: the convergence certificate needs CHUNK >= MAX_DISTANCE (the
    halo chunk must cover the whole window), so bit-parity assertions at
    the test chunk size only hold while every reference-visible candidate
    fits in (halo chunk, current chunk) — keep parity data <= 2*C and
    parity dictionaries <= C."""
    monkeypatch.setattr(chunkmatch, "CHUNK", C)
    monkeypatch.setattr(chunkmatch, "GROUP", 1)
    monkeypatch.setattr(chunkmatch, "HEAD_CAP", C)


def test_pipeline_chunk_engine_parity(_tiny_chunks):
    """End-to-end tpu-engine encode with the chunk kernel: parity mode is
    bit-identical to the native -9 stream.  One 2-chunk block exercises
    the device halo carry between chunks; cross-BLOCK parity requires
    blocks >= 64 KB + 12 (the reference's replay fine print — see
    pipeline.compress) and is validated on-chip at real chunk size."""
    from smallz4_tpu import native
    from smallz4_tpu.ops import pipeline

    bs = 2 * C
    data = _mixed_stream(2 * C)
    want = native.compress(data, 9, block_size=bs)
    got = pipeline.compress(data, 9, block_size=bs, parity=True,
                            kernel="chunk")
    assert got == want


def test_pipeline_chunk_engine_parity_small_blocks_delegate(_tiny_chunks):
    """Multi-block parity below the replay threshold must stay bit-exact
    (the engine delegates to the sequential native encoder)."""
    from smallz4_tpu import native
    from smallz4_tpu.ops import pipeline

    data = _mixed_stream(2 * C)
    got = pipeline.compress(data, 9, block_size=C, parity=True,
                            kernel="chunk")
    assert got == native.compress(data, 9, block_size=C)


def test_pipeline_chunk_engine_fast_roundtrip(_tiny_chunks):
    """Fast mode (no refine) over a longer ragged stream: every claim the
    device keeps must yield a valid stream; ratio stays -9-class."""
    from smallz4_tpu import native
    from smallz4_tpu.ops import pipeline

    bs = 2 * C
    data = _mixed_stream(4 * C + 700)
    fast = pipeline.compress(data, 9, block_size=bs, kernel="chunk",
                             parity=False)
    assert native.decompress(fast) == data
    want = native.compress(data, 9, block_size=bs)
    assert len(fast) <= int(len(want) * 1.10) + 64


def test_pipeline_chunk_engine_head_overflow(_tiny_chunks, monkeypatch):
    """Chunks whose head count exceeds the fetch cap fall back to the host
    matcher — the stream stays valid and -9-exact in parity mode."""
    from smallz4_tpu import native
    from smallz4_tpu.ops import pipeline

    monkeypatch.setattr(chunkmatch, "HEAD_CAP", 8)  # force overflow
    data = _mixed_stream(2 * C, seed=3)
    got = pipeline.compress(data, 9, block_size=2 * C, parity=True,
                            kernel="chunk")
    assert got == native.compress(data, 9, block_size=2 * C)
    fast = pipeline.compress(data, 9, block_size=2 * C, kernel="chunk",
                             parity=False)
    assert native.decompress(fast) == data


def test_pipeline_chunk_engine_cpu_assist(_tiny_chunks, monkeypatch):
    """Hybrid scheduling: host workers take whole blocks from the back of
    the stream; the mixed device/host stream stays valid."""
    from smallz4_tpu import native
    from smallz4_tpu.ops import pipeline

    monkeypatch.setenv("SMALLZ4_TPU_CPU_ASSIST", "1")
    data = _mixed_stream(6 * C + 100, seed=17)
    fast = pipeline.compress(data, 9, block_size=2 * C, kernel="chunk",
                             parity=False)
    assert native.decompress(fast) == data


def test_pipeline_chunk_engine_legacy(_tiny_chunks):
    """Legacy frames through the chunk engine: empty per-block halos (no
    history carry), parity with the native legacy stream."""
    from smallz4_tpu import native
    from smallz4_tpu.ops import pipeline

    data = _mixed_stream(C + 200, seed=23)  # single legacy block
    want = native.compress(data, 9, legacy=True, block_size=2 * C)
    got = pipeline.compress(data, 9, legacy=True, block_size=2 * C,
                            parity=True, kernel="chunk")
    assert got == want


def test_pipeline_chunk_engine_dictionary(_tiny_chunks):
    from smallz4_tpu import native
    from smallz4_tpu.ops import pipeline

    bs = C
    dict_data = _mixed_stream(700, seed=9)
    data = dict_data[100:500] + _mixed_stream(C - 400, seed=10)
    want = native.compress(data, 9, block_size=bs, dictionary=dict_data)
    got = pipeline.compress(data, 9, block_size=bs, parity=True,
                            kernel="chunk", dictionary=dict_data)
    assert got == want


def test_match_chunks_scan_equals_stepwise():
    """The fused scan path reproduces the stepwise sort+probe+pack loop,
    and the packed results invert to the stepwise claims."""
    data = _corpus(21, 4 * C)
    n = len(data)
    padded = np.zeros(n + chunkmatch.LOOK, np.uint8)
    padded[:n] = np.frombuffer(data, np.uint8)
    ref_lens, ref_dists, ref_conv, ref_lk = _run_stream(data)

    n_chunks = n // C
    bufs = np.stack([padded[i * C : i * C + C + chunkmatch.LOOK]
                     for i in range(n_chunks)])
    cand_hi = np.full(n_chunks, C, np.int32)
    valid_hi = np.full(n_chunks, C, np.int32)
    valid_hi[-1] = C - fmt.BLOCK_END_NO_MATCH + 1
    cand_hi[-1] = C - fmt.BLOCK_END_NO_MATCH + 1
    limit = np.array([n - fmt.BLOCK_END_LITERALS - i * C
                      for i in range(n_chunks)], np.int32)

    halo = chunkmatch.empty_halo(chunk=C)
    _, (bits, packed, counts, cbits, kbits) = chunkmatch.match_chunks(
        halo, jnp.asarray(bufs), jnp.asarray(cand_hi),
        jnp.asarray(valid_hi), jnp.asarray(limit),
        jnp.int32(0), jnp.int32(-1),
        n_chunks=n_chunks, head_cap=C, chunk=C)
    bits, packed, counts, cbits, kbits = map(
        np.asarray, (bits, packed, counts, cbits, kbits))

    for ci in range(n_chunks):
        l, d = chunkmatch.unpack_results(bits[ci], packed[ci], chunk=C)
        cv = chunkmatch._unpack_bits(cbits[ci], C)
        kk = chunkmatch._unpack_bits(kbits[ci], C)
        s = ci * C
        hi = int(valid_hi[ci])
        np.testing.assert_array_equal(l[:hi], ref_lens[s : s + hi])
        np.testing.assert_array_equal(d[:hi], ref_dists[s : s + hi])
        np.testing.assert_array_equal(cv[:hi], ref_conv[s : s + hi])
        np.testing.assert_array_equal(kk[:hi], ref_lk[s : s + hi])
        assert counts[ci] <= C


@pytest.mark.parametrize("k", [1, 8, 127, 128, 129, 160, -1, -160])
def test_flat_shift_matches_numpy(k):
    x = np.random.default_rng(abs(k)).integers(-1000, 1000, C, dtype=np.int32)
    want = np.full(C, -7, np.int32)
    if k > 0:
        want[: C - k] = x[k:]
    else:
        want[-k:] = x[: C + k]
    got = chunkmatch._flat_shift(jnp.asarray(x), k, fill=-7)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("keep_kind", ["none", "all", "random"])
def test_compact_matches_boolean_mask(keep_kind):
    rng = np.random.default_rng(4)
    vals = rng.integers(1, 1 << 30, C, dtype=np.int32)
    keep = {"none": np.zeros(C, bool), "all": np.ones(C, bool),
            "random": rng.random(C) < 0.3}[keep_kind]
    packed, count = chunkmatch._compact(jnp.asarray(keep), jnp.asarray(vals))
    packed = np.asarray(packed)
    assert int(count) == keep.sum()
    np.testing.assert_array_equal(packed[: keep.sum()], vals[keep])
    assert (packed[keep.sum():] == 0).all()


def test_bitmask_words_match_packbits():
    flag = np.random.default_rng(6).random(C) < 0.4
    got = np.asarray(chunkmatch._bitmask_words(jnp.asarray(flag)))
    want = np.packbits(flag, bitorder="little").view("<u4").view(np.int32)
    np.testing.assert_array_equal(got, want)
