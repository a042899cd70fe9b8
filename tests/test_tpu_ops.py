"""Device-op correctness tests (run on the virtual CPU backend; the same
XLA programs run on the GPU).  The differential anchors are the native matcher
(itself reference-bit-exact) and the oracle."""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from smallz4_tpu import format as fmt, native, oracle
from smallz4_tpu.ops import decoder, grams as gops, match_finder, pipeline


@pytest.fixture(scope="module", autouse=True)
def _need_native():
    if not native.available():
        pytest.skip("native runtime not built")


def _np(x):
    return np.asarray(x)


def test_grams_and_hash_match_oracle(corpora):
    data = np.frombuffer(corpora["text"][:5000], np.uint8)
    g_dev = _np(gops.grams4(jnp.asarray(data)))
    g_ora = oracle.grams4(data)
    assert (g_dev[: len(g_ora)] == g_ora).all()
    h_dev = _np(gops.hash20(jnp.asarray(g_ora)))
    assert (h_dev == oracle.hash32(g_ora)).all()


def _bytes(n, seed=0):
    rng = np.random.default_rng(seed)
    parts = [b"abcabcabc run starts here: ", b"x" * 500,
             rng.integers(0, 256, n, dtype=np.uint8).tobytes()]
    return np.frombuffer(b"".join(parts)[:n], np.uint8)


@pytest.mark.parametrize("n", [1024, 4096, 5000])
def test_grams4_and_hash20_match_oracle(n):
    data = _bytes(n)
    g = _np(gops.grams4(jnp.asarray(data)))
    go = oracle.grams4(data)
    assert (g[: len(go)] == go).all()
    assert (g[len(go):] == 0).all()  # zero-padded tail
    assert (_np(gops.hash20(jnp.asarray(g[: len(go)]))) == oracle.hash32(go)).all()


def _run_lengths_np(data):
    n = len(data)
    out = np.empty(n, np.int32)
    run = 0
    for i in range(n - 1, -1, -1):
        run = run + 1 if i + 1 < n and data[i] == data[i + 1] else 1
        out[i] = run
    return out


@pytest.mark.parametrize("n", [1024, 2048, 4096, 6000])
def test_run_lengths_matches_numpy(n):
    data = _bytes(n, seed=3)
    got = _np(match_finder._run_lengths(jnp.asarray(data).astype(jnp.int32)))
    np.testing.assert_array_equal(got, _run_lengths_np(data))


def test_run_lengths_pure_run():
    data = np.full(3072, 65, np.uint8)
    got = _np(match_finder._run_lengths(jnp.asarray(data).astype(jnp.int32)))
    np.testing.assert_array_equal(got, np.arange(3072, 0, -1))


def test_build_prev_matches_sort_oracle(corpora):
    data = np.frombuffer(corpora["mixed"][:4000], np.uint8)
    g = oracle.grams4(data)
    valid = np.ones(len(g), bool)
    prev_dev = _np(match_finder.build_prev(jnp.asarray(g), jnp.asarray(valid)))
    prev_ref = oracle.prev_occurrence(g)
    assert (prev_dev == prev_ref).all()


BUF = 32768  # one fixed shape => one compile for the whole module


def _device_match(data: bytes, max_candidates=64, hist: bytes = b"", cut=False):
    hl = len(hist)
    n = hl + len(data)
    assert n <= BUF
    ctx = np.zeros(BUF, np.uint8)
    if hl:
        ctx[:hl] = np.frombuffer(hist, np.uint8)
    ctx[hl : n] = np.frombuffer(data, np.uint8)
    lens, dists, conv = match_finder.match_block(
        jnp.asarray(ctx), base=hl, end_valid=jnp.int32(n),
        search_len=BUF - hl, max_candidates=max_candidates, cut_boundary=cut,
    )
    sl = slice(0, len(data))
    return (_np(lens)[sl].astype(np.int32), _np(dists)[sl].astype(np.int32),
            _np(conv)[sl])


@pytest.mark.parametrize("name", ["text", "struct", "mixed", "random", "run_mid"])
def test_match_kernel_converged_lanes_exact(corpora, name):
    data = corpora[name][:16000][:BUF]
    lens, dists, conv = _device_match(data, max_candidates=64)
    nl, nd = native.match_block(np.frombuffer(data, np.uint8), 0, len(data), 9, 0)
    l1, n1 = np.where(lens <= 1, 1, lens), np.where(nl <= 1, 1, nl)
    ok = (l1 == n1) | ~conv
    okd = (np.where(l1 > 1, dists, 0) == np.where(n1 > 1, nd, 0)) | ~conv
    assert ok.all() and okd.all()


def test_match_kernel_run_analytic(corpora):
    # distance-1 runs resolve analytically (no extension loop): exact
    data = b"x" * 9000 + b"the-end-part"
    lens, dists, conv = _device_match(data, max_candidates=8)
    nl, nd = native.match_block(np.frombuffer(data, np.uint8), 0, len(data), 9, 0)
    assert (np.where(lens <= 1, 1, lens) == np.where(nl <= 1, 1, nl))[conv].all()
    # in-run positions get the exact analytic run match despite tiny K
    # (they stay "unconverged" — farther candidates could in principle be
    # longer — but the values match the exhaustive search)
    assert (dists[1:100] == 1).all()
    assert (lens[1:100] == nl[1:100]).all()


def test_refine_closes_unconverged(corpora):
    data = corpora["text"]  # enough gram repetition to exhaust small K
    lens, dists, conv = _device_match(data, max_candidates=4)
    assert not conv.all()  # the point of this test
    mask = ~conv
    native.match_refine(np.frombuffer(data, np.uint8), 0, len(data), 0,
                        mask, lens, dists)
    nl, nd = native.match_block(np.frombuffer(data, np.uint8), 0, len(data), 9, 0)
    assert (np.where(lens <= 1, 1, lens) == np.where(nl <= 1, 1, nl)).all()
    assert (np.where(lens > 1, dists, 0) == np.where(nl > 1, nd, 0)).all()


def test_expand_block_roundtrip(corpora):
    for name in ("text", "struct", "run", "random"):
        data = corpora[name]
        frame = native.compress(data, 9)
        size_word = int.from_bytes(frame[7:11], "little")
        if size_word & 0x80000000:  # stored block: nothing to expand
            continue
        payload = frame[11 : 11 + size_word]
        dec = decoder.DeviceBlockDecoder(out_cap=fmt.MAX_BLOCK_SIZE)
        assert dec.decode(payload, b"") == data, name


def test_expand_block_with_history_and_dict(corpora):
    dict_data = corpora["text"][:8000]
    data = dict_data[1000:5000] + b"-tail-" + dict_data[:200]
    frame = native.compress(data, 9, dictionary=dict_data)
    assert pipeline.decompress(frame, dictionary=dict_data) == data


def test_pipeline_roundtrip_all_engines(corpora):
    for name, data in corpora.items():
        frame = pipeline.compress(data, 9, kernel="walk", max_candidates=8)
        assert native.decompress(frame) == data, name
        assert oracle.decompress(frame) == data, name
        assert pipeline.decompress(native.compress(data, 9)) == data, name


def test_pipeline_parity_mode(corpora):
    for name in ("text", "struct", "mixed", "random"):
        data = corpora[name]
        assert pipeline.compress(data, 9, parity=True, kernel="walk",
                                 max_candidates=8) == \
            native.compress(data, 9), name


def test_pipeline_multiblock_parity():
    # >64 KB blocks across several segments, including history carry
    rng = np.random.default_rng(5)
    piece = rng.integers(0, 256, 30000, dtype=np.uint8).tobytes()
    data = (piece + b"needle in a haystack " * 2000 + piece) * 2
    bs = 131072
    got = pipeline.compress(data, 9, block_size=bs, parity=True,
                            kernel="walk", max_candidates=8)
    want = native.compress(data, 9, block_size=bs)
    assert got == want
    assert pipeline.decompress(got) == data


def test_pipeline_turbo_size_close_to_optimal(corpora):
    data = corpora["text"] + corpora["struct"]
    turbo = pipeline.compress(data, 9, kernel="walk", max_candidates=16)
    exact = native.compress(data, 9)
    # capped-candidate turbo trades a few % of ratio for bounded walks;
    # parity mode (tested above) recovers the exact stream
    assert len(turbo) <= len(exact) * 1.04
    assert len(turbo) < len(data) // 2


def test_tpu_decode_multiblock_mixed(corpora):
    # multi-block frame with stored and compressed blocks interleaved and
    # cross-block matches: exercises the device-resident history chain
    rng = np.random.default_rng(13)
    data = (rng.integers(0, 256, 140000, dtype=np.uint8).tobytes()  # stored
            + corpora["text"] * 12                                   # compressed
            + rng.integers(0, 256, 140000, dtype=np.uint8).tobytes()
            + corpora["text"][:30000])
    frame = native.compress(data, 9, block_size=131072)
    assert pipeline.decompress(frame) == data
