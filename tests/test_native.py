"""Native C++ runtime tests: bit-parity with reference + oracle, streaming
contexts, block-level entry points, error taxonomy."""
import pathlib

import numpy as np
import pytest

from smallz4_tpu import format as fmt
from smallz4_tpu import native, oracle


@pytest.fixture(scope="module", autouse=True)
def _need_native():
    if not native.available():
        pytest.skip("native runtime not built")


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4, 5, 6, 7, 8, 9])
def test_bit_exact_vs_reference(reference, corpora, level):
    for name, data in corpora.items():
        assert native.compress(data, level) == reference.compress(data, level), (name, level)


@pytest.mark.parametrize("level", [1, 3, 6, 9])
def test_bit_exact_legacy(reference, corpora, level):
    for name, data in corpora.items():
        got = native.compress(data, level, legacy=True)
        assert got == reference.compress(data, level, legacy=True), (name, level)


def test_multiblock_bit_exact_vs_reference(reference):
    # >4 MB forces multiple blocks: exercises history carry, lookback
    # re-seeding and the block-boundary chain cut
    rng = np.random.default_rng(3)
    text = (pathlib.Path("/root/reference/smallz4.h").read_bytes()
            + pathlib.Path("/root/reference/smallz4cat.c").read_bytes())
    pieces = []
    for i in range(110):
        pieces.append(rng.integers(0, 256, 30000, dtype=np.uint8).tobytes())
        pieces.append(b"repetitive payload %d " % (i % 7) * 40)
        # rotate through distinct text slices so windows aren't saturated
        # with whole-file duplicates (that is the reference's own quadratic
        # pathology, covered by the slow-marked tests)
        o = (i * 1913) % (len(text) - 8000)
        pieces.append(text[o : o + 8000])
    data = b"".join(pieces)
    assert len(data) > fmt.MAX_BLOCK_SIZE
    ref9 = reference.compress(data, 9)
    assert native.compress(data, 9) == ref9
    assert native.compress(data, 1) == reference.compress(data, 1)
    assert native.decompress(ref9) == data


def test_matches_oracle_custom_blocks(corpora):
    data = corpora["text"] + corpora["struct"]
    for bs, level in ((500, 9), (4096, 5), (65536, 2)):
        assert native.compress(data, level, block_size=bs) == oracle.compress(
            data, level, block_size=bs
        ), (bs, level)


def test_dictionary_matches_oracle(corpora):
    data = corpora["struct"]
    dictionary = corpora["text"][:10000]
    got = native.compress(data, 9, dictionary=dictionary)
    assert got == oracle.compress(data, 9, dictionary=dictionary)
    assert native.decompress(got, dictionary=dictionary) == data


def test_streaming_encoder_chunked(reference, corpora):
    data = (corpora["text"] + corpora["mixed"]) * 3
    enc = native.Encoder(level=9)
    parts = [enc.write(data[i : i + 999]) for i in range(0, len(data), 999)]
    parts.append(enc.write(b"", final=True))
    enc.close()
    assert b"".join(parts) == reference.compress(data, 9)


def test_streaming_decoder_chunked(reference, corpora):
    data = corpora["struct"] * 5
    frame = reference.compress(data, 9)
    dec = native.Decoder()
    parts = [dec.write(frame[i : i + 53]) for i in range(0, len(frame), 53)]
    parts.append(dec.write(b"", final=True))
    assert b"".join(parts) == data
    assert dec.done


def test_ring_decoder_matches_reference(reference, corpora):
    """Constant-memory ring decoder (smallz4cat.c memory profile): exact
    output across chunk sizes, formats, and levels."""
    data = (corpora["text"] + corpora["mixed"] + corpora["run_mid"]) * 2
    for legacy in (False, True):
        for level in (9, 1):
            frame = reference.compress(data, level, legacy=legacy)
            for chunk in (1, 7, 65536, len(frame)):
                with native.RingDecoder() as dec:
                    out = bytearray()
                    for i in range(0, len(frame), chunk):
                        out += dec.write(frame[i : i + chunk])
                    out += dec.write(b"", final=True)
                assert bytes(out) == data, (legacy, level, chunk)
                assert dec.done


def test_ring_decoder_small_out_chunk(corpora):
    """Output pieces are bounded by out_chunk — the constant-memory
    guarantee is structural, not incidental."""
    data = corpora["run_mid"] * 8 + corpora["text"]
    frame = native.compress(data, 9)
    with native.RingDecoder(out_chunk=4096) as dec:
        pieces = list(dec.chunks(frame, final=True))
    assert all(len(p) <= 4096 for p in pieces)
    assert b"".join(pieces) == data


def test_ring_decoder_dictionary_and_checksums(corpora):
    dic = corpora["text"][:30000]
    data = corpora["mixed"] + corpora["text"][:10000]
    frame = native.compress(data, 9, dictionary=dic)
    with native.RingDecoder(dictionary=dic) as dec:
        assert dec.write(frame, final=True) == data
    frame2 = native.compress(data, 9, content_checksum=True,
                             block_checksum=True)
    with native.RingDecoder(verify=True) as dec:
        assert dec.write(frame2, final=True) == data
    bad = bytearray(frame2)
    bad[25] ^= 0xFF
    with pytest.raises(fmt.FormatError):
        with native.RingDecoder(verify=True) as dec:
            dec.write(bytes(bad), final=True)


def test_ring_decoder_errors():
    with pytest.raises(fmt.FormatError, match="signature"):
        native.RingDecoder().write(b"\x00\x01\x02\x03\x04\x05\x06\x07",
                                   final=True)
    frame = native.compress(b"truncate me " * 400, 9)
    with pytest.raises(fmt.FormatError, match="out of data"):
        native.RingDecoder().write(frame[: len(frame) // 2], final=True)
    # zero offset is rejected (smallz4cat.c:266-267 semantics)
    with pytest.raises(fmt.FormatError):
        bad = bytes.fromhex("04224d1840705f") + bytes([5, 0, 0, 0]) \
            + bytes.fromhex("1041000041") + b"\x00" * 4
        native.RingDecoder().write(bad, final=True)


def test_block_level_entry_points(corpora):
    """The device-hybrid host ops: match -> DP -> emit == oracle pipeline."""
    data = np.frombuffer(corpora["text"], dtype=np.uint8)
    bs = len(data)
    lens, dists = native.match_block(data, base=0, bs=bs, level=9)
    native.estimate_costs(lens, dists)
    payload = native.emit_block(data, lens, dists)
    full = oracle.compress(corpora["text"], 9)
    # oracle frame = header + block header + payload + end mark
    assert payload == full[11:-4]
    # decode_block closes the loop
    assert native.decode_block(payload) == corpora["text"]


def test_parse_sequences_roundtrip(corpora):
    payload = oracle.compress(corpora["struct"], 9)[11:-4]
    lit_len, match_len, match_off, lit_src = native.parse_sequences(payload)
    # reconstruct by expansion
    out = bytearray()
    for ll, ml, off, src in zip(lit_len, match_len, match_off, lit_src):
        out += payload[src : src + ll]
        for _ in range(ml):
            out.append(out[len(out) - off])
    assert bytes(out) == corpora["struct"]
    assert match_len[-1] == 0  # final literals-only token


def test_error_taxonomy():
    with pytest.raises(fmt.FormatError, match="invalid signature"):
        native.decompress(b"garbage-stream")
    with pytest.raises(fmt.FormatError, match="version 1"):
        native.decompress(fmt.MAGIC_MODERN_BYTES + bytes([0x80, 0x70, 0]) + b"\x00" * 8)
    bad = bytes([0x10, 0x41, 0x00, 0x00, 0x04])
    frame = fmt.build_frame_header() + fmt.build_block_header(len(bad), False) + bad + fmt.END_MARK
    with pytest.raises(fmt.FormatError, match="invalid offset"):
        native.decompress(frame)
    good = native.compress(b"hello world " * 100)
    with pytest.raises(fmt.FormatError, match="out of data"):
        native.decompress(good[:-6])
    with pytest.raises(ValueError):
        native.compress(b"x", 9, legacy=True, dictionary=b"d")


def test_incompressible_stored(reference):
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    got = native.compress(data, 9)
    assert got == reference.compress(data, 9)
    assert len(got) == len(data) + 15
    assert native.decompress(got) == data


def test_unpack_claims_matches_numpy_inverse():
    """native.unpack_claims == the numpy unpacker on random decay packings
    (the device packer's head rule, ops/chunkmatch.py pack_results)."""
    from smallz4_tpu.ops import chunkmatch as cm

    rng = np.random.default_rng(1)
    for _ in range(10):
        n = 1024
        lens = np.ones(n, np.int32)
        dists = np.zeros(n, np.int32)
        i = 0
        while i < n:
            if rng.random() < 0.5:
                L = int(rng.integers(4, 70))
                d = int(rng.integers(1, 60000))
                span = min(int(rng.integers(1, L + 3)), n - i)
                for k in range(span):
                    v = L - k
                    lens[i + k] = v if v >= 4 else 1
                    dists[i + k] = d if v >= 4 else 0
                i += span
            else:
                i += int(rng.integers(1, 9))
        pl = np.roll(lens, 1)
        pd = np.roll(dists, 1)
        head = (lens != np.where(pl >= 5, pl - 1, 1)) | \
               (dists != np.where(pl >= 5, pd, 0))
        head[0] = True
        words = np.zeros(n // 32, np.uint32)
        idx = np.flatnonzero(head)
        for p in idx:
            words[p // 32] |= np.uint32(1 << (p % 32))
        packed = ((np.minimum(lens[idx], 65535).astype(np.int64) << 16)
                  | dists[idx]).astype(np.int32)
        l1, d1 = native.unpack_claims(words, packed, n)
        l2, d2 = cm.unpack_results(words.view(np.int32), packed, chunk=n)
        np.testing.assert_array_equal(l1, lens)
        np.testing.assert_array_equal(d1, dists)
        np.testing.assert_array_equal(l2, lens)
        np.testing.assert_array_equal(d2, dists)


class TestLengthDistanceSplit:
    """Round-5 split-certificate machinery: the post-DP distance fix and
    the host deep-run certificate (smallz4_tpu/ops/pipeline.py)."""

    def _mixed(self, n, seed):
        rng = np.random.default_rng(seed)
        parts = []
        while sum(map(len, parts)) < n:
            r = rng.random()
            if r < 0.3:
                parts.append(bytes(rng.integers(0, 256, 300, dtype=np.uint8)))
            elif r < 0.7:
                parts.append(bytes(rng.integers(97, 103, 400, dtype=np.uint8)))
            elif parts:
                parts.append(parts[int(rng.integers(0, len(parts)))])
        return b"".join(parts)[:n]

    def test_chosen_mask_matches_emitter_walk(self):
        data = self._mixed(200_000, 5)
        n = len(data)
        lens, dists = native.match_block(np.frombuffer(data, np.uint8),
                                         base=0, bs=n, level=9)
        lens[n - 11:] = 1
        dists[n - 11:] = 0
        native.estimate_costs(lens, dists)
        mask = native.chosen_mask(lens)
        o, want = 0, np.zeros(n, bool)
        while o < n:
            if lens[o] >= 4:
                want[o] = True
                o += lens[o]
            else:
                o += 1
        np.testing.assert_array_equal(mask, want)

    def test_match_refine_dist_returns_nearest_of_max(self):
        """Feed exact lengths but deliberately WRONG (farther) genuine
        distances at some positions; the early-stop walk must recover the
        reference's nearest-of-max distance everywhere."""
        data = self._mixed(150_000, 7)
        n = len(data)
        el, ed = native.match_block(np.frombuffer(data, np.uint8),
                                    base=0, bs=n, level=9)
        el[n - 11:] = 1
        ed[n - 11:] = 0
        rng = np.random.default_rng(1)
        dists = ed.copy()
        targets = el.copy()
        # corrupt distances at a third of match positions (any nonzero
        # value: the fix must not trust the incoming distance at all)
        m = (el >= 4) & (rng.random(n) < 0.33)
        dists[m] = 1 + (dists[m] + 17) % 60000
        need = m.astype(np.uint8)
        native.match_refine_dist(np.frombuffer(data, np.uint8), base=0,
                                 bs=n, lookback=0, mask=need,
                                 targets=targets, lens=targets, dists=dists)
        np.testing.assert_array_equal(dists[m], ed[m])
        np.testing.assert_array_equal(targets, el)  # lengths preserved

    def test_deep_run_rule_matches_reference(self):
        """Giant byte runs: the host rule's values equal the exact native
        matcher at every position it certifies (including the excluded
        shortcut-lapse position staying uncertified)."""
        from smallz4_tpu.ops import pipeline as pl

        rng = np.random.default_rng(2)
        data = (bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
                + b"A" * 200_000
                + bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
                + b"B" * 140_000
                + self._mixed(30_000, 9))
        n = len(data)
        el, ed = native.match_block(np.frombuffer(data, np.uint8),
                                    base=0, bs=n, level=9)
        el[el < 4] = 1
        ed[el < 4] = 0
        el[n - 11:] = 1
        ed[n - 11:] = 0
        lens = np.ones(n, np.int32)
        dists = np.zeros(n, np.int32)
        conv = np.zeros(n, bool)
        lk = np.zeros(n, bool)
        pl._deep_run_rule(np.frombuffer(data, np.uint8), 0, n,
                          lens, dists, conv, lk)
        assert conv.sum() > 100_000  # the rule actually fires
        m = conv & (np.arange(n) < n - 11)
        norm_el = np.where(el >= 4, el, 1)
        norm_ed = np.where(el >= 4, ed, 0)
        np.testing.assert_array_equal(lens[m], norm_el[m])
        np.testing.assert_array_equal(dists[m], norm_ed[m])
