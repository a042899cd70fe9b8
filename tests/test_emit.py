"""Device emitter (ops/emit.py) vs native emit_block — byte parity.

The contract: emit_block_device(block, lens, dists) produces exactly
native.emit_block's payload for any parse the DP emits (reference
selectBestMatches semantics, smallz4.h:259-371).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from smallz4_tpu import format as fmt
from smallz4_tpu import native
from smallz4_tpu.ops import emit


def _parse(data: bytes):
    n = len(data)
    lens, dists = native.match_block(np.frombuffer(data, np.uint8),
                                     base=0, bs=n, level=9)
    tail = min(fmt.BLOCK_END_NO_MATCH - 1, n)
    lens[n - tail:] = 1
    dists[n - tail:] = 0
    native.estimate_costs(lens, dists)
    return lens, dists


def _check(data: bytes):
    lens, dists = _parse(data)
    want = native.emit_block(data, lens, dists)
    out, n_out = emit.emit_block_device(
        jnp.asarray(np.frombuffer(data, np.uint8)),
        jnp.asarray(lens), jnp.asarray(dists))
    got = np.asarray(out)[: int(n_out)].tobytes()
    assert got == want, (
        f"{len(got)} vs {len(want)} bytes; first diff at "
        f"{next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), -1)}")
    # and the payload actually decodes back to the block
    assert native.decode_block(got) == data


def test_text():
    _check((b"the quick brown fox jumps over the lazy dog. " * 40)[:1500])


def test_random_all_literals():
    rng = np.random.default_rng(0)
    _check(rng.integers(0, 256, 2000, dtype=np.uint8).tobytes())


def test_long_literal_runs_extension_chains():
    """Literal counts >= 15 and >= 270 produce 255-chained extension
    bytes in the token's A segment."""
    rng = np.random.default_rng(1)
    _check(rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
           + b"needle" * 8
           + rng.integers(0, 256, 300, dtype=np.uint8).tobytes())


def test_long_matches_extension_chains():
    """Match lengths with ml_code >= 15 (and >= 270) chain in B."""
    _check(b"x" * 1200 + b"suffix data" * 4)
    _check(b"Q" * (fmt.MAX_SAME_LETTER + 2000) + b"tail" * 6)


def test_adjacent_matches_zero_literals():
    data = (b"abcdefgh" * 64) + (b"12345678" * 32)
    _check(data)


def test_mixed():
    rng = np.random.default_rng(5)
    frag = bytearray(rng.integers(97, 103, 90, dtype=np.uint8).tobytes())
    parts = []
    while sum(map(len, parts)) < 5000:
        frag[int(rng.integers(0, len(frag)))] ^= 1
        parts.append(bytes(frag))
        if rng.random() < 0.3:
            parts.append(rng.integers(0, 256, 150, dtype=np.uint8).tobytes())
        if rng.random() < 0.3:
            parts.append(bytes([int(rng.integers(97, 100))]) * 60)
    _check(b"".join(parts)[:5000])


def test_tiny_blocks():
    for data in (b"a" * 16, b"abcdabcdabcdabcdabcd", b"0123456789abcdef"):
        _check(data)


def test_device_resident_encode_roundtrip():
    """match -> device DP -> device emit, end-to-end on the CPU backend:
    valid -9-class stream, only compressed bytes cross d2h."""
    from smallz4_tpu.ops import chunkmatch, pipeline
    from smallz4_tpu.utils.profiling import RunReport

    C = 1024
    saved = (chunkmatch.CHUNK, chunkmatch.GROUP, chunkmatch.HEAD_CAP)
    chunkmatch.CHUNK, chunkmatch.GROUP, chunkmatch.HEAD_CAP = C, 1, C
    try:
        rng = np.random.default_rng(9)
        parts = []
        while sum(map(len, parts)) < 5 * C:
            parts.append(rng.integers(97, 104, 300, dtype=np.uint8).tobytes())
            if parts and rng.random() < 0.5:
                parts.append(parts[int(rng.integers(0, len(parts)))])
        data = b"".join(parts)[: 4 * C + 500]
        rep = RunReport(operation="encode", engine="tpu-device-resident")
        frame = pipeline.compress_device_resident(
            data, block_size=2 * C, report=rep)
        assert native.decompress(frame) == data
        # the point of the mode: compressed bytes cross the link, not
        # claims — d2h stays well below 1 byte per input byte
        assert rep.counters["n_d2h_bytes"] < len(data)
        # sane ratio: at the toy chunk size the match window covers only
        # 2*C of the 64 KB the reference sees, so claims are genuinely
        # weaker here — production CHUNK covers the full window
        want = native.compress(data, 9, block_size=2 * C)
        assert len(frame) <= int(len(want) * 1.30) + 64
    finally:
        (chunkmatch.CHUNK, chunkmatch.GROUP, chunkmatch.HEAD_CAP) = saved


def test_device_resident_dp_fallback(monkeypatch):
    """A non-converged device DP must fall back to the host DP for the
    block and still produce a valid stream (the documented safety net)."""
    import jax.numpy as jnp

    from smallz4_tpu.ops import chunkmatch, pipeline

    C = 1024
    saved = (chunkmatch.CHUNK, chunkmatch.GROUP, chunkmatch.HEAD_CAP)
    chunkmatch.CHUNK, chunkmatch.GROUP, chunkmatch.HEAD_CAP = C, 1, C
    real = pipeline._device_resident_block_step

    def fake(*a, **k):
        halo, payload, n_out, _ok = real(*a, **k)
        return halo, payload, n_out, jnp.bool_(False)

    monkeypatch.setattr(pipeline, "_device_resident_block_step", fake)
    try:
        data = (b"fallback path data " * 120)[: 2 * C]
        frame = pipeline.compress_device_resident(data, block_size=2 * C)
        assert native.decompress(frame) == data
    finally:
        (chunkmatch.CHUNK, chunkmatch.GROUP, chunkmatch.HEAD_CAP) = saved
