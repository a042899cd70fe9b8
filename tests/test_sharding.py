"""Multi-chip layer tests on the virtual 8-device CPU mesh
(SURVEY.md §4: xla_force_host_platform_device_count)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from smallz4_tpu import native, oracle
from smallz4_tpu.parallel import sharding


@pytest.fixture(scope="module", autouse=True)
def _need(request):
    if not native.available():
        pytest.skip("native runtime not built")
    if len(jax.devices()) < 2:
        pytest.skip("virtual multi-device CPU mesh unavailable")


def test_mesh_has_eight_virtual_devices():
    assert len(jax.devices()) == 8


def _corpus(n: int) -> bytes:
    rng = np.random.default_rng(9)
    out = bytearray()
    words = [b"alpha", b"beta", b"gamma", b"delta", b"shard", b"halo"]
    while len(out) < n:
        out += b" ".join(words[i] for i in rng.integers(0, len(words), 8)) + b". "
        if len(out) % 5 == 0:
            out += rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    return bytes(out[:n])


def test_sharded_compress_roundtrip_and_parity():
    # 6 blocks of 128 KiB over 8 devices; parity mode must equal the
    # sequential native -9 stream bit-for-bit (128 KiB >= the 64 KB+12
    # lookback threshold, so boundary semantics match the sequential path)
    data = _corpus(6 * 131072 + 12345)
    mesh = sharding.make_mesh(8)
    frame = sharding.compress_sharded(data, mesh, block_size=131072,
                                      max_candidates=8, parity=True)
    want = native.compress(data, 9, block_size=131072)
    assert frame == want
    assert native.decompress(frame) == data


def test_sharded_turbo_roundtrip():
    data = _corpus(3 * 131072)
    mesh = sharding.make_mesh(4)
    frame = sharding.compress_sharded(data, mesh, block_size=131072,
                                      max_candidates=8)
    assert oracle.decompress(frame) == data


def test_sharded_rejects_small_blocks():
    with pytest.raises(ValueError):
        sharding.compress_sharded(b"x" * 100, block_size=1024)


def test_graft_entry_single_chip():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    lens, dists, conv = jax.jit(fn)(*args)
    assert lens.shape == args[0].shape


def test_graft_entry_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


@pytest.fixture()
def _tiny_chunks(monkeypatch):
    """Shrink the chunk engine for CPU mesh runs (same scale
    contract as tests/test_chunkmatch.py: parity only holds while every
    window candidate fits in (halo chunk, current chunk))."""
    from smallz4_tpu.ops import chunkmatch

    monkeypatch.setattr(chunkmatch, "CHUNK", 1024)
    monkeypatch.setattr(chunkmatch, "GROUP", 1)
    monkeypatch.setattr(chunkmatch, "HEAD_CAP", 1024)


def test_sharded_chunk_engine_parity(_tiny_chunks):
    """The PRODUCTION chunk kernel sharded over the virtual mesh: per-
    device fused scans with the raw-byte halo ppermute must be bit-
    identical to the sequential native -9 stream (VERDICT r2 #4).  Bit
    parity at the test chunk size requires every window candidate inside
    (halo chunk, current chunk) — keep data <= 2 chunks (the _tiny_chunks
    contract); one chunk per device exercises the halo hand-off."""
    C = 1024
    data = _corpus(2 * C)  # ONE block spanning two devices' chunks
    mesh = sharding.make_mesh(2)
    frame = sharding.compress_sharded_chunks(
        data, mesh, block_size=2 * C, parity=True)
    want = native.compress(data, 9, block_size=2 * C)
    assert frame == want
    assert native.decompress(frame) == data


def test_sharded_chunk_engine_8dev_roundtrip(_tiny_chunks):
    """8-device run over many chunks/blocks incl. a partial final chunk
    and padding rows.  Device claims are byte-verified, so the stream
    round-trips at any scale; bit parity needs full-size chunks (the
    certificate's window-coverage premise) and is asserted on the card
    by chip_smoke.py --four."""
    C = 1024
    data = _corpus(16 * C + 300)
    mesh = sharding.make_mesh(8)
    for parity in (False, True):
        frame = sharding.compress_sharded_chunks(
            data, mesh, block_size=2 * C, parity=parity)
        assert native.decompress(frame) == data


@pytest.mark.parametrize("group", [1, 2])
def test_sharded_chunk_engine_group_scan_same_frame(_tiny_chunks, monkeypatch,
                                                    group):
    """Each device's share (3 chunks here) scanned GROUP chunks at a time,
    padded to whole groups when GROUP does not divide it, gives the same
    frame as one batched call over the whole share."""
    from smallz4_tpu.ops import chunkmatch

    C = 1024
    data = _corpus(16 * C + 300)
    mesh = sharding.make_mesh(8)
    monkeypatch.setattr(chunkmatch, "GROUP", 64)
    want = sharding.compress_sharded_chunks(data, mesh, block_size=2 * C,
                                            parity=False)
    monkeypatch.setattr(chunkmatch, "GROUP", group)
    got = sharding.compress_sharded_chunks(data, mesh, block_size=2 * C,
                                           parity=False)
    assert got == want
    assert native.decompress(got) == data


def _step_temp_bytes(n_local, group):
    from smallz4_tpu.ops import chunkmatch

    C = 1024
    step = sharding.sharded_chunk_step(sharding.make_mesh(1), n_local,
                                       chunk=C, head_cap=C, group=group)
    rows = [np.zeros(n_local, np.int32)] * 5
    args = (np.zeros((n_local, C + chunkmatch.LOOK), np.uint8), *rows,
            np.zeros(C + chunkmatch.LOOK, np.uint8), np.int32(C))
    return step.lower(*args).compile().memory_analysis().temp_size_in_bytes


def test_sharded_chunk_step_memory_is_one_group():
    """A device's working memory is one group's, whatever its share of the
    stream: 8x the chunks in 2-chunk groups keeps the temp of one group,
    while one batched call over all of them grows with the share."""
    one = _step_temp_bytes(2, group=2)
    assert _step_temp_bytes(16, group=2) <= 1.25 * one
    assert _step_temp_bytes(16, group=16) >= 4 * one


def test_sharded_chunk_step_rejects_partial_group():
    with pytest.raises(ValueError):
        sharding.sharded_chunk_step(sharding.make_mesh(1), 3, chunk=1024,
                                    head_cap=1024, group=2)


def test_sharded_chunk_engine_dictionary(_tiny_chunks):
    C = 1024
    data = _corpus(C)  # one chunk: the dict halo covers its whole window
    dictionary = data[: C // 2]
    mesh = sharding.make_mesh(2)  # row 2 is a padding chunk
    frame = sharding.compress_sharded_chunks(
        data, mesh, block_size=C, dictionary=dictionary, parity=True)
    want = native.compress(data, 9, block_size=C, dictionary=dictionary)
    assert frame == want
    assert native.decompress(frame, dictionary=dictionary) == data


def test_sharded_dictionary_broadcast():
    # preset dictionary replicated to all shards (BASELINE config[3])
    data = _corpus(2 * 131072)
    dictionary = data[:40000]
    mesh = sharding.make_mesh(4)
    frame = sharding.compress_sharded(data, mesh, block_size=131072,
                                      max_candidates=8,
                                      dictionary=dictionary, parity=True)
    want = native.compress(data, 9, block_size=131072, dictionary=dictionary)
    assert frame == want
    assert native.decompress(frame, dictionary=dictionary) == data
