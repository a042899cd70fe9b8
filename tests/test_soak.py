"""Adversarial + scale soak (VERDICT r2 #6): >= 64 MB of mixed hostile
data — giant byte runs (straddling every walk threshold), near-identical
long fragments (deep chains, probe-window overflow), and incompressible
noise — through the production engines under wall-clock ceilings.

This is the net that would have caught the round-2 byte-run interval-skip
non-termination (native/src/tlz4.cpp find_longest, regression a52b318):
that bug passed the whole fast suite because no fixture exceeded a
12,000-byte run.  Budgets are per-engine whole-stream ceilings sized ~10x
above the measured time on an uncontended 2-vCPU host — a >10x per-block
slowdown (the failure mode of an accidentally quadratic walk) blows
straight through them.

All engines must also agree bit-for-bit: the native sequential stream is
the reference-parity-pinned anchor (tests/test_native.py), host-parallel
must equal it exactly, and the device parity engine must as well (on the
card only: the CPU backend's timings say nothing about the engine).
"""
import pathlib
import time

import numpy as np
import pytest

from smallz4_tpu import native
from smallz4_tpu.parallel import host as phost

SOAK_MB = 64
BLOCK = 4 * 1024 * 1024
# text filler: the native runtime's own source, so the corpus needs no
# file from outside the repository
FILLER = pathlib.Path(__file__).resolve().parents[1] / "native" / "src" / "tlz4.cpp"


def _adversarial_corpus(total: int) -> bytes:
    """Giant runs + near-identical >=32-byte fragments + random, mixed."""
    rng = np.random.default_rng(7)
    parts = []
    # near-identical fragments: 48-byte template with sparse perturbations
    # (every occurrence is a >=32-byte match candidate for every other ->
    # maximal chain depth, probe-group overflow on the device)
    frag = bytearray(rng.integers(97, 105, 48, dtype=np.uint8).tobytes())
    run_lengths = [65298, 65300, 65536, 65560, 131000, 262144, 1 << 20]
    ri = 0
    size = 0
    while size < total:
        r = rng.random()
        if r < 0.25:  # giant equal-byte run around the walk thresholds
            rl = run_lengths[ri % len(run_lengths)]
            ri += 1
            parts.append(bytes([ri & 0xFF]) * rl)
        elif r < 0.7:  # burst of near-identical fragments
            burst = []
            for _ in range(int(rng.integers(50, 400))):
                if rng.random() < 0.2:
                    frag[int(rng.integers(0, len(frag)))] ^= 1
                burst.append(bytes(frag))
            parts.append(b"".join(burst))
        elif r < 0.85:  # incompressible noise
            parts.append(rng.integers(0, 256, int(rng.integers(2000, 60000)),
                                      dtype=np.uint8).tobytes())
        else:  # plain text-ish filler
            parts.append(FILLER.read_bytes())
        size += len(parts[-1])
    return b"".join(parts)[:total]


@pytest.fixture(scope="module")
def soak_data():
    return _adversarial_corpus(SOAK_MB << 20)


def _budget(label, budget_s, fn, *args, **kw):
    t0 = time.monotonic()
    out = fn(*args, **kw)
    dt = time.monotonic() - t0
    assert dt < budget_s, (
        f"{label}: {dt:.1f}s exceeded the {budget_s:.0f}s soak ceiling "
        f"(>10x regression on some block — adversarial non-termination?)")
    return out


@pytest.mark.slow
def test_soak_native_sequential(soak_data):
    # measured ~25 s uncontended (2.6 MB/s on the hostile mix); ceiling 10x
    frame = _budget("native -9", 250, native.compress, soak_data, 9,
                    block_size=BLOCK)
    assert native.decompress(frame) == soak_data
    # greedy/lazy levels walk far less; one pass each under a tight lid
    for level in (1, 4):
        f = _budget(f"native -{level}", 120, native.compress, soak_data,
                    level, block_size=BLOCK)
        assert native.decompress(f) == soak_data


@pytest.mark.slow
def test_soak_host_parallel_bit_equal(soak_data):
    seq = native.compress(soak_data, 9, block_size=BLOCK)
    par = _budget("host-parallel -9", 250, phost.compress, soak_data, 9,
                  block_size=BLOCK)
    assert par == seq


@pytest.mark.slow
@pytest.mark.gpu
def test_soak_tpu_parity_bit_equal(soak_data, gpu):
    from smallz4_tpu.ops import pipeline

    seq = native.compress(soak_data, 9, block_size=BLOCK)
    got = _budget("tpu parity -9", 400, pipeline.compress, soak_data, 9,
                  parity=True, block_size=BLOCK)
    assert got == seq
