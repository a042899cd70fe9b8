"""Long byte-run regressions (round-2 showstopper, VERDICT r2 #1).

The native matcher's byte-run interval skip (native/src/tlz4.cpp
find_longest) snaps chain hops to the run head.  When an equal-byte run
exceeds the 64 KiB window (reference semantics: MaxDistance=65535,
smallz4.h:111) the head's ring slot is stale and an unguarded snap cycles
forever.  These tests pin the fixed behavior: every engine terminates
within a wall-clock budget on runs that straddle the window / ring / run
shortcut thresholds (MaxSameLetter = 19 + 255*256 = 65,299,
smallz4.h:137), at run-start / mid-block / block-straddling placements,
and the output stays bit-identical to the sequential native engine (which
is itself reference-parity-pinned in test_native.py and, for the long-run
matrix, in the slow-marked test below).
"""
import os
import time

import numpy as np
import pytest

import smallz4_tpu
from smallz4_tpu import native
from smallz4_tpu.parallel import host as phost

# run lengths around every threshold the walk cares about:
# MaxSameLetter-1 / +1, the ring size, ring+delta, >window, 2x window, 4x
RUN_LENGTHS = [65298, 65300, 65536, 65560, 131000, 262144]

# per-case wall budget: the fixed engine does each of these in well under
# a second; the pre-fix build never returns (and the reference takes ~10 s)
WALL_BUDGET = 30.0


def _src(nbytes: int) -> bytes:
    with open("/root/reference/smallz4.h", "rb") as f:
        return f.read()[:nbytes]


def _cases(runlen: int):
    src = _src(54000)
    return {
        "run-start": b"\0" * runlen + src,
        "mid-block": src + b"\0" * runlen + src[:5000],
        # 97 KB prefix puts the run across the first 128 KB block boundary
        # when block_size=131072 (straddling case below)
        "straddle": src + src[:43000] + b"\xee" * runlen + src[:5000],
    }


def _budget(fn, *args, **kw):
    t0 = time.monotonic()
    out = fn(*args, **kw)
    dt = time.monotonic() - t0
    assert dt < WALL_BUDGET, f"{fn} took {dt:.1f}s (> {WALL_BUDGET}s budget)"
    return out


@pytest.mark.parametrize("runlen", RUN_LENGTHS)
def test_native_all_levels_terminate_and_roundtrip(runlen):
    for name, data in _cases(runlen).items():
        for level in (1, 4, 7, 9):
            frame = _budget(native.compress, data, level)
            assert native.decompress(frame) == data, (name, level)


@pytest.mark.parametrize("runlen", [65300, 66000, 131000])
def test_native_block_straddling_runs(runlen):
    """A block boundary inside the run (the boundary chain-cut + barrier
    interplay with the interval skip)."""
    data = _cases(runlen)["straddle"]
    for level in (7, 9):
        frame = _budget(native.compress, data, level, block_size=131072)
        assert native.decompress(frame) == data


@pytest.mark.parametrize("runlen", [65300, 66000, 131000])
def test_host_parallel_matches_native(runlen):
    for name, data in _cases(runlen).items():
        seq = native.compress(data, 9, block_size=131072)
        par = _budget(phost.compress, data, 9, block_size=131072, threads=4)
        assert par == seq, name


@pytest.mark.parametrize("runlen", [65300, 66000, 131000])
def test_tpu_parity_engine_matches_native(runlen):
    from smallz4_tpu.ops import pipeline

    data = _cases(runlen)["mid-block"]
    seq = native.compress(data, 9)
    got = _budget(pipeline.compress, data, 9, parity=True, kernel="walk")
    assert got == seq


@pytest.mark.parametrize("runlen", [66000, 131000])
def test_sharded_matches_native(runlen):
    from smallz4_tpu.parallel import sharding

    data = _cases(runlen)["mid-block"]
    seq = native.compress(data, 9, block_size=131072)
    got = _budget(sharding.compress_sharded, data, block_size=131072,
                  parity=True)
    assert got == seq


@pytest.mark.slow
@pytest.mark.parametrize("runlen", RUN_LENGTHS)
def test_reference_bit_parity_long_runs(runlen, reference):
    """Bit parity with the live reference binary on the long-run matrix
    (slow: the reference itself needs ~10 s per level-7/9 case)."""
    for name, data in _cases(runlen).items():
        for level in (1, 4, 7, 9):
            assert native.compress(data, level) == reference.compress(
                data, level), (name, level)


@pytest.mark.slow
def test_adversarial_soak_64mb():
    """Scale soak (VERDICT r2 #6): >= 64 MB of mixed adversarial data —
    giant runs, near-identical long fragments, random noise — through the
    native and host-parallel engines with per-block wall ceilings.  A
    >10x per-block slowdown vs the corpus median fails it."""
    rng = np.random.default_rng(7)
    src = _src(200000)
    frag = bytearray(src[:40000])
    parts = []
    total = 0
    while total < 64 * (1 << 20):
        kind = rng.integers(0, 4)
        if kind == 0:
            parts.append(b"\0" * int(rng.integers(60000, 300000)))
        elif kind == 1:
            # near-identical 32-byte+ fragments: worst case for probe
            # windows and chain walks
            frag[int(rng.integers(0, len(frag)))] ^= 1
            parts.append(bytes(frag))
        elif kind == 2:
            parts.append(src)
        else:
            parts.append(rng.integers(0, 256, int(rng.integers(5000, 50000)),
                                      dtype=np.uint8).tobytes())
        total += len(parts[-1])
    data = b"".join(parts)
    bs = 1 << 22
    blocks = [data[i : i + bs] for i in range(0, len(data), bs)]
    times = []
    out = bytearray()
    for blk in blocks:
        t0 = time.monotonic()
        native.compress(blk, 9)
        times.append(time.monotonic() - t0)
    med = sorted(times)[len(times) // 2]
    worst = max(times)
    assert worst <= max(10 * med, 5.0), (
        f"per-block outlier: worst {worst:.2f}s vs median {med:.2f}s")
    # whole-stream engines terminate within budget and agree
    t0 = time.monotonic()
    seq = native.compress(data, 9)
    t_seq = time.monotonic() - t0
    assert t_seq < 120, f"sequential soak took {t_seq:.0f}s"
    par = phost.compress(data, 9, threads=4)
    assert par == seq
    assert native.decompress(seq) == data


def test_encoder_fuzz_structured_runs():
    """Encoder fuzz: seeded random mixes of text, runs (short / threshold /
    giant), and noise, all levels, wall-budgeted, round-trip + parallel
    equality.  This is the net that catches walk non-termination."""
    rng = np.random.default_rng(0xC0FFEE)
    src = _src(120000)
    for case in range(6):
        parts = []
        for _ in range(rng.integers(2, 6)):
            kind = rng.integers(0, 4)
            if kind == 0:  # text fragment
                a = int(rng.integers(0, len(src) - 30000))
                parts.append(src[a : a + int(rng.integers(500, 30000))])
            elif kind == 1:  # run near a threshold
                base = int(rng.choice([255, 65298, 65299, 65300, 65536]))
                n = base + int(rng.integers(-2, 3))
                parts.append(bytes([int(rng.integers(0, 3))]) * n)
            elif kind == 2:  # giant run
                parts.append(b"\0" * int(rng.integers(65537, 180000)))
            else:  # noise
                parts.append(rng.integers(0, 256,
                                          int(rng.integers(100, 4000)),
                                          dtype=np.uint8).tobytes())
        data = b"".join(parts)
        for level in (1, 5, 9):
            frame = _budget(native.compress, data, level)
            assert native.decompress(frame) == data, (case, level)
        par = _budget(phost.compress, data, 9, threads=4)
        assert par == native.compress(data, 9), case
