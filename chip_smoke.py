"""Smoke run of the level-9 device encode path on one GPU.

    python chip_smoke.py           # phases 1-5 on one card
    python chip_smoke.py --four    # only the four-card path and its check

Phases (one process; any failure propagates and exits non-zero):

  1. device   platform, device_kind, count and the card's name and power
              limit; the native host runtime must be built (no fallback)
  2. kernels  one 4 MB match_chunks group at full width (CHUNK 65536,
              GROUP 64, HEAD_CAP 32768): compile seconds and memory
              analysis; sort_chunk and the pair merge against numpy lexsort;
              every probe_pair claim byte-verified; every certified
              position equal to the exact native matcher
  3. encode   compress(x, 9, engine="tpu") on the committed real fixture,
              the seeded mix and the seeded adversarial corpus, byte-equal
              to native.compress(x, 9) and round-tripped; legacy,
              dictionary, 1 MB blocks (walk kernel) and the CLI entry
  4. decode   decompress(engine="tpu") of every frame, decompress_batch of
              8 frames, compress_device_resident round trip, device DP
              against native.estimate_costs
  5. gpu tests  every gpu-marked test (tests/, slow ones included), in this
              process through pytest; all must pass, none may skip
  --four      pipeline.compress over 4 local devices (all must get blocks),
              compress_sharded_chunks and compress_sharded over a 4-device
              mesh, each byte-equal to native.compress

The last stdout line is {"ok": true, "device": {...}}.  Times printed are
smoke readings of one run, not benchmark numbers.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import lzma
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

import bench
import smallz4_tpu
from smallz4_tpu import format as fmt
from smallz4_tpu import native
from smallz4_tpu.utils import device
from smallz4_tpu.utils.profiling import RunReport

REPO = pathlib.Path(__file__).resolve().parent


def log(*a):
    print(*a, flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


@contextlib.contextmanager
def no_cpu_assist():
    """Send every block through the device (parity streams are the same
    bytes either way; this makes the device do all of the work)."""
    old = os.environ.get("SMALLZ4_TPU_CPU_ASSIST")
    os.environ["SMALLZ4_TPU_CPU_ASSIST"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["SMALLZ4_TPU_CPU_ASSIST"]
        else:
            os.environ["SMALLZ4_TPU_CPU_ASSIST"] = old


def real_fixture() -> bytes:
    data = lzma.decompress((REPO / "benchdata" / "realcorpus.bin.xz").read_bytes())
    check(hashlib.sha256(data).hexdigest() == bench.REAL_FIXTURE_SHA256,
          "committed real fixture sha256")
    return data


def phase_device(want_count: int) -> dict:
    log("== phase: device")
    info = device.info()
    log(f"  jax: {info}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"  nvidia-smi: {smi}")
    check(info["platform"] == "gpu", "JAX runs on a GPU")
    check(info["count"] >= want_count, f">= {want_count} device(s)")
    check(native.available(), "native host runtime built")
    return info


def phase_kernels(real: bytes) -> None:
    import jax
    import jax.numpy as jnp

    from smallz4_tpu.ops import chunkmatch as cm

    log("== phase: kernels")
    CH, G, CAP = cm.CHUNK, cm.GROUP, cm.HEAD_CAP
    check((CH, G, CAP) == (65536, 64, 32768), "full-width geometry")
    arr = np.frombuffer(real, np.uint8)
    bs = G * CH  # the fixture's first 4 MB block is one group

    # one match_chunks group, compiled at full width
    bufs = np.stack([arr[j * CH : j * CH + CH + cm.LOOK] for j in range(G)])
    cand = np.full(G, CH, np.int32)
    lim = np.array([bs - j * CH - fmt.BLOCK_END_LITERALS for j in range(G)],
                   np.int32)
    args = (cm.empty_halo(chunk=CH), jnp.asarray(bufs), jnp.asarray(cand),
            jnp.asarray(cand), jnp.asarray(lim), jnp.int32(0), jnp.int32(-1))
    t0 = time.perf_counter()
    compiled = cm.match_chunks.lower(
        *args, n_chunks=G, head_cap=CAP, chunk=CH).compile()
    log(f"  match_chunks compile: {time.perf_counter() - t0:.1f} s")
    log(f"  memory_analysis: {compiled.memory_analysis()}")
    _, ys = compiled(*args)
    bits, packed, counts, cbits, kbits = (np.asarray(y) for y in ys)

    # sort_chunk / the pair merge against numpy lexsort (chunk 1, halo 0)
    def lex(planes):
        return np.lexsort(tuple(planes[i] for i in range(5, -1, -1)))

    recs = [np.asarray(p) for p in cm.make_records(
        jnp.asarray(bufs[1]), jnp.int32(0), jnp.int32(CH), chunk=CH)]
    order = lex(recs)
    halo = cm.sort_chunk(jnp.asarray(bufs[0]), jnp.int32(0), jnp.int32(CH),
                         chunk=CH)
    cur = cm.sort_chunk(jnp.asarray(bufs[1]), jnp.int32(0), jnp.int32(CH),
                        chunk=CH)
    check(all((np.asarray(c) == r[order]).all() for c, r in zip(cur, recs)),
          "sort_chunk == numpy lexsort of make_records (65536 records)")
    both = [np.concatenate([np.asarray(h), np.asarray(c)])
            for h, c in zip(halo, cur)]
    both[5][CH:] += np.uint32(CH)  # chunk 1 positions rebase past the halo
    merged = cm._merge_pair(halo, cur, CH)
    order2 = lex(both)
    check(all((np.asarray(m) == b[order2]).all() for m, b in zip(merged, both)),
          "pair merge == numpy lexsort (131072 records)")

    # every probe_pair claim is a byte-verified match
    lens, dists, _, _ = (np.asarray(x) for x in cm.probe_pair(
        halo, cur, jnp.int32(0), jnp.int32(-1), jnp.int32(0), jnp.int32(CH),
        jnp.int32(bs - CH - fmt.BLOCK_END_LITERALS), chunk=CH))
    claims = np.flatnonzero(lens >= fmt.MIN_MATCH)
    bad = 0
    for p in claims:
        s, d, n = CH + int(p), int(dists[p]), int(lens[p])
        bad += not (1 <= d <= fmt.MAX_DISTANCE
                    and real[s - d : s - d + n] == real[s : s + n])
    check(bad == 0 and len(claims) > CH // 4,
          f"all {len(claims)} probe_pair claims byte-verified")

    # certified positions of the whole group == the exact native matcher
    rows = counts <= CAP
    check(rows.sum() >= G - 2, f"head counts fit HEAD_CAP ({rows.sum()}/{G})")
    l_dev, d_dev = cm.unpack_rows(bits, packed, chunk=CH)
    conv = cm.unpack_bits_rows(cbits, CH)
    lk = cm.unpack_bits_rows(kbits, CH)
    el, ed = native.match_block(arr[:bs], base=0, bs=bs, level=9)
    el = np.where(el >= fmt.MIN_MATCH, el, 1).reshape(G, CH)
    ed = np.where(el >= fmt.MIN_MATCH, ed.reshape(G, CH), 0)
    inside = (np.arange(bs) < bs - fmt.BLOCK_END_NO_MATCH).reshape(G, CH)
    inside &= rows[:, None]
    cv, kk = conv & inside, lk & inside
    check((l_dev[cv] == el[cv]).all() and (d_dev[cv] == ed[cv]).all(),
          f"{cv.sum()} conv positions == native length and distance")
    check((l_dev[kk] == el[kk]).all(),
          f"{kk.sum()} lk positions == native length "
          f"(refine share {100 * (1 - kk.sum() / inside.sum()):.2f} %)")
    jax.clear_caches()


def encode_reading(name: str, x: bytes, want: bytes) -> None:
    from smallz4_tpu.ops import pipeline

    with no_cpu_assist():
        # the first device-only run compiles what the default run left to
        # the host (the halo sort of blocks after the first); read the second
        for _ in range(2):
            rep = RunReport(operation="encode", engine="tpu")
            t0 = time.perf_counter()
            got = pipeline.compress(x, 9, report=rep)
            wall = time.perf_counter() - t0
            check(got == want, f"{name}: device-only run byte-equal native")
    npos = rep.counters.get("n_positions", 0)
    check(npos == len(x), f"{name}: every position searched on the device")
    refine = 100.0 * rep.counters.get("n_refine_positions", 0) / npos
    stages = {k: round(v, 3) for k, v in rep.stages.items()}
    log(f"  smoke reading (one warm run, not a benchmark) {name}: "
        f"{wall:.2f} s, {len(x) / wall / 1e6:.2f} MB/s, refine "
        f"{refine:.2f} %, stages {stages}")


def phase_encode(real: bytes) -> dict:
    from smallz4_tpu import cli

    log("== phase: encode")
    corpora = {"realcorpus": real,
               "mix": bench.make_corpus(10_000_000),
               "adversarial": bench.make_adversarial()}
    frames = {}
    for name, x in corpora.items():
        want = native.compress(x, 9)
        t0 = time.perf_counter()
        got = smallz4_tpu.compress(x, 9, engine="tpu")
        wall = time.perf_counter() - t0
        check(got == want, f"{name}: compress(engine='tpu') byte-equal "
              f"native.compress ({len(x)} B -> {len(got)} B, first run "
              f"{wall:.1f} s incl. compile)")
        check(native.decompress(got) == x, f"{name}: round trip")
        encode_reading(name, x, want)
        frames[name] = (got, x, None)

    mix = corpora["mix"]
    with no_cpu_assist():
        got = smallz4_tpu.compress(mix, 9, legacy=True, engine="tpu")
        check(got == native.compress(mix, 9, legacy=True),
              "legacy frame byte-equal native")
        frames["legacy"] = (got, mix, None)

        dct, x = real[:65536], real[65536 : 65536 + (5 << 20)]
        got = smallz4_tpu.compress(x, 9, dictionary=dct, engine="tpu")
        check(got == native.compress(x, 9, dictionary=dct),
              "dictionary frame byte-equal native")
        frames["dictionary"] = (got, x, dct)

        x = mix[: 3 << 20]
        got = smallz4_tpu.compress(x, 9, block_size=1 << 20, engine="tpu")
        check(got == native.compress(x, 9, block_size=1 << 20),
              "1 MB blocks (walk kernel) byte-equal native")
        frames["1MB-blocks"] = (got, x, None)

        x = real[: 5 << 20]
        with tempfile.TemporaryDirectory() as td:
            src, dst = os.path.join(td, "in.bin"), os.path.join(td, "out.lz4")
            pathlib.Path(src).write_bytes(x)
            rc = cli.main(["-9", "--engine=tpu", src, dst])
            got = pathlib.Path(dst).read_bytes()
        check(rc == 0 and got == native.compress(x, 9),
              "CLI --engine=tpu byte-equal native")
    return frames


def phase_decode(frames: dict, mix: bytes) -> None:
    import jax.numpy as jnp

    from smallz4_tpu.ops import parse, pipeline

    log("== phase: decode")
    for name, (frame, x, dct) in frames.items():
        check(smallz4_tpu.decompress(frame, dictionary=dct, engine="tpu") == x,
              f"decompress(engine='tpu') {name}")
    pieces = [mix[i << 20 : (i + 1) << 20] for i in range(8)]
    got = smallz4_tpu.decompress_batch([native.compress(p, 9) for p in pieces],
                                       engine="tpu")
    check(got == pieces, "decompress_batch of 8 frames")
    x = mix[: 2 << 20]
    check(native.decompress(pipeline.compress_device_resident(x)) == x,
          "compress_device_resident round trip (2 MB)")
    nb = 1 << 20
    lens, dists = native.match_block(np.frombuffer(mix[:nb], np.uint8),
                                     base=0, bs=nb, level=9)
    lens[nb - 11 :] = 1
    dists[nb - 11 :] = 0
    choice, _cost, ok = parse.estimate_costs_device(
        jnp.asarray(lens), jnp.asarray(dists), nb)
    want = lens.copy()
    native.estimate_costs(want, dists)
    check(bool(ok) and (np.asarray(choice) == want).all(),
          "estimate_costs_device == native.estimate_costs (1 MB)")


def phase_four() -> None:
    import jax

    from smallz4_tpu.ops import chunkmatch as cm
    from smallz4_tpu.ops import pipeline
    from smallz4_tpu.parallel import sharding

    log("== phase: four devices")
    mix = bench.make_corpus(32 << 20)
    seen = []
    match_chunks = cm.match_chunks

    def recording(halo, bufs, *a, **k):
        seen.append(next(iter(bufs.devices())).id)
        return match_chunks(halo, bufs, *a, **k)

    cm.match_chunks = recording
    try:
        with no_cpu_assist():
            got = pipeline.compress(mix, 9)
    finally:
        cm.match_chunks = match_chunks
    want = native.compress(mix, 9)
    check(got == want, "pipeline.compress 32 MB over 4 devices byte-equal native")
    check(len(set(seen)) == 4, "all 4 devices got blocks (calls per device "
          f"{dict(collections.Counter(seen))})")

    mesh = sharding.make_mesh(4)
    check(sharding.compress_sharded_chunks(mix, mesh) == want,
          "compress_sharded_chunks 32 MB over make_mesh(4) (two 4 MB groups "
          "a device) byte-equal native")
    x = mix[: 4 << 20]
    check(sharding.compress_sharded(x, mesh, block_size=1 << 20)
          == native.compress(x, 9, block_size=1 << 20),
          "compress_sharded 4 MB (1 MB blocks) over make_mesh(4) byte-equal "
          "native")
    jax.clear_caches()


class _Outcomes:
    """pytest plugin: counts test outcomes (skips come from setup)."""

    def __init__(self):
        self.counts = collections.Counter()

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def phase_gpu_tests() -> None:
    import pytest

    log("== phase: gpu tests")
    # tests/conftest.py defaults JAX_PLATFORMS to the CPU; keep the card
    os.environ["JAX_PLATFORMS"] = "cuda"
    outcomes = _Outcomes()
    rc = pytest.main(["-q", "-s", "-m", "gpu", "-p", "no:cacheprovider",
                      str(REPO / "tests")], plugins=[outcomes])
    counts = dict(outcomes.counts)
    check(rc == 0 and counts.get("passed", 0) >= 2 and set(counts) == {"passed"},
          f"gpu-marked tests pass on the card {counts}")


def main(argv: list[str]) -> int:
    four = "--four" in argv
    info = phase_device(4 if four else 1)
    if four:
        phase_four()
        count = 4
    else:
        real = real_fixture()
        phase_kernels(real)
        frames = phase_encode(real)
        phase_decode(frames, frames["mix"][1])
        phase_gpu_tests()
        count = info["count"]
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"], "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
