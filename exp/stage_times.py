"""Device time of each chunk-matcher stage for one 4 MB group on the GPU.

    python exp/stage_times.py [--out chiprun_out/stage_times.json]

Times each stage of match_chunks (sort, merge, probe, unsort, certify,
compact, pack) as its own jitted batched call over GROUP chunks of the
committed real fixture, both on the host clock (block_until_ready, median
of reps) and as summed device-event time per XLA module from a
jax.profiler trace, and the whole batched match_chunks group beside
them.  Needs a GPU; fails elsewhere.
"""
from __future__ import annotations

import argparse
import collections
import functools
import glob
import json
import lzma
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from smallz4_tpu import format as fmt  # noqa: E402
from smallz4_tpu.ops import chunkmatch as cm  # noqa: E402
from smallz4_tpu.utils import device  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
REPS = 20


def host_time(fn, *args):
    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3, min(ts) * 1e3


def device_times(trace_dir, reps):
    """Summed device-event durations per XLA module from the trace (ms
    per call), and the most frequent (line, module) pairs."""
    from jax.profiler import ProfileData

    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    pd = ProfileData.from_file(path)
    per_module = collections.defaultdict(float)
    names = collections.Counter()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                mod = stats.get("hlo_module") or stats.get("hlo_module_name")
                per_module[str(mod)] += ev.duration_ns / 1e6 / reps
                names[(line.name, str(mod))] += 1
    return dict(per_module), [f"{k}: {v}" for k, v in names.most_common(40)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "stage_times.json"))
    args = ap.parse_args()
    info = device.info()
    if info["platform"] != "gpu":
        raise SystemExit(f"needs a GPU (JAX runs on {info['platform']})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device {info}; nvidia-smi: {smi}", flush=True)

    CH, G, CAP = cm.CHUNK, cm.GROUP, cm.HEAD_CAP
    real = lzma.decompress((REPO / "benchdata" / "realcorpus.bin.xz").read_bytes())
    arr = np.frombuffer(real, np.uint8)
    bs = G * CH
    bufs = jnp.asarray(np.stack([arr[j * CH : j * CH + CH + cm.LOOK]
                                 for j in range(G)]))
    cand = jnp.full(G, CH, jnp.int32)
    lim = jnp.asarray([bs - j * CH - fmt.BLOCK_END_LITERALS for j in range(G)],
                      jnp.int32)
    halo0 = cm.empty_halo(chunk=CH)
    zero, off = jnp.int32(0), jnp.int32(-1)

    def sort(bufs, cand):
        return jax.vmap(functools.partial(cm.sort_chunk, chunk=CH),
                        in_axes=(0, None, 0))(bufs, zero, cand)

    def merge(halos, curs):
        return jax.vmap(functools.partial(cm._merge_pair, chunk=CH))(halos, curs)

    def probe(planes, ml):
        return jax.vmap(lambda p, m: cm._probe(list(p), zero, off, m, CH))(
            planes, ml)

    def unsort(p_key, p_pay):
        return jax.vmap(functools.partial(cm._place, chunk=CH))(p_key, p_pay)

    def certify(f, l, d, vh, ml):
        return jax.vmap(lambda *a: cm._certify(*a[:3], off, zero, *a[3:], CH))(
            f, l, d, vh, ml)

    def compact(keep, vals):
        return jax.vmap(cm._compact)(keep, vals)

    def pack(lens, dists, conv, lk):
        return jax.vmap(functools.partial(cm.pack_results, chunk=CH))(
            lens, dists, conv, lk)

    def group_batched(*a):
        return cm.match_chunks(*a, n_chunks=G, head_cap=CAP, chunk=CH)

    stage = {f.__name__: jax.jit(f) for f in (
        sort, merge, probe, unsort, certify, compact, pack, group_batched)}
    curs = stage["sort"](bufs, cand)
    halos = tuple(jnp.concatenate([h[None], c[:-1]])
                  for h, c in zip(halo0, curs))
    merged = stage["merge"](halos, curs)
    m32 = tuple(m.view(jnp.int32) for m in merged)
    p_pay, p_key = stage["probe"](m32, lim)
    flags0, lens0, dists0 = stage["unsort"](p_key, p_pay)
    claims = stage["certify"](flags0, lens0, dists0, cand, lim)
    heads = jnp.asarray(np.random.default_rng(0).random((G, CH)) < 0.3)
    gargs = (halo0, bufs, cand, cand, lim, zero, off)

    calls = {
        "sort": (bufs, cand),
        "merge": (halos, curs),
        "probe": (m32, lim),
        "unsort": (p_key, p_pay),
        "certify": (flags0, lens0, dists0, cand, lim),
        "compact": (heads, lens0),
        "pack": claims,
        "group_batched": gargs,
    }
    calls = {k: (stage[k], a) for k, a in calls.items()}
    res = {"device": info, "nvidia_smi": smi, "host_ms": {}}
    for name, (fn, a) in calls.items():
        med, best = host_time(fn, *a)
        res["host_ms"][name] = {"median": med, "min": best}
        print(f"{name:16s} host median {med:9.3f} ms  min {best:9.3f} ms",
              flush=True)

    with tempfile.TemporaryDirectory() as td:
        trace_reps = 3
        with jax.profiler.trace(td):
            for name, (fn, a) in calls.items():
                with jax.profiler.TraceAnnotation(name):
                    for _ in range(trace_reps):
                        jax.block_until_ready(fn(*a))
        try:
            per_module, top = device_times(td, trace_reps)
            res["device_ms_per_module"] = per_module
            res["trace_lines"] = top
            for k, ms in sorted(per_module.items(), key=lambda kv: -kv[1]):
                print(f"device {ms:9.3f} ms  {k}", flush=True)
            print("trace lines (line, module): events", *top[:15],
                  sep="\n  ", flush=True)
        except Exception as e:  # the host-clock numbers above still stand
            res["trace_error"] = repr(e)
            print(f"trace reduction failed: {e!r}", flush=True)
    mem = jax.devices()[0].memory_stats() or {}
    res["peak_bytes_in_use"] = mem.get("peak_bytes_in_use")
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"peak_bytes_in_use": res["peak_bytes_in_use"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
