#!/usr/bin/env python
"""Benchmark: end-to-end 1080p 4:2:0 decode throughput on one chip.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "frames/s/chip", "vs_baseline": N}

vs_baseline is the ratio against the reference C++ decoder
(fxslava/tiny_mp2v_dec, SSE2 build, all host cores) measured on the SAME
stream by tools/bench_reference.py and recorded in BASELINE_MEASURED.json.
A value of 0 means no reference measurement is recorded.

Stream: synthetic but realistic 1080p 4:2:0 IBBP GOPs (tools/bench_stream.py,
seeded, cached in .bench_cache/).  Timing excludes stream generation and
first-use compilation, includes host tokenize + device reconstruction +
display reordering (device-resident delivery; host delivery is the secondary
line, matching the reference's file-output-off timing advice, README.md:48).
"""
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "tests"))
sys.path.insert(0, os.path.join(_HERE, "tools"))
sys.path.insert(0, _HERE)

from bench_stream import make_bench_stream  # noqa: E402

N_PICTURES = 64
WARMUP = 2
REPEATS = 24


def baseline_fps() -> float:
    """Reference C++ decoder fps on the same stream, as recorded by
    tools/bench_reference.py into BASELINE_MEASURED.json."""
    path = os.path.join(_HERE, "BASELINE_MEASURED.json")
    if not os.path.exists(path):
        return 0.0
    with open(path) as f:
        return float(json.load(f).get("fps", 0.0))


def precompile_chunk_variants(dec, data) -> None:
    """Compile the distinct GOP-chunk shape variants CONCURRENTLY (XLA
    compilation releases the GIL, so the variants compile in parallel)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from tiny_mp2v_dec_tpu.ops.recon import _ladder

    toks = dec.tokenize_stream(data)
    dec.reset()
    geom = toks[0][1]
    chunk = dec.config.gop_chunk
    variants = set()
    for i in range(0, len(toks), chunk):
        group = toks[i:i + chunk]
        total_k = sum(t.n_coded_blocks for t, _, _ in group)
        total_nz = sum(int(np.count_nonzero(t.cblk[:t.n_coded_blocks]))
                       for t, _, _ in group)
        variants.add((_ladder(total_nz + 1, lo=4096), _ladder(total_k + 1)))
    recon = dec._gop_recon_for(geom, False)

    with ThreadPoolExecutor(max_workers=max(len(variants), 1)) as ex:
        list(ex.map(lambda key: recon.ensure_compiled(*key),
                    sorted(variants)))


def main() -> int:
    data = make_bench_stream(N_PICTURES, os.path.join(_HERE, ".bench_cache"))

    import jax
    from tiny_mp2v_dec_tpu import DecoderConfig, MP2VDecoder
    from tiny_mp2v_dec_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    # Decode throughput with frames materialized on device (the reference's
    # README likewise times with file output disabled, README.md:48; host
    # delivery is a separate line below).
    # pictures_pool_size=0: frames stay device-resident and unconsumed in
    # this measurement, and the default pool (10) is SMALLER than the
    # 16-picture chunk — _emit's back-pressure then blocks the dispatch
    # thread on its OWN chunk's completion while routing frames 11..16,
    # serializing every chunk against the next.  In-flight chunk jobs and
    # staging slots still bound device/host memory.
    dec = MP2VDecoder(DecoderConfig(gop_chunk=16, output_host=False,
                                    pictures_pool_size=0))

    def run():
        dec.reset()
        frames = dec.decode(data)
        jax.block_until_ready([f.device_buffer() for f in frames])
        return frames

    precompile_chunk_variants(dec, data)
    for _ in range(WARMUP):
        frames = run()

    best = float("inf")
    n_frames = 0
    reps_s = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        frames = run()
        reps_s.append(time.perf_counter() - t0)
        best = min(best, reps_s[-1])
        n_frames = len(frames)
    fps = n_frames / best

    stats = dec.stats
    pics = max(stats["pictures"], 1)
    print(f"# best of {REPEATS}: {n_frames} frames in {best:.3f}s | per-pic: "
          f"tokenize {stats['tokenize_s']/pics*1e3:.2f} ms, "
          f"fill {stats['fill_s']/pics*1e3:.2f} ms, "
          f"device {stats['device_s']/pics*1e3:.2f} ms",
          file=sys.stderr)

    # chip capacity: TWO concurrent streams on the one chip (they share
    # the process-wide compiled recons; the per-instance staging locks
    # interleave their chunks, keeping the device busy while the other
    # stream's host stages run).  Headline stays single-stream to match
    # how BASELINE_MEASURED.json was taken; this line documents serving
    # throughput per chip.
    from concurrent.futures import ThreadPoolExecutor as _TPE
    dec2 = [MP2VDecoder(DecoderConfig(gop_chunk=16, output_host=False,
                                      pictures_pool_size=0))
            for _ in range(2)]

    def run_one(d):
        d.reset()
        fr = d.decode(data)
        jax.block_until_ready([f.device_buffer() for f in fr])
        return len(fr)

    with _TPE(max_workers=2) as ex:
        list(ex.map(run_one, dec2))          # warm
        best2 = float("inf")
        for _ in range(4):
            t0 = time.perf_counter()
            n2 = sum(ex.map(run_one, dec2))
            best2 = min(best2, time.perf_counter() - t0)
    agg_fps = n2 / best2
    print(f"# chip-capacity: {agg_fps:.2f} frames/s (2 concurrent streams)",
          file=sys.stderr)

    # per-picture latency, gop_chunk=0 (the reference's stated goal is
    # ultra low latency, README.md:5): every frame is dispatched and
    # waited for individually
    lat_data = make_bench_stream(8, os.path.join(_HERE, ".bench_cache"))
    decl = MP2VDecoder(DecoderConfig(gop_chunk=0, output_host=False,
                                     reordering=False))
    waited = []

    def _block(frame):
        t = time.perf_counter()
        jax.block_until_ready(frame.device_buffer())
        waited.append(time.perf_counter() - t)
    decl.renderer = _block
    decl.decode(lat_data)          # warm compiles
    # join outstanding background exact-bucket compiles: compilation
    # contending with execution would pollute the timed region
    from tiny_mp2v_dec_tpu.ops.recon import _GOP_RECONS
    for r in _GOP_RECONS.values():
        r.quiesce()
    decl.reset()
    decl.decode(lat_data)          # second warm: all buckets now exact
    decl.reset()
    t0 = time.perf_counter()
    fr = decl.decode(lat_data)
    lat_ms = (time.perf_counter() - t0) / max(len(fr), 1) * 1e3
    print(f"# latency: {lat_ms:.2f} ms/frame (per-picture path, 1080p)",
          file=sys.stderr)

    # secondary: full host delivery, measured on a 16-frame slice
    data16 = make_bench_stream(16, os.path.join(_HERE, ".bench_cache"))
    dech = MP2VDecoder(DecoderConfig(gop_chunk=16, output_host=True))
    dech.decode(data16)
    dech.reset()
    t0 = time.perf_counter()
    fr = dech.decode(data16)
    host_fps = len(fr) / (time.perf_counter() - t0)
    print(f"# host-delivery: {host_fps:.2f} frames/s", file=sys.stderr)

    base = baseline_fps()
    vs = fps / base if base > 0 else 0.0
    print(json.dumps({
        "metric": "1080p_420_decode_throughput",
        "value": round(fps, 2),
        "unit": "frames/s/chip",
        "vs_baseline": round(vs, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
