#!/usr/bin/env python
"""Smoke test on NVIDIA GPUs: decode real MPEG-2 streams through
``MP2VDecoder``'s normal entry points and check every frame bit-exact
against the golden decoder (``tiny_mp2v_dec_tpu.golden``).

Usage (from the repository root, on a machine with a card):

    python chip_smoke.py             # one card: phases 1-8
    python chip_smoke.py --cards 4   # four cards: the multi-card paths only

Phases on one card: (1) device, (2) native host code, (3) chunk mode on the
64-picture 1080p 4:2:0 bench stream, (4) latency mode, (5) field motion at
1080p, (6) 1080p 4:2:2, (7) ``decode_batch`` of four 576-line streams,
(8) informative timings.  Streams are generated from fixed seeds into
``.chip_smoke/`` (git-ignored); the golden decodes run in CPU worker
processes that never touch the card, so one process uses the card.

Any mismatch or error exits non-zero.  The last line of standard output is
one JSON object naming the device, printed only when every phase passed.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.join(_HERE, "tools"), os.path.join(_HERE, "tests"), _HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

DATA_DIR = os.path.join(_HERE, ".chip_smoke")
HD = (120, 68)          # 1920x1088 in macroblocks
SD = (45, 36)           # 720x576 in macroblocks
BENCH_PICTURES = 64
CHUNK = 16


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def result_line(platform: str, kind: str, count: int) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def check_devices(n_cards: int):
    """Phase 1: the devices JAX found must be GPUs, at least ``n_cards``."""
    import jax
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX found platform {devs[0].platform!r}")
    check(len(devs) >= n_cards, f"need {n_cards} cards, JAX found {len(devs)}")
    return devs[:n_cards]


def card_name_and_limit() -> str:
    """The cards' name and power limit, read by a child process that stays
    off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    check(bool(lines), "nvidia-smi printed nothing")
    return "; ".join(lines)


# ----------------------------------------------------------------------
# Work for the CPU worker processes: stream generation and golden decodes.
# They run numpy only and are held to the CPU platform.

def _worker_init() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"


def _digest(frame) -> tuple:
    """(temporal_reference, sha256 of Y, U, V) of a cropped frame."""
    import numpy as np
    return (int(frame.temporal_reference),) + tuple(
        hashlib.sha256(np.ascontiguousarray(p).tobytes()).hexdigest()
        for p in (frame.y, frame.u, frame.v))


def golden_digests(path: str) -> list:
    from tiny_mp2v_dec_tpu.golden.decoder import decode_stream
    with open(path, "rb") as f:
        return [_digest(fr) for fr in decode_stream(f.read())]


def make_bench(n_pictures: int, mbw: int, mbh: int) -> str:
    """The bench stream (tools/bench_stream.py): IBBP, random tokens."""
    from bench_stream import make_bench_stream
    make_bench_stream(n_pictures, DATA_DIR, mbw=mbw, mbh=mbh)
    return os.path.join(
        DATA_DIR, f"bench_{mbw}x{mbh}_cf1_{n_pictures}_v2.m2v")


def make_stream(name: str, seed: int, mbw: int, mbh: int, chroma: int,
                pcts: tuple, **opts) -> str:
    """A random-token stream of the given picture types (decode order)."""
    import numpy as np
    from m2v_encoder import encode_stream, random_picture
    rng = np.random.default_rng(seed)
    pics = []
    for i, pct in enumerate(pcts):
        p = random_picture(rng, mbw, mbh, chroma, pct, **opts)
        p.temporal_reference = i
        pics.append(p)
    os.makedirs(DATA_DIR, exist_ok=True)
    path = os.path.join(DATA_DIR, f"{name}_{mbw}x{mbh}_cf{chroma}_s{seed}.m2v")
    with open(path, "wb") as f:
        f.write(encode_stream(mbw * 16, mbh * 16, chroma, pics))
    return path


def stream_with_golden(fn, *args, **kw) -> tuple:
    path = fn(*args, **kw)
    return path, golden_digests(path)


# ----------------------------------------------------------------------

def _hd() -> str:
    return f"{HD[0] * 16}x{HD[1] * 16}"


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def compare(name: str, got_frames, want: list) -> None:
    got = [_digest(fr) for fr in got_frames]
    check(len(got) == len(want),
          f"{name}: {len(got)} frames, golden has {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        check(g[0] == w[0], f"{name}: frame {i} temporal_reference "
              f"{g[0]} != golden {w[0]}")
        for plane, a, b in zip("YUV", g[1:], w[1:]):
            check(a == b, f"{name}: frame {i} {plane} differs from golden")


def truncate_pictures(data: bytes, n: int) -> bytes:
    """The stream cut before its (n+1)-th picture, with a sequence end."""
    from tiny_mp2v_dec_tpu import headers as H
    from tiny_mp2v_dec_tpu.golden.decoder import scan_start_codes
    pics = [int(o) for o in scan_start_codes(data)
            if data[int(o) + 3] == H.PICTURE_START_CODE]
    if len(pics) <= n:
        return data
    return data[:pics[n]] + bytes([0, 0, 1, H.SEQUENCE_END_CODE])


def timed(fn, reps: int, warm: int = 2) -> list:
    """Host-clock seconds of ``fn()`` (which blocks on its device work)."""
    for _ in range(warm):
        fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def decode_timed(config, data: bytes):
    from tiny_mp2v_dec_tpu import MP2VDecoder
    dec = MP2VDecoder(config)
    t0 = time.perf_counter()
    frames = dec.decode(data)
    return dec, frames, time.perf_counter() - t0


class CompileLog:
    """XLA compile durations per program, from JAX's monitoring events
    (a persistent-cache hit is recorded as a short compile)."""

    def __init__(self):
        self.secs = {}
        self.cache_hits = 0

    def on_duration(self, event: str, secs: float, **kw) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self.secs.setdefault(kw.get("fun_name", "?"), []).append(secs)

    def on_event(self, event: str, **kw) -> None:
        if event == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1

    def lines(self, top: int = 8) -> list:
        progs = sorted(self.secs.items(), key=lambda kv: -sum(kv[1]))
        out = [f"    {name}: {len(v)} compiles, {sum(v):.2f} s total, "
               f"longest {max(v):.2f} s" for name, v in progs[:top]]
        rest = [x for _, v in progs[top:] for x in v]
        out.append(f"    {len(rest)} compiles of {len(progs[top:])} other "
                   f"programs: {sum(rest):.2f} s; persistent-cache hits "
                   f"{self.cache_hits}")
        return out


def native_check() -> None:
    """Phase 2: the native tokenizer and the C pair packers must load; the
    decoder must not fall back to the Python tokenizer or numpy packing."""
    from tiny_mp2v_dec_tpu.tokenizer.native import _load, pair_packers
    _load()
    check(pair_packers() is not None, "C pair packers did not load")


def uses_native(dec, recon) -> bool:
    mod = "tiny_mp2v_dec_tpu.tokenizer.native"
    return (dec.tokenize_picture.__module__ == mod
            and recon._packers is not None
            and recon._packers[0].__module__ == mod)


# ----------------------------------------------------------------------

def run_one_card(pool, card: str, compiles: CompileLog) -> None:
    import jax
    import numpy as np
    from tiny_mp2v_dec_tpu import DecoderConfig, MP2VDecoder
    from tiny_mp2v_dec_tpu import headers as H
    from tiny_mp2v_dec_tpu.ops.recon import _GOP_RECONS, _ladder
    from tiny_mp2v_dec_tpu.tokenizer.types import PictureGeometry

    I, P, B = H.PCT_I, H.PCT_P, H.PCT_B
    ibbp8 = (I, P, B, B, P, B, B, P)
    gen = pool.submit(make_bench, BENCH_PICTURES, *HD)
    field_f = pool.submit(stream_with_golden, make_stream, "field", 5152,
                          *HD, H.CHROMA_420, ibbp8, fpfd=False,
                          allow_field_motion=True)
    c422_f = pool.submit(stream_with_golden, make_stream, "c422", 4220,
                         *HD, H.CHROMA_422, ibbp8)
    patterns = ((I, P, B, B, P, B, B, P), (I, B, B, P, B, B, P),
                (I, P, P, P, P, P), (I, I, P, B, P, B))
    batch_f = [pool.submit(stream_with_golden, make_stream, f"sd{i}",
                           7000 + i, *SD, H.CHROMA_420, pat)
               for i, pat in enumerate(patterns)]

    # -- phase 3: chunk mode, 1080p 4:2:0, 64 pictures = 4 chunks
    t0 = time.perf_counter()
    bench_path = gen.result()
    gold_f = pool.submit(golden_digests, bench_path)
    data = _read(bench_path)
    print(f"phase 3: bench stream ready ({len(data)} bytes, "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    dec, frames, cold = decode_timed(
        DecoderConfig(gop_chunk=CHUNK, output_host=True), data)
    geom = PictureGeometry(HD[0] * 16, HD[1] * 16, H.CHROMA_420)
    recon = _GOP_RECONS[(geom, CHUNK, False)]
    check(uses_native(dec, recon), "decoder fell back from native host code")
    gold = gold_f.result()
    compare("chunk mode", frames, gold)
    recon.quiesce()
    check(recon.stats["bg_compile_fails"] == 0,
          f"background compiles failed: {recon.stats['bg_compile_fails']}")
    print(f"phase 3 chunk mode {_hd()} 4:2:0: {len(frames)} frames bit-exact "
          f"vs golden in {BENCH_PICTURES // CHUNK} chunks; cold decode "
          f"incl. compile {cold:.2f} s; bucket_fallbacks="
          f"{recon.stats['bucket_fallbacks']} bg_compiles="
          f"{recon.stats['bg_compiles']} bg_compile_fails=0", flush=True)

    # -- phase 4: latency mode, first 8 pictures
    data8 = truncate_pictures(data, 8)
    _, frames4, cold4 = decode_timed(DecoderConfig(gop_chunk=0), data8)
    by_tr = {d[0]: d for d in gold}
    want = [by_tr[fr.temporal_reference] for fr in frames4]
    check(sorted(fr.temporal_reference for fr in frames4) == list(range(8)),
          "latency mode: wrong set of frames")
    compare("latency mode", frames4, want)
    print(f"phase 4 latency mode {_hd()}: {len(frames4)} frames bit-exact vs "
          f"golden; cold decode incl. compile {cold4:.2f} s", flush=True)

    # -- phase 5: field motion at 1080p
    path, want = field_f.result()
    dec5, frames5, cold5 = decode_timed(DecoderConfig(gop_chunk=CHUNK),
                                        _read(path))
    compare("field motion", frames5, want)
    check(dec5.stats["bg_compile_fails"] == 0,
          "field: background compile failed")
    print(f"phase 5 field motion {_hd()} 4:2:0: {len(frames5)} frames "
          f"bit-exact vs golden; cold decode incl. compile {cold5:.2f} s",
          flush=True)

    # -- phase 6: 4:2:2 at 1080p
    path, want = c422_f.result()
    _, frames6, cold6 = decode_timed(DecoderConfig(gop_chunk=CHUNK),
                                        _read(path))
    compare("4:2:2", frames6, want)
    print(f"phase 6 {_hd()} 4:2:2: {len(frames6)} frames bit-exact vs golden; "
          f"cold decode incl. compile {cold6:.2f} s", flush=True)

    # -- phase 7: decode_batch, 4 SD streams, mesh of one card
    got = [f.result() for f in batch_f]
    t0 = time.perf_counter()
    out = MP2VDecoder(DecoderConfig()).decode_batch([_read(p) for p, _ in got])
    cold7 = time.perf_counter() - t0
    for i, ((_, want), frames7) in enumerate(zip(got, out)):
        compare(f"decode_batch stream {i}", frames7, want)
    print(f"phase 7 decode_batch 4 x {SD[0] * 16}x{SD[1] * 16} 4:2:0 "
          f"on one card: {sum(len(f) for f in out)} frames bit-exact vs "
          f"golden; cold incl. compile {cold7:.2f} s", flush=True)

    # -- phase 8: informative timings (not claims)
    dev = jax.devices()[0]
    tag = f"[{dev.device_kind}; {card}]"
    print(f"phase 8 timings {tag}", flush=True)
    print("  compile seconds per program (phases 3-7):", flush=True)
    for line in compiles.lines():
        print(line, flush=True)
    print("  host clock around block_until_ready, warmed:", flush=True)
    decc = MP2VDecoder(DecoderConfig(gop_chunk=CHUNK, output_host=False,
                                     pictures_pool_size=0))

    def run_chunk():
        decc.reset()
        fr = decc.decode(data)
        jax.block_until_ready([f.device_buffer() for f in fr])
    for r in _GOP_RECONS.values():
        r.quiesce()
    secs = timed(run_chunk, reps=5)
    med = statistics.median(secs)
    print(f"  chunk mode {_hd()} 4:2:0 gop_chunk={CHUNK}, frames on device: "
          f"{BENCH_PICTURES / med:.1f} fps (median of 5: {med * 1e3:.1f} ms "
          f"per {BENCH_PICTURES} frames; runs "
          f"{', '.join(f'{s * 1e3:.1f}' for s in secs)} ms)", flush=True)
    st, n = decc.stats, max(decc.stats["pictures"], 1)
    print(f"  chunk mode host stages, last run, ms per picture: tokenize "
          f"{st['tokenize_s'] / n * 1e3:.2f}, fill {st['fill_s'] / n * 1e3:.2f}"
          f", upload+dispatch {st['device_s'] / n * 1e3:.2f} "
          f"(decoder.stats; stages overlap on three threads)", flush=True)

    decl = MP2VDecoder(DecoderConfig(gop_chunk=0, output_host=False,
                                     reordering=False))

    def run_latency():
        decl.reset()
        for fr in decl.decode(data8):
            jax.block_until_ready(fr.device_buffer())
    secs = timed(run_latency, reps=5)
    med = statistics.median(secs)
    print(f"  latency mode {_hd()} gop_chunk=0: {med / 8 * 1e3:.2f} ms/frame "
          f"(median of 5 runs of 8 frames)", flush=True)

    from tiny_mp2v_dec_tpu.ops.idct import idct_blocks_jnp
    toks = MP2VDecoder(DecoderConfig()).tokenize_stream(
        truncate_pictures(data, CHUNK))
    rows = np.concatenate([t.cblk[:t.n_coded_blocks] for t, _, _ in toks])
    cap_k = _ladder(len(rows) + 1)
    coeff = np.zeros((cap_k, 64), np.int16)
    coeff[:len(rows)] = rows
    coeff = jax.device_put(coeff)
    secs = timed(lambda: idct_blocks_jnp(coeff).block_until_ready(), reps=20)
    med = statistics.median(secs)
    nbytes = cap_k * 64 * 2 * 2
    print(f"  XLA idct_blocks_jnp over one {CHUNK}-picture chunk "
          f"({cap_k} coded-block rows, {nbytes / 1e6:.1f} MB in+out): "
          f"{med * 1e6:.1f} us (median of 20; {nbytes / med / 1e9:.1f} GB/s)",
          flush=True)

    from functools import partial
    from tiny_mp2v_dec_tpu.ops.recon import DeviceRecon
    from tiny_mp2v_dec_tpu.parallel.mesh import random_tokens
    rng = np.random.default_rng(0)
    rec = DeviceRecon(geom, field_support=False)
    t = random_tokens(rng, geom)
    residual = jax.device_put(
        rng.integers(-64, 64, (geom.n_mb, geom.blocks_per_mb, 8, 8))
        .astype(np.int16))
    planes = [jax.device_put(rng.integers(0, 256, s).astype(np.uint8))
              for s in (geom.luma_padded, geom.chroma_padded,
                        geom.chroma_padded) * 2]
    meta = [jax.device_put(a) for a in
            (t.dct_type, t.fwd, t.bwd, t.field_pred, t.coded, t.mv, t.mvfs)]
    fn = jax.jit(partial(rec._recon_from_residual, bidir=True))
    secs = timed(lambda: jax.block_until_ready(fn(residual, *meta, *planes)),
                 reps=20)
    print(f"  XLA _recon_from_residual, one {_hd()} bidirectional "
          f"picture: {statistics.median(secs) * 1e6:.1f} us (median of 20)",
          flush=True)
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    check(peak is not None, "device reports no peak_bytes_in_use")
    print(f"  peak device memory: {peak / 2**30:.2f} GiB "
          f"(memory_stats peak_bytes_in_use)", flush=True)


def run_four_cards(pool, devs) -> None:
    """decode_batch of 4 1080p streams (one per card) and mesh="rows" on
    one 1080p stream (17 MB rows per card), each against golden."""
    from tiny_mp2v_dec_tpu import DecoderConfig, MP2VDecoder
    from tiny_mp2v_dec_tpu import headers as H
    from tiny_mp2v_dec_tpu.parallel import mesh as M
    I, P, B = H.PCT_I, H.PCT_P, H.PCT_B
    patterns = ((I, P, B, B) * 4, (I, B, B, P) * 4, (I, P, P, P) * 4,
                (I, I, P, B) * 4)
    futs = [pool.submit(stream_with_golden, make_stream, f"hd{i}", 9000 + i,
                        *HD, H.CHROMA_420, pat)
            for i, pat in enumerate(patterns)]
    got = [f.result() for f in futs]
    n = len(devs)

    lumas = []   # the first step's stacked luma output, to check placement
    step = M.StreamBatchRecon.step

    def recording_step(self, *a, **k):
        out = step(self, *a, **k)
        lumas.append(out[2][0])
        return out
    M.StreamBatchRecon.step = recording_step
    try:
        t0 = time.perf_counter()
        out = MP2VDecoder(DecoderConfig()).decode_batch(
            [_read(p) for p, _ in got])
        cold = time.perf_counter() - t0
    finally:
        M.StreamBatchRecon.step = step
    for i, ((_, want), frames) in enumerate(zip(got, out)):
        compare(f"decode_batch stream {i}", frames, want)
    streams = {s.device: s.data.shape[0] for s in lumas[0].addressable_shards}
    check(len(streams) == n and set(streams.values()) == {1},
          f"decode_batch streams per card: {sorted(streams.values())}")
    print(f"cards 4: decode_batch {n} x {_hd()} 4:2:0 x 16 pictures: "
          f"{sum(len(f) for f in out)} frames bit-exact vs golden; output "
          f"sharded one stream per card over {len(streams)} cards; cold "
          f"incl. compile {cold:.2f} s", flush=True)

    path, want = got[0]
    _, frames, cold = decode_timed(
        DecoderConfig(mesh="rows", mesh_devices=n), _read(path))
    compare("mesh rows", frames, want)
    y = frames[-1].device_buffer()[0]
    rows = {s.device: s.data.shape[0] for s in y.addressable_shards}
    check(len(y.sharding.device_set) == n and len(rows) == n,
          f"mesh rows output on {len(rows)} cards, not {n}")
    check(set(rows.values()) == {y.shape[0] // n},
          f"mesh rows shard heights {sorted(rows.values())}")
    print(f"cards 4: mesh=\"rows\" {_hd()} 4:2:0 x 16 pictures: {len(frames)} "
          f"frames bit-exact vs golden; luma rows per card "
          f"{y.shape[0] // n} ({y.shape[0] // n // 16} MB rows) on {n} "
          f"cards; cold incl. compile {cold:.2f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-card paths on four cards")
    args = ap.parse_args(argv)

    # -- phase 1: device
    devs = check_devices(args.cards)
    from tiny_mp2v_dec_tpu.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    card = card_name_and_limit()
    compiles = CompileLog()
    import jax
    jax.monitoring.register_event_duration_secs_listener(compiles.on_duration)
    jax.monitoring.register_event_listener(compiles.on_event)
    print(f"phase 1 device: platform=gpu kind={devs[0].device_kind} "
          f"count={len(devs)}; compile cache {cache}", flush=True)
    print(f"card: {card}", flush=True)

    # -- phase 2: native host code
    native_check()
    print("phase 2 host side: native tokenizer and C pair packers loaded",
          flush=True)

    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    workers = max(2, min(8, (os.cpu_count() or 4) - 4))
    pool = ProcessPoolExecutor(max_workers=workers,
                               mp_context=mp.get_context("spawn"),
                               initializer=_worker_init)
    try:
        if args.cards == 1:
            run_one_card(pool, card, compiles)
        else:
            run_four_cards(pool, devs)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    print(f"card: {card}", flush=True)
    print(result_line("gpu", devs[0].device_kind, len(devs)), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
