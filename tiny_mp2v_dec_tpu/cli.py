"""Command-line decoder (reference analog: tiny_decoder/tiny_mp2v_dec.cpp).

Usage:
    python -m tiny_mp2v_dec_tpu.cli -v in.m2v -o out.yuv
    python -m tiny_mp2v_dec_tpu.cli -v in.m2v --bench 10

Writes planar YUV (cropped, no stride padding) frame by frame; prints
wall-clock decode time.  ``--bench N`` decodes the stream N times after a
warm-up pass and reports frames/s (file output disabled, matching the
reference README's performance-measurement advice, README.md:48).
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tiny_mp2v_dec_tpu",
                                 description="MPEG-2 video decoder on JAX")
    ap.add_argument("-v", "--video", required=True, help="input .m2v elementary stream")
    ap.add_argument("-o", "--output", help="output planar YUV file")
    ap.add_argument("--no-reorder", action="store_true",
                    help="emit frames in decode order")
    ap.add_argument("--bench", type=int, default=0, metavar="N",
                    help="benchmark: decode N times after warm-up, print fps")
    ap.add_argument("--golden", action="store_true",
                    help="use the numpy golden decoder (no accelerator)")
    ap.add_argument("--size", metavar="WxH",
                    help="override coded size from the sequence header")
    ap.add_argument("--chroma", choices=["420", "422", "444"],
                    help="override chroma format from the sequence extension")
    ap.add_argument("--gop-chunk", type=int, default=0, metavar="N",
                    help="decode N pictures per compiled device program "
                         "(throughput mode; 0 = picture at a time)")
    ap.add_argument("--mesh", choices=["rows"],
                    help="shard each picture's MB rows across local cards")
    ap.add_argument("--on-error", choices=["raise", "drop_slice"],
                    default="raise",
                    help="malformed-slice policy: abort (default) or "
                         "contain the damage to the bad slice and keep "
                         "decoding")
    args = ap.parse_args(argv)

    with open(args.video, "rb") as f:
        data = f.read()

    w = h = 0
    if args.size:
        w, h = (int(x) for x in args.size.lower().split("x"))
    chroma = {None: 0, "420": 1, "422": 2, "444": 3}[args.chroma]

    if args.golden:
        from .golden.decoder import decode_stream
        decode = lambda: decode_stream(data, reordering=not args.no_reorder)
    else:
        from .runtime.decoder import DecoderConfig, MP2VDecoder
        from .utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        dec = MP2VDecoder(DecoderConfig(
            reordering=not args.no_reorder, width=w, height=h,
            chroma_format=chroma, gop_chunk=args.gop_chunk,
            mesh=args.mesh, on_error=args.on_error))

        def decode():
            dec.reset()
            return dec.decode(data)

    t0 = time.perf_counter()
    frames = decode()
    dt = time.perf_counter() - t0
    print(f"decoded {len(frames)} frames in {dt * 1e3:.1f} ms "
          f"({len(frames) / dt:.1f} fps incl. first-use compilation)")

    if args.bench:
        t0 = time.perf_counter()
        for _ in range(args.bench):
            frames = decode()
        dt = time.perf_counter() - t0
        total = len(frames) * args.bench
        print(f"bench: {total} frames in {dt:.3f} s = {total / dt:.1f} fps")

    if args.output:
        with open(args.output, "wb") as f:
            for fr in frames:
                f.write(fr.tobytes())
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
