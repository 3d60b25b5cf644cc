"""GopRecon's chunk program (pair-packed upload blob, device transport
decode, chunk-wide IDCT, lax.scan over pictures with the reference list as
carry) vs the numpy golden reconstruction (golden/recon.py), picture by
picture.  Covers every chroma format, both field-support variants and both
static programs (forward-only and bidirectional), with random tokens that
reach every half-pel phase, field select and dct_type, on odd geometries."""
import jax.numpy as jnp
import numpy as np
import pytest

from tiny_mp2v_dec_tpu import headers as H
from tiny_mp2v_dec_tpu.golden.recon import reconstruct_picture
from tiny_mp2v_dec_tpu.ops.recon import GopRecon
from tiny_mp2v_dec_tpu.parallel.mesh import random_tokens
from tiny_mp2v_dec_tpu.tokenizer.types import CHROMA_INFO, PictureGeometry

I, P, B = H.PCT_I, H.PCT_P, H.PCT_B
GEOMS = {H.CHROMA_420: (192, 112), H.CHROMA_422: (320, 128),
         H.CHROMA_444: (192, 96)}
CHUNK = 4


def _tokens(rng, geom, pct, field):
    t = random_tokens(rng, geom)
    n = geom.n_mb
    t.dct_type[:] = rng.random(n) < 0.3
    if pct == I:
        t.intra[:] = True
        t.fwd[:] = False
        t.bwd[:] = False
    elif pct == P:
        t.bwd[:] = False
    if field:
        t.field_pred[:] = ~t.intra & (rng.random(n) < 0.5)
        t.mvfs[:] = rng.integers(0, 2, t.mvfs.shape)
    return t


def _planes(rng, geom):
    return tuple(rng.integers(0, 256, s).astype(np.uint8)
                 for s in (geom.luma_padded, geom.chroma_padded,
                           geom.chroma_padded))


def _packed(planes, geom):
    xs, ys, _ = CHROMA_INFO[geom.chroma_format]
    cw = (geom.width + (1 << xs) - 1) >> xs
    ch = (geom.height + (1 << ys) - 1) >> ys
    return np.concatenate([planes[0][:geom.height, :geom.width].ravel(),
                           planes[1][:ch, :cw].ravel(),
                           planes[2][:ch, :cw].ravel()])


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("field", [False, True])
@pytest.mark.parametrize("cf", [H.CHROMA_420, H.CHROMA_422, H.CHROMA_444])
def test_gop_chunk_matches_golden(cf, field, bidir):
    rng = np.random.default_rng(100 * cf + 10 * field + bidir)
    geom = PictureGeometry(*GEOMS[cf], chroma_format=cf)
    # three pictures in a chunk of four: the padding step must leave the
    # reference list alone
    pcts = [P, B, P] if bidir else [I, P, P]
    toks = [_tokens(rng, geom, pct, field) for pct in pcts]
    assert field == any(t.field_pred.any() for t in toks)
    ref0, ref1 = _planes(rng, geom), _planes(rng, geom)

    r0, r1 = ref0, ref1
    want = []
    for t, pct in zip(toks, pcts):
        if pct == B:
            out = reconstruct_picture(t, ref0=r0, ref1=r1)
        else:
            out = reconstruct_picture(t, ref0=r1, ref1=r1)
            r0, r1 = r1, out
        want.append(_packed(out, geom))

    gr = GopRecon(geom, CHUNK, field_support=field)
    staged = gr.prepare(toks, pcts)
    g0, g1, packs = gr.dispatch(
        staged, tuple(map(jnp.asarray, ref0)), tuple(map(jnp.asarray, ref1)),
        bidir=bidir)
    packs = np.asarray(packs)
    assert packs.shape[0] == CHUNK
    for i, w in enumerate(want):
        np.testing.assert_array_equal(packs[i], w, err_msg=f"picture {i}")
    for got, exp in ((g0, r0), (g1, r1)):
        for a, b in zip(got, exp):
            np.testing.assert_array_equal(np.asarray(a), b)
