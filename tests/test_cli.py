"""CLI smoke tests (reference analog: tiny_decoder/tiny_mp2v_dec.cpp)."""
import os

import numpy as np
import pytest

from m2v_encoder import encode_stream, random_picture
from tiny_mp2v_dec_tpu import headers as H
from tiny_mp2v_dec_tpu.cli import main
from tiny_mp2v_dec_tpu.golden.decoder import GoldenDecoder


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    rng = np.random.default_rng(11)
    pics = []
    for i, pct in enumerate((H.PCT_I, H.PCT_P, H.PCT_B)):
        p = random_picture(rng, 3, 2, H.CHROMA_420, pct)
        p.temporal_reference = i
        pics.append(p)
    data = encode_stream(48, 32, H.CHROMA_420, pics)
    path = tmp_path_factory.mktemp("cli") / "in.m2v"
    path.write_bytes(data)
    return str(path), data


def _golden_yuv(data, reorder=True):
    frames = GoldenDecoder().decode(data)
    return b"".join(f.y.tobytes() + f.u.tobytes() + f.v.tobytes()
                    for f in frames)


def test_cli_decode_matches_golden(stream, tmp_path):
    path, data = stream
    out = str(tmp_path / "out.yuv")
    assert main(["-v", path, "-o", out]) == 0
    with open(out, "rb") as f:
        assert f.read() == _golden_yuv(data)


def test_cli_overrides_and_golden_mode(stream, tmp_path):
    path, data = stream
    out = str(tmp_path / "g.yuv")
    assert main(["-v", path, "-o", out, "--golden", "--size", "48x32",
                 "--chroma", "420"]) == 0
    with open(out, "rb") as f:
        assert f.read() == _golden_yuv(data)


def test_cli_gop_chunk_and_mesh(stream, tmp_path):
    path, data = stream
    out = str(tmp_path / "c.yuv")
    assert main(["-v", path, "-o", out, "--gop-chunk", "2"]) == 0
    with open(out, "rb") as f:
        assert f.read() == _golden_yuv(data)
    out2 = str(tmp_path / "m.yuv")
    assert main(["-v", path, "-o", out2, "--mesh", "rows"]) == 0
    with open(out2, "rb") as f:
        assert f.read() == _golden_yuv(data)


def test_cli_has_no_hosts_option(stream):
    """One JAX process drives the local cards; --hosts is gone."""
    path, _ = stream
    with pytest.raises(SystemExit):
        main(["-v", path, "--hosts", "2"])
