"""The parts of chip_smoke.py that run without a card: it refuses to run on
the CPU, the format of its last line, its golden comparison and stream
truncation, and the compile-cache helper it shares with the CLI and the
bench."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from m2v_encoder import encode_stream, random_picture
from tiny_mp2v_dec_tpu import headers as H
from tiny_mp2v_dec_tpu.golden.decoder import decode_stream
from tiny_mp2v_dec_tpu.utils.compile_cache import REPO_CACHE_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _cpu_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def test_smoke_fails_without_gpu():
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=_cpu_env(), cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_device_check_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.check_devices(1)


def test_result_line_format():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_truncate_and_compare_against_golden():
    rng = np.random.default_rng(12)
    pics = []
    for i, pct in enumerate((H.PCT_I, H.PCT_P, H.PCT_B, H.PCT_P, H.PCT_B)):
        p = random_picture(rng, 2, 2, H.CHROMA_420, pct)
        p.temporal_reference = i
        pics.append(p)
    data = encode_stream(32, 32, H.CHROMA_420, pics)
    cut = chip_smoke.truncate_pictures(data, 3)
    frames = decode_stream(cut)
    assert sorted(f.temporal_reference for f in frames) == [0, 1, 2]
    # decoding is causal: the cut stream's frames equal the full stream's
    by_tr = {d[0]: d for d in map(chip_smoke._digest, decode_stream(data))}
    want = [by_tr[f.temporal_reference] for f in frames]
    chip_smoke.compare("cut", frames, want)
    frames[1].u = frames[1].u.copy()
    frames[1].u[0, 0] ^= 1
    with pytest.raises(chip_smoke.SmokeFailure, match="frame 1 U"):
        chip_smoke.compare("cut", frames, want)


_PRINT_CACHE = ("import jax; "
                "from tiny_mp2v_dec_tpu.utils.compile_cache import "
                "enable_compile_cache; "
                "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0); "
                "d = enable_compile_cache(); "
                "jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7)).block_until_ready(); "
                "print(d)")


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, tmp_path):
    """Set: JAX's own variable decides and the helper sets nothing.
    Unset: the cache goes to the fixed <repo>/.jax_cache."""
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_set else {}
    r = subprocess.run([sys.executable, "-c", _PRINT_CACHE],
                       env=_cpu_env(**extra), cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = r.stdout.strip().splitlines()[-1]
    if env_set:
        assert got == str(tmp_path)
        assert os.listdir(tmp_path), "nothing was cached"
    else:
        assert got == REPO_CACHE_DIR
