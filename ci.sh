#!/usr/bin/env bash
# CI entry point (reference analog: .circleci/config.yml).
#
# Builds the native tokenizer, runs the full test suite on an 8-virtual-
# device CPU mesh (includes sharded recon value-equality, multihost process
# tests, and the reference-binary conformance suite when the reference
# source tree is available), then the multi-device dryrun and a CLI smoke
# test.  The GPU check is `python chip_smoke.py` on a machine with a card.
set -euo pipefail
cd "$(dirname "$0")"

echo "== native tokenizer build =="
python -c "from tiny_mp2v_dec_tpu.tokenizer import get_tokenizer; get_tokenizer(0); print('tokenizer ok')"

echo "== pytest =="
python -m pytest tests/ -q

echo "== multichip dryrun (8 virtual devices) =="
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

echo "== CLI smoke =="
python - <<'EOF'
import os, sys, tempfile
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, "tests")
import numpy as np
from m2v_encoder import encode_stream, random_picture
from tiny_mp2v_dec_tpu import headers as H
rng = np.random.default_rng(3)
pics = [random_picture(rng, 3, 2, H.CHROMA_420, H.PCT_I)]
data = encode_stream(48, 32, H.CHROMA_420, pics)
src = tempfile.mktemp(suffix=".m2v"); out = tempfile.mktemp(suffix=".yuv")
open(src, "wb").write(data)
from tiny_mp2v_dec_tpu.cli import main
assert main(["-v", src, "-o", out]) == 0
want = 48 * 32 + 2 * 24 * 16
got = os.path.getsize(out)
assert got == want, (got, want)
print("cli smoke ok")
EOF

echo "CI green"
