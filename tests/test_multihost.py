"""Multi-host GOP distribution: the closed-GOP splitter and the simulated
N-process decoder must reproduce the single-decoder output byte-for-byte in
display order (SURVEY §5.8 — the cross-host analog of the reference's
picture-DAG scheduling, reference: src/core/threads.cpp:100-159)."""
import numpy as np
import pytest

from m2v_encoder import encode_stream, random_picture
from tiny_mp2v_dec_tpu import DecoderConfig, MP2VDecoder, headers as H
from tiny_mp2v_dec_tpu.parallel.hosts import (GopChunk, MultiHostDecoder,
                                              split_gops)

SEQ_END = bytes([0, 0, 1, H.SEQUENCE_END_CODE])


def _gop_stream(seed, n_pics=4, mbw=4, mbh=3):
    rng = np.random.default_rng(seed)
    pcts = [H.PCT_I] + [H.PCT_P, H.PCT_B, H.PCT_B, H.PCT_P][:n_pics - 1]
    pics = []
    for i, pct in enumerate(pcts):
        p = random_picture(rng, mbw, mbh, H.CHROMA_420, pct)
        p.temporal_reference = i
        pics.append(p)
    return encode_stream(mbw * 16, mbh * 16, H.CHROMA_420, pics)


def _multi_gop_stream(n_gops, seed0=50, **kw):
    """Concatenate closed GOPs (each with its own sequence header) into one
    stream; only the last keeps the sequence_end code."""
    parts = []
    for i in range(n_gops):
        s = _gop_stream(seed0 + i, **kw)
        assert s.endswith(SEQ_END)
        parts.append(s[:-len(SEQ_END)] if i < n_gops - 1 else s)
    return b"".join(parts)


def test_split_gops_boundaries():
    data = _multi_gop_stream(3, n_pics=4)
    chunks = split_gops(data)
    assert len(chunks) == 3
    assert all(c.n_pictures == 4 for c in chunks)
    # every chunk decodes standalone to the same frames as its source GOP
    for i, c in enumerate(chunks):
        dec = MP2VDecoder(DecoderConfig())
        frames = dec.decode(c.data)
        exp = MP2VDecoder(DecoderConfig()).decode(_gop_stream(50 + i))
        assert len(frames) == len(exp)
        for a, b in zip(frames, exp):
            np.testing.assert_array_equal(a.y, b.y)


def test_split_gops_open_gop_stays_attached():
    """An open GOP (closed_gop=0) must not become its own chunk."""
    data = _multi_gop_stream(2)
    # flip the second GOP header's closed_gop bit (byte after the 25-bit
    # time_code within the group header)
    from tiny_mp2v_dec_tpu.golden.decoder import scan_start_codes
    offs = [int(o) for o in scan_start_codes(data)]
    gops = [o for o in offs if data[o + 3] == H.GROUP_START_CODE]
    assert len(gops) == 2
    b = bytearray(data)
    # group header layout: 25b time_code, 1b closed_gop, 1b broken_link
    # -> closed_gop is bit 6 (0x40) of byte 3 after the start code
    hdr = gops[1] + 4
    b[hdr + 3] &= ~0x40
    chunks = split_gops(bytes(b))
    # second GOP is open -> merged with the first sequence's chunk
    assert len(chunks) == 1 or (len(chunks) == 2 and chunks[0].n_pictures == 8)
    # NOTE: each GOP here follows its own sequence header, which is always a
    # legal cut; drop the second sequence header too for a strict check
    data2 = bytes(b)
    sh = [o for o in offs if data2[o + 3] == H.SEQUENCE_HEADER_CODE]
    if len(sh) == 2:
        ext_end = gops[1]
        data3 = data2[:sh[1]] + data2[ext_end:]
        chunks3 = split_gops(data3)
        assert len(chunks3) == 1
        assert chunks3[0].n_pictures == 8


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_multihost_bitexact_display_order(n_hosts):
    data = _multi_gop_stream(4, n_pics=4)
    single = MP2VDecoder(DecoderConfig()).decode(data)
    exp = [f.tobytes() for f in single]
    with MultiHostDecoder(n_hosts, platform="cpu") as mh:
        got = mh.decode(data)
    assert len(got) == len(exp) == 16
    for a, b in zip(exp, got):
        assert a == b


def test_split_no_cut_at_seq_header_before_non_I_picture():
    """A repeated sequence header directly preceding a picture (no GOP
    header in between) is NOT a legal cut: closedness cannot be
    established, and a P/B picture there needs the previous anchor
    (ADVICE r3: cutting decoded the chunk without its reference)."""
    a = _gop_stream(70, n_pics=4)
    b = _gop_stream(71, n_pics=4)
    from tiny_mp2v_dec_tpu.golden.decoder import scan_start_codes
    # excise B's GOP header so its pictures follow the seq header directly
    offs = [int(o) for o in scan_start_codes(b)]
    gop_off = next(o for o in offs if b[o + 3] == H.GROUP_START_CODE)
    gop_end = next(o for o in offs if o > gop_off)
    b_nogop = b[:gop_off] + b[gop_end:]
    data = a[:-len(SEQ_END)] + b_nogop
    chunks = split_gops(data)
    assert len(chunks) == 1
    assert chunks[0].n_pictures == 8


def test_split_no_cut_while_quant_matrix_extension_live():
    """A picture-level quant matrix extension persists until the next
    sequence header (6.3.11); replaying only the sequence header in a chunk
    prefix would reset it, so no cut is legal while one is live."""
    rng = np.random.default_rng(72)
    qm = H.QuantMatrixExtension(
        load_intra_quantiser_matrix=1,
        intra_quantiser_matrix=np.clip(
            rng.integers(1, 200, 64), 1, 255).astype(np.uint8))
    pics = []
    for i, pct in enumerate([H.PCT_I, H.PCT_P, H.PCT_P, H.PCT_P]):
        p = random_picture(rng, 4, 3, H.CHROMA_420, pct)
        p.temporal_reference = i
        if i == 1:
            p.qmext = qm
        pics.append(p)
    a = encode_stream(64, 48, H.CHROMA_420, pics)
    b = _gop_stream(73, n_pics=4)
    data = a[:-len(SEQ_END)] + b
    # b starts with its own sequence header, which resets matrices: that
    # cut stays legal.  Build a variant where GOP 2 has no fresh sequence
    # header — there the live qmext must suppress the cut.
    from tiny_mp2v_dec_tpu.golden.decoder import scan_start_codes
    offs = [int(o) for o in scan_start_codes(b)]
    gop_off = next(o for o in offs if b[o + 3] == H.GROUP_START_CODE)
    data_nosh = a[:-len(SEQ_END)] + b[gop_off:]
    chunks = split_gops(data_nosh)
    assert len(chunks) == 1
    assert chunks[0].n_pictures == 8
    # with the fresh sequence header the cut is legal again
    assert len(split_gops(data)) == 2


# ----------------------------------------------------------------------
# Real jax.distributed backend (parallel/distributed.py): two coordinated
# CPU processes, GOP assignment by process rank, host-local frames,
# deterministic display-order merge (VERDICT r3 #10; SURVEY §5.8 mapping
# of threads.cpp:100-159).

def _jaxdist_worker(rank, world, port, data, q):
    import os
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=2")
    try:
        import jax
        # force the CPU platform via config as well, BEFORE the
        # distributed client initializes (conftest does the same for
        # in-process tests)
        jax.config.update("jax_platforms", "cpu")
        from tiny_mp2v_dec_tpu.parallel.distributed import (
            DistributedDecoder, host_chip_mesh, init_distributed)
        init_distributed(f"127.0.0.1:{port}", world, rank)
        mesh = host_chip_mesh()
        dd = DistributedDecoder()
        res = dd.decode(data)
        q.put((rank, jax.process_count(), tuple(mesh.shape.values()), res))
    except Exception as e:  # surface the failure in the parent
        q.put((rank, "error", repr(e), None))


@pytest.mark.parametrize("world", [2, 4])
def test_jax_distributed_decode(world):
    """world=2 and world=4 coordinated CPU processes (BASELINE's milestone
    ladder is 1/8/N hosts; 4 ranks exercise >2-way GOP assignment and the
    4-host ('host','chip') mesh)."""
    import multiprocessing as mp
    import socket
    data = _multi_gop_stream(4, seed0=90, n_pics=4)
    exp = [f.tobytes() for f in MP2VDecoder(DecoderConfig()).decode(data)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_jaxdist_worker,
                         args=(r, world, port, data, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = []
    try:
        for _ in range(world):
            results.append(q.get(timeout=240))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    errs = [r for r in results if r[1] == "error"]
    assert not errs, f"worker failures: {errs}"
    # every process saw the full world and the ('host','chip') mesh
    for rank, w, mesh_shape, _ in results:
        assert w == world
        assert mesh_shape[0] == world  # host axis = process count
    # rank-disjoint chunk assignment covering all 4 GOPs
    from tiny_mp2v_dec_tpu.parallel.distributed import merge_display_order
    per_host = [r[3] for r in results]
    idxs = sorted(i for host in per_host for i, _ in host)
    assert idxs == [0, 1, 2, 3]
    got = merge_display_order(per_host)
    assert got == exp
