"""Multi-card scale-out: device meshes and sharded reconstruction.

The reference's parallelism is shared-memory threading — picture-pipeline +
slice data-parallel workers over an atomic claim counter (reference:
src/core/threads.h/cpp; SURVEY §2/§5.8).  The device mapping:

* **Row sharding** (latency): macroblock rows of one picture are sharded
  across cards along the token batch axis; reference planes are replicated
  (the previous picture's sharded output is all-gathered over the links
  between cards when it is consumed as a replicated reference — general
  MVs can reach anywhere in the reference, so full-plane gather is the
  correct exchange; SURVEY §5.8).
* **Stream batching** (throughput/serving): N independent streams decode
  data-parallel, one shard per card, no collectives — the scaling mode that
  matches the "16x 1080p multi-host batch" milestone (BASELINE.json:11).
* Across hosts, independent (closed) GOPs are embarrassingly parallel; that
  orchestration is host-side work distribution on top of these per-host
  meshes.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.recon import DeviceRecon, _slot_guard
from ..tokenizer.types import CHROMA_INFO, PictureGeometry, PictureTokens


def _shard_map(f, *, mesh, in_specs, out_specs):
    """shard_map with per-device output checking off (the per-shard bodies
    here use axis_index to slice replicated inputs, which the varying-
    manual-axes checker can't prove replicated)."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def _plane_sds(geom: PictureGeometry, lead=()):
    """ShapeDtypeStructs of the (y, u, v) padded planes, optionally with a
    leading (stream) axis — used to warm sharded programs compile-only."""
    sds = jax.ShapeDtypeStruct
    return tuple(sds(tuple(lead) + s, jnp.uint8) for s in
                 (geom.luma_padded, geom.chroma_padded, geom.chroma_padded))


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("row",)) -> Mesh:
    """Flat mesh over the first ``n_devices`` local devices (all by
    default).  Every card reaches every other at the same rate, so the
    mesh shape follows the algorithm alone."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if len(axes) == 1:
        shape = (n,)
    elif len(axes) == 2:
        s = 2 if n % 2 == 0 and n >= 4 else 1
        shape = (s, n // s)
    else:
        raise ValueError("1 or 2 mesh axes supported")
    return Mesh(np.asarray(devs).reshape(shape), axes)


def pad_geometry_rows(geom: PictureGeometry, n_shards: int) -> PictureGeometry:
    """Round the MB-row count up so rows split evenly across shards."""
    mbh = ((geom.mb_height + n_shards - 1) // n_shards) * n_shards
    return PictureGeometry(width=geom.width, height=mbh * 16,
                           chroma_format=geom.chroma_format)


def pad_tokens_rows(tokens: PictureTokens, geom_padded: PictureGeometry) -> PictureTokens:
    """Zero-extend token tensors to the row-padded geometry (added MBs are
    uncoded and reconstruct to zero)."""
    n_old = tokens.geom.n_mb
    n_new = geom_padded.n_mb
    if n_new == n_old:
        return replace(tokens, geom=geom_padded)

    def ext(a):
        out = np.zeros((n_new,) + a.shape[1:], a.dtype)
        out[:n_old] = a
        return out

    # sparse coefficient rows are invariant under row padding (block indices
    # are mb*blocks_per_mb+slot and added MBs append at the end)
    out = PictureTokens(
        geom=geom_padded, cblk=tokens.cblk, cblk_idx=tokens.cblk_idx,
        intra=ext(tokens.intra), fwd=ext(tokens.fwd), bwd=ext(tokens.bwd),
        field_pred=ext(tokens.field_pred), dct_type=ext(tokens.dct_type),
        mv=ext(tokens.mv), mvfs=ext(tokens.mvfs), coded=ext(tokens.coded))
    out.n_coded_blocks = tokens.n_coded_blocks
    return out


class RowShardedRecon:
    """One picture reconstructed across all cards of a mesh axis: each card
    runs the single-card reconstruction on its band of MB rows under
    ``shard_map`` (window starts stay in full-reference coordinates).  The
    pair-packed blob and the reference planes are replicated — sparse rows
    are a few percent of dense volume, the cheap scatter+IDCT runs on every
    card, and general MVs can reach anywhere in the reference so full-plane
    replication is the correct exchange.  Output planes come back sharded
    by row band; consuming them as replicated references for the next
    picture is the all-gather between cards (SURVEY §5.8).  The multi-card
    analog of the reference's slice-parallel workers
    (reference: src/core/threads.cpp:138-159)."""

    def __init__(self, geom: PictureGeometry, mesh: Mesh, axis: str = "row",
                 field_support: bool = False):
        from ..ops.recon import GopRecon
        n = mesh.shape[axis]
        self.mesh = mesh
        self.axis = axis
        self.n_shards = n
        self.geom_in = geom
        self.geom = pad_geometry_rows(geom, n)
        self.mbh_local = self.geom.mb_height // n
        # transport: the same pair-packed consolidated blob + pinned
        # staging as the single-chip paths (GopRecon with chunk=1); its
        # inner DeviceRecon doubles as the band reconstructor
        self.transport = GopRecon(self.geom, 1, field_support=field_support)
        self.inner = self.transport.inner

        rep = NamedSharding(mesh, P())              # replicated refs/blob
        rows = NamedSharding(mesh, P(axis, None))   # plane rows
        self._rep = rep
        self._rows = rows
        self._fns = {}   # (cap_pairs, cap_k) -> jitted fn
        # background bucket compiles must warm THIS program, not the
        # transport's unused scan (ops/recon.GopRecon.ensure_compiled)
        self.transport.compile_hook = self._compile_for

    def _compile_for(self, cap_pairs: int, cap_k: int) -> None:
        total = self.transport._layout(cap_pairs, cap_k)[-1]
        blob = jax.ShapeDtypeStruct((total,), jnp.uint8)
        planes = _plane_sds(self.geom)
        self._fn_for(cap_pairs, cap_k).lower(blob, *planes, *planes).compile()

    def _fn_for(self, cap_pairs: int, cap_k: int):
        key = (cap_pairs, cap_k)
        if key not in self._fns:
            def shard(blob, *refs):
                return self._recon_band(blob, refs, cap_pairs=cap_pairs,
                                        cap_k=cap_k)
            sharded = _shard_map(
                shard, mesh=self.mesh,
                in_specs=(P(),) * 7,
                out_specs=(P(self.axis, None),) * 3)
            self._fns[key] = jax.jit(
                sharded, in_shardings=(self._rep,) * 7,
                out_shardings=(self._rows,) * 3)
        return self._fns[key]

    def _recon_band(self, blob, refs, *, cap_pairs, cap_k):
        """Per-shard body: decode the replicated blob, slice this shard's
        MB-row band, reconstruct it."""
        from ..ops.recon import _unpack_meta2
        inner = self.inner
        g = self.geom
        dense, meta, _flags = self.transport._decode_blob(
            blob, cap_pairs=cap_pairs, cap_k=cap_k)
        row0 = jax.lax.axis_index(self.axis) * self.mbh_local
        mb0 = row0 * g.mb_width
        n_loc = self.mbh_local * g.mb_width
        res_l = jax.lax.dynamic_slice_in_dim(
            dense[0], mb0 * g.blocks_per_mb, n_loc * g.blocks_per_mb)
        m_l = jax.lax.dynamic_slice_in_dim(meta[0], mb0, n_loc)
        dct_type, fwd, bwd, field_pred, coded, mv, mvfs = _unpack_meta2(
            m_l, inner.field_support)
        residual = res_l.reshape(n_loc, g.blocks_per_mb, 8, 8)
        return inner._recon_from_residual(
            residual, dct_type, fwd, bwd, field_pred, coded, mv, mvfs,
            *refs, band=(row0, self.mbh_local))

    def __call__(self, tokens: PictureTokens, ref0=None, ref1=None):
        g = self.geom
        tokens = pad_tokens_rows(tokens, g)
        zero = lambda s: jnp.zeros(s, jnp.uint8)
        if ref0 is None:
            ref0 = (zero(g.luma_padded), zero(g.chroma_padded), zero(g.chroma_padded))
        if ref1 is None:
            ref1 = (zero(g.luma_padded), zero(g.chroma_padded), zero(g.chroma_padded))
        # references arrive row-sharded from the previous picture; this
        # device_put IS the reference-plane all-gather between cards
        ref0 = tuple(jax.device_put(p, self._rep) for p in ref0)
        ref1 = tuple(jax.device_put(p, self._rep) for p in ref1)
        staged = self.transport.prepare([tokens], [2])
        key, blob = staged
        up = jax.device_put(blob, self._rep)
        out = self._fn_for(key[0], key[1])(up, *ref0, *ref1)
        self.transport.mark_dispatched(staged, _slot_guard(out[0], up))
        return out


class StreamBatchRecon:
    """N independent streams reconstructed data-parallel: every tensor gains
    a leading stream axis sharded across cards.  No collectives — linear
    scaling; the serving configuration.

    Transport: the same pair-packed consolidated blob as the GOP-chunk path
    (GopRecon.prepare — staging slots, sorted nonzero pairs, ~6 B per
    coefficient; stream index takes the place of picture index).  The blob
    is replicated and the cheap global scatter+IDCT runs on every card; the
    per-stream MC/reconstruction — the dominant cost — runs under
    ``shard_map``: each card loops (``lax.map``) over ITS streams with the
    single-card reconstruction, like the reference running its SIMD MC
    inside every worker thread (reference: src/core/mc.cpp:4-25,
    threads.cpp:138-159).  The per-stream reference-list update is data
    (is_b/is_ip selects, as in GopRecon's scan step), so streams with
    entirely different GOP structures batch together."""

    def __init__(self, geom: PictureGeometry, mesh: Mesh, axis: str = "stream",
                 field_support: bool = False, n_streams: int = 0):
        from ..ops.recon import GopRecon
        self.mesh = mesh
        self.axis = axis
        self.geom = geom
        self.n_streams = n_streams or mesh.shape[axis]
        n_sh = mesh.shape[axis]
        assert self.n_streams % n_sh == 0, \
            f"{self.n_streams} streams not divisible across {n_sh} shards"
        self.s_local = self.n_streams // n_sh
        # transport shares GopRecon's staging/prepare machinery; its inner
        # recon also serves as the per-stream reconstructor
        self.transport = GopRecon(geom, self.n_streams,
                                  field_support=field_support)
        self.inner = self.transport.inner
        self._st = NamedSharding(mesh, P(axis))
        self._rep = NamedSharding(mesh, P())
        self._fns = {}   # (cap_pairs, cap_k) -> jitted step
        self.transport.compile_hook = self._compile_for

    def _compile_for(self, cap_pairs: int, cap_k: int) -> None:
        total = self.transport._layout(cap_pairs, cap_k)[-1]
        blob = jax.ShapeDtypeStruct((total,), jnp.uint8)
        planes = _plane_sds(self.geom, lead=(self.n_streams,))
        self._fn_for(cap_pairs, cap_k).lower(blob, *planes, *planes).compile()

    def _fn_for(self, cap_pairs: int, cap_k: int):
        key = (cap_pairs, cap_k)
        if key not in self._fns:
            def shard(blob, *refs):
                return self._step_shard(blob, refs,
                                        cap_pairs=cap_pairs, cap_k=cap_k)
            sharded = _shard_map(
                shard, mesh=self.mesh,
                in_specs=(P(),) + (P(self.axis),) * 6,
                out_specs=(P(self.axis),) * 9)
            self._fns[key] = jax.jit(
                sharded,
                in_shardings=((self._rep,) + (self._st,) * 6),
                out_shardings=(self._st,) * 9)
        return self._fns[key]

    def _step_shard(self, blob, refs, *, cap_pairs, cap_k):
        """Per-shard body: decode the (replicated) blob, slice out this
        shard's streams, and reconstruct them sequentially."""
        from ..ops.recon import _unpack_meta2
        inner = self.inner
        geom = self.geom
        dense, meta, flags = self.transport._decode_blob(
            blob, cap_pairs=cap_pairs, cap_k=cap_k)
        s0 = jax.lax.axis_index(self.axis) * self.s_local
        dense_l = jax.lax.dynamic_slice_in_dim(dense, s0, self.s_local)
        meta_l = jax.lax.dynamic_slice_in_dim(meta, s0, self.s_local)
        flags_l = jax.lax.dynamic_slice_in_dim(flags, s0, self.s_local)
        is_b = (flags_l & 1) != 0
        is_ip = (flags_l & 2) != 0

        def one(xs):
            res, m, b_flag, ip_flag, r0y, r0u, r0v, r1y, r1u, r1v = xs
            dct_type, fwd, bwd, field_pred, coded, mv, mvfs = _unpack_meta2(
                m, inner.field_support)
            residual = res.reshape(geom.n_mb, geom.blocks_per_mb, 8, 8)
            r0 = (r0y, r0u, r0v)
            r1 = (r1y, r1u, r1v)
            # B pictures predict from (older, newer); I/P from (newer, -)
            ref0u = tuple(jnp.where(b_flag, a, b) for a, b in zip(r0, r1))
            out = inner._recon_from_residual(
                residual, dct_type, fwd, bwd, field_pred, coded, mv, mvfs,
                *ref0u, *r1)
            new_r0 = tuple(jnp.where(ip_flag, b, a) for a, b in zip(r0, r1))
            new_r1 = tuple(jnp.where(ip_flag, o, b) for o, b in zip(out, r1))
            return (*new_r0, *new_r1, *out)

        # lax.map = sequential per-stream decode on this card: ONE traced
        # program regardless of how many streams the shard serves
        return jax.lax.map(one, (dense_l, meta_l, is_b, is_ip, *refs))

    def _zero_refs(self):
        g = self.geom
        n = self.n_streams
        zero = lambda s: jnp.zeros((n,) + s, jnp.uint8)
        return (zero(g.luma_padded), zero(g.chroma_padded),
                zero(g.chroma_padded))

    def step(self, tokens_list, is_b, is_ip, refs0=None, refs1=None):
        """One batched decode step with per-stream picture types.

        tokens_list: one PictureTokens per stream; is_b[i]: stream i's
        picture is B (refs untouched); is_ip[i]: it becomes the newest
        reference.  refs0/refs1: per-stream reference plane tuples, each
        stacked (n_streams, H, W).  Returns (refs0, refs1, (y, u, v))."""
        assert len(tokens_list) == self.n_streams
        # is_ip must be the complement of is_b (the transport encodes the
        # step flags from the picture type; padding steps are B-coded)
        assert all(bool(b) != bool(p) for b, p in zip(is_b, is_ip))
        staged = self.transport.prepare(tokens_list,
                                        [3 if b else 2 for b in is_b])
        key, blob = staged
        cap_pairs, cap_k = key[0], key[1]
        if refs0 is None:
            refs0 = self._zero_refs()
        if refs1 is None:
            refs1 = self._zero_refs()
        refs0 = tuple(jax.device_put(p, self._st) for p in refs0)
        refs1 = tuple(jax.device_put(p, self._st) for p in refs1)
        up = jax.device_put(blob, self._rep)
        out = self._fn_for(cap_pairs, cap_k)(up, *refs0, *refs1)
        self.transport.mark_dispatched(staged, _slot_guard(out[0], up))
        return out[0:3], out[3:6], out[6:9]

    def __call__(self, tokens_list, refs0=None, refs1=None):
        """Single batched picture (compat API): refs0 is every stream's
        forward reference, refs1 the backward; reference lists are not
        advanced.  Returns stacked (y, u, v) planes."""
        n = len(tokens_list)
        # is_b=True routes refs0 to the forward slot; is_ip=False leaves
        # the (discarded) reference lists untouched
        _, _, planes = self.step(
            tokens_list, [True] * n, [False] * n, refs0, refs1)
        return planes


def random_tokens(rng, geom: PictureGeometry, p_coded=0.9) -> PictureTokens:
    """Synthetic dense tokens for benchmarks and sharding dry-runs."""
    n = geom.n_mb
    nb = geom.blocks_per_mb
    t = PictureTokens.empty(geom)
    t.set_dense_coeff(rng.integers(-300, 300, (n, nb, 64)).astype(np.int16))
    t.coded[:] = rng.random(n) < p_coded
    t.intra[:] = rng.random(n) < 0.2
    t.fwd[:] = ~t.intra & (rng.random(n) < 0.8)
    t.bwd[:] = ~t.intra & (rng.random(n) < 0.5)
    t.mv[:] = rng.integers(-64, 64, (n, 2, 2, 2)).astype(np.int16)
    return t
