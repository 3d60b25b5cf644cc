"""Jitted per-picture device reconstruction.

One XLA computation per picture geometry: batched fixed-point IDCT, residual
tile assembly (incl. per-MB field-DCT interleave as a data-dependent select),
batched-gather motion compensation (frame and field based), bidirectional
averaging, residual add + saturation, and tile->plane layout — everything
after the host tokenizer, fused by XLA into a handful of kernels.

Bit-exact against golden/recon.py by construction and by test.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..headers import CHROMA_420
from ..tokenizer.types import CHROMA_INFO, PictureGeometry, PictureTokens
from .idct import idct_blocks_jnp
from .mc import (mc_bidir_tiles, mc_field_tiles, mc_unidir_tiles, pad_for_mc)


def _tiles_from_blocks(blocks, rows, cols, interleave_mask):
    """(n, rows*cols, 8, 8) spatial-row-major blocks -> (n, rows*8, cols*8)
    tiles, with per-MB field interleave (dct_type) selected by mask."""
    n = blocks.shape[0]
    grid = blocks.reshape(n, rows, cols, 8, 8)
    normal = grid.transpose(0, 1, 3, 2, 4).reshape(n, rows * 8, cols * 8)
    if rows == 1 or interleave_mask is None:
        return normal
    top = grid[:, 0].transpose(0, 2, 1, 3).reshape(n, 8, cols * 8)
    bot = grid[:, 1].transpose(0, 2, 1, 3).reshape(n, 8, cols * 8)
    field = jnp.stack([top, bot], axis=2).reshape(n, 16, cols * 8)
    return jnp.where(interleave_mask[:, None, None], field, normal)


def _plane_from_tiles(tiles, mb_h, mb_w, th, tw):
    return tiles.reshape(mb_h, mb_w, th, tw).transpose(0, 2, 1, 3).reshape(
        mb_h * th, mb_w * tw)


def _scale_mv(mv, comp, cf):
    """Vectorized chroma MV derivation; mv: (..., 2) [x, y] int16."""
    if comp == 0:
        return mv
    mvx, mvy = mv[..., 0], mv[..., 1]
    if cf < 3:
        mvx = mvx >> 1
    if cf < 2:
        mvy = mvy >> 1
    return jnp.stack([mvx, mvy], axis=-1)


# Packed per-MB metadata layout (one int16 upload instead of 7 small
# transfers): columns [dct, fwd, bwd, field_pred, coded, mv(8), mvfs(4)].
META_COLS = 17
_M_DCT, _M_FWD, _M_BWD, _M_FIELD, _M_CODED, _M_MV, _M_MVFS = 0, 1, 2, 3, 4, 5, 13


def pack_meta(tokens: PictureTokens, out: np.ndarray | None = None) -> np.ndarray:
    n = tokens.geom.n_mb
    meta = out if out is not None else np.zeros((n, META_COLS), np.int16)
    meta[:, _M_DCT] = tokens.dct_type
    meta[:, _M_FWD] = tokens.fwd
    meta[:, _M_BWD] = tokens.bwd
    meta[:, _M_FIELD] = tokens.field_pred
    meta[:, _M_CODED] = tokens.coded
    meta[:, _M_MV:_M_MV + 8] = tokens.mv.reshape(n, 8)
    meta[:, _M_MVFS:_M_MVFS + 4] = tokens.mvfs.reshape(n, 4)
    return meta


def _unpack_meta(meta):
    n = meta.shape[0]
    return (meta[:, _M_DCT] != 0, meta[:, _M_FWD] != 0, meta[:, _M_BWD] != 0,
            meta[:, _M_FIELD] != 0, meta[:, _M_CODED] != 0,
            meta[:, _M_MV:_M_MV + 8].reshape(n, 2, 2, 2),
            meta[:, _M_MVFS:_M_MVFS + 4].reshape(n, 2, 2).astype(jnp.uint8))


# Compact chunk-path metadata: one flags column (bit0 dct_type, 1 fwd,
# 2 bwd, 3 field_pred, 4 coded, 5..8 mvfs[r][s] at bit 5+2r+s) + MV
# columns, to keep upload bytes small.  Frame-pred-only
# chunks (field_support=False) carry just the first-unit MVs (5 cols);
# field-capable chunks carry all 8 + mvfs (9 cols).
def meta2_cols(field_support: bool) -> int:
    return 9 if field_support else 5


def pack_meta2(tokens: PictureTokens, field_support: bool,
               out: np.ndarray | None = None) -> np.ndarray:
    n = tokens.geom.n_mb
    cols = meta2_cols(field_support)
    meta = out if out is not None else np.zeros((n, cols), np.int16)
    flags = (tokens.dct_type.astype(np.int16)
             | (tokens.fwd.astype(np.int16) << 1)
             | (tokens.bwd.astype(np.int16) << 2)
             | (tokens.field_pred.astype(np.int16) << 3)
             | (tokens.coded.astype(np.int16) << 4))
    if field_support:
        mvfs = tokens.mvfs.reshape(n, 4).astype(np.int16)
        for b in range(4):
            flags |= mvfs[:, b] << (5 + b)
        meta[:, 1:9] = tokens.mv.reshape(n, 8)
    else:
        meta[:, 1:5] = tokens.mv[:, 0].reshape(n, 4)
    meta[:, 0] = flags
    return meta


def _unpack_meta2(meta, field_support: bool):
    n = meta.shape[0]
    flags = meta[:, 0]
    if field_support:
        mvfs = jnp.stack([(flags >> (5 + b)) & 1 for b in range(4)],
                         axis=-1).reshape(n, 2, 2).astype(jnp.uint8)
        mv = meta[:, 1:9].reshape(n, 2, 2, 2)
    else:
        mvfs = jnp.zeros((n, 2, 2), jnp.uint8)
        mv1 = meta[:, 1:5].reshape(n, 1, 2, 2)
        mv = jnp.concatenate([mv1, jnp.zeros_like(mv1)], axis=1)
    return ((flags & 1) != 0, (flags & 2) != 0, (flags & 4) != 0,
            (flags & 8) != 0, (flags & 16) != 0, mv, mvfs)


def _bucket(n: int, cap_max: int) -> int:
    """Round a coded-block count up to a power-of-two bucket (>= 2048) to
    bound the number of jit shape variants; clamped to the dense capacity.
    Callers pass n = coded_blocks + 1: one padding row is always reserved
    as the zero row that uncoded blocks gather from."""
    b = 2048
    while b < n:
        b <<= 1
    return min(b, cap_max) if n <= cap_max else cap_max


def _ladder(n: int, lo: int = 2048) -> int:
    """Size bucket on a {2^k, 1.5*2^k} ladder: at most 33% padding waste
    in upload bytes while still bounding the number of compiled shape
    variants.  All rungs are multiples of 1024."""
    b = lo
    while b < n:
        if (b & (b - 1)) == 0:
            b += b >> 1
        else:
            b = (b // 3) << 2
    return b


def _load_packers():
    """(count_pairs, pack_pairs) — C extension scans when available,
    numpy fallback otherwise."""
    from ..tokenizer.native import pair_packers
    packers = pair_packers()
    if packers is not None:
        return packers

    def count_pairs(rows, nnz_out):
        nz = np.count_nonzero(rows, axis=1)
        nnz_out[:len(nz)] = nz
        return int(nz.sum())

    def pack_pairs(rows, pos_out, val_out):
        nzr, nzc = np.nonzero(rows)
        n = len(nzr)
        pos_out[:n] = nzc
        val_out[:n] = rows[nzr, nzc]
        return n

    return count_pairs, pack_pairs


# The chunk blob uploads as two halves on a small pool (the jit
# concatenates them on device).  Device->host frame delivery gets its OWN
# pool: a large frame pull queued ahead of a chunk upload would otherwise
# block both workers and stall dispatch behind output consumption.
_UPLOAD_POOL = None
_FETCH_POOL = None


def _upload_pool():
    global _UPLOAD_POOL
    if _UPLOAD_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        # 4 workers: one decoder's split upload uses 2, so two concurrent
        # decoders do not serialize behind each other's halves
        _UPLOAD_POOL = ThreadPoolExecutor(max_workers=4)
    return _UPLOAD_POOL


def _fetch_pool():
    global _FETCH_POOL
    if _FETCH_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _FETCH_POOL = ThreadPoolExecutor(max_workers=2)
    return _FETCH_POOL


def _slot_guard(outputs, uploaded):
    """What must be ready before a host staging slot may be rewritten.

    * cpu: the JAX CPU client ZERO-COPY ALIASES sufficiently small/aligned
      numpy arrays, so the *consuming computation's outputs* guard the slot.
    * every other backend copies the host buffer into device memory: hold
      the uploaded device arrays, so slot reuse waits for the h2d copy.
    """
    if jax.default_backend() == "cpu":
        return outputs
    return uploaded


def _split_point(total: int) -> int:
    return (total // 2 + 3) & ~3


def _upload_split(blob: np.ndarray):
    half = _split_point(len(blob))
    fa = _upload_pool().submit(jnp.asarray, blob[:half])
    fb = _upload_pool().submit(jnp.asarray, blob[half:])
    return fa.result(), fb.result()


def _sparse_src_map(cblk_idx, k, n_rows, dummy, out=None):
    """Dense-row -> sparse-row gather map: src[j] = position of block j in
    the sparse row array, or ``dummy`` (a zeroed padding row) if uncoded.
    The inverse-permutation GATHER formulation replaces a device scatter
    with an embedding-style row gather."""
    src = out if out is not None else np.empty(n_rows, np.int32)
    src.fill(dummy)
    src[cblk_idx[:k]] = np.arange(k, dtype=np.int32)
    return src


class DeviceRecon:
    """Per-geometry compiled reconstruction step.

    ``field_support=False`` lets frame-pred-frame-dct streams skip the field
    MC path entirely (half the gather cost); the runtime picks the variant
    per picture.
    """

    def __init__(self, geom: PictureGeometry, field_support: bool = True):
        self.geom = geom
        self.field_support = field_support
        xs, ys, n_cb = CHROMA_INFO[geom.chroma_format]
        mbw, mbh = geom.mb_width, geom.mb_height
        mb_y, mb_x = np.divmod(np.arange(geom.n_mb), mbw)
        self._pos = {
            0: (jnp.asarray(mb_y * 16, jnp.int32), jnp.asarray(mb_x * 16, jnp.int32)),
            1: (jnp.asarray((mb_y * 16) >> ys, jnp.int32),
                jnp.asarray((mb_x * 16) >> xs, jnp.int32)),
        }
        self._fn = jax.jit(self._recon)
        self._fn_packed = jax.jit(self._recon_packed,
                                  static_argnames=("bidir",))
        self._zero_refs = None
        # Persistent host staging buffers, reused across pictures.
        # Keyed by (bucket capacity, parity) — double-buffered, and each
        # slot is guarded by the *consuming computation's outputs*: the JAX
        # CPU client ZERO-COPY ALIASES sufficiently small/aligned numpy
        # arrays (verified on jax 0.9: mutating the numpy source after
        # block_until_ready changes the "device" array), so a slot is
        # writable only once every computation that read it has finished —
        # blocking on the uploaded arrays alone is NOT enough.  This was
        # the root cause of the intermittent corrupted outputs that
        # conftest.py previously masked by disabling async dispatch.
        self._stage = {}
        self._stage_busy = {}
        self._stage_idx = 0
        # The staging buffers/parity/guards above are mutable: two threads
        # calling one instance must serialize upload+dispatch or they race
        # on staging memory.
        import threading
        self._call_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _band_pos(self, comp, band):
        """Per-MB top-left plane coordinates.  ``band=None``: the whole
        picture (cached static arrays).  ``band=(row0, mbh_local)``: the
        mbh_local MB rows starting at (traced) MB row ``row0`` — positions
        stay GLOBAL plane coordinates (the reference planes are full), only
        the tile grid is local."""
        if band is None:
            return self._pos[0 if comp == 0 else 1]
        row0, mbh_l = band
        g = self.geom
        xs, ys, _ = CHROMA_INFO[g.chroma_format]
        mb_y, mb_x = np.divmod(np.arange(mbh_l * g.mb_width), g.mb_width)
        py = jnp.asarray(mb_y * 16, jnp.int32) + row0 * 16
        px = jnp.asarray(mb_x * 16, jnp.int32)
        if comp == 0:
            return py, px
        return py >> ys, px >> xs

    def _pred_component(self, comp, padded0, padded1, fields0, fields1,
                        mv, mvfs, fwd, bwd, field_pred, h, w,
                        bidir: bool = True, band=None):
        cf = self.geom.chroma_format
        pos_y, pos_x = self._band_pos(comp, band)
        mvc = _scale_mv(mv, comp, cf)  # (n, 2, 2, 2)

        f = fwd[:, None, None]
        b = bwd[:, None, None]
        pf = mc_unidir_tiles(padded0, pos_y, pos_x,
                             mvc[:, 0, 0, 0], mvc[:, 0, 0, 1], h, w)
        if bidir:
            pb = mc_unidir_tiles(padded1, pos_y, pos_x,
                                 mvc[:, 0, 1, 0], mvc[:, 0, 1, 1], h, w)
            both = mc_bidir_tiles(pf, pb)
            pred = jnp.where(f & b, both,
                             jnp.where(f, pf, jnp.where(b, pb, jnp.uint8(0))))
        else:
            pred = jnp.where(f, pf, jnp.uint8(0))

        if self.field_support:
            units = []
            for r in range(2):
                uf = mc_field_tiles(fields0, mvfs[:, r, 0], pos_y >> 1, pos_x,
                                    mvc[:, r, 0, 0], mvc[:, r, 0, 1], h // 2, w)
                if bidir:
                    ub = mc_field_tiles(fields1, mvfs[:, r, 1], pos_y >> 1,
                                        pos_x, mvc[:, r, 1, 0],
                                        mvc[:, r, 1, 1], h // 2, w)
                    uboth = mc_bidir_tiles(uf, ub)
                    units.append(jnp.where(
                        f & b, uboth,
                        jnp.where(f, uf, jnp.where(b, ub, jnp.uint8(0)))))
                else:
                    units.append(jnp.where(f, uf, jnp.uint8(0)))
            ftile = jnp.stack(units, axis=2).reshape(pred.shape)
            pred = jnp.where(field_pred[:, None, None], ftile, pred)
        return pred

    def _residual_sparse(self, cblk, src):
        """IDCT only the coded blocks, then expand to the dense block grid
        by a row GATHER.

        ``cblk``: (cap, 64) int16 coefficient rows — uncoded blocks gather
        from a zeroed padding row; ``src``: (n_mb*blocks_per_mb,) int32
        sparse-row index per dense block (see _sparse_src_map)."""
        geom = self.geom
        res = idct_blocks_jnp(cblk)
        dense = res.reshape(cblk.shape[0], 64)[src]
        return dense.reshape(geom.n_mb, geom.blocks_per_mb, 8, 8)

    def _recon(self, coeff, dct_type, fwd, bwd, field_pred, coded, mv, mvfs,
               r0y, r0u, r0v, r1y, r1u, r1v):
        """Dense-coefficient entry (kept for row-sharded / stream-batch
        recon and the driver compile check)."""
        residual = idct_blocks_jnp(coeff)
        return self._recon_from_residual(residual, dct_type, fwd, bwd,
                                         field_pred, coded, mv, mvfs,
                                         r0y, r0u, r0v, r1y, r1u, r1v)

    def _recon_from_residual(self, residual, dct_type, fwd, bwd, field_pred,
                             coded, mv, mvfs, r0y, r0u, r0v, r1y, r1u, r1v,
                             bidir: bool = True, band=None):
        """``band=(row0, mbh_local)`` reconstructs only that horizontal
        band of MB rows (the shard body of the row-sharded mesh path):
        token tensors/residual cover the band's MBs, reference planes stay
        FULL (general MVs reach anywhere), and the returned planes are the
        band's rows."""
        geom = self.geom
        cf = geom.chroma_format
        xs, ys, n_cb = CHROMA_INFO[cf]
        c_cols = (16 >> xs) // 8
        c_rows = (16 >> ys) // 8
        inter_c = dct_type if cf != CHROMA_420 else None
        res = {
            0: _tiles_from_blocks(residual[:, :4], 2, 2, dct_type),
            1: _tiles_from_blocks(residual[:, 4:4 + n_cb], c_rows, c_cols, inter_c),
            2: _tiles_from_blocks(residual[:, 4 + n_cb:], c_rows, c_cols, inter_c),
        }

        # --- prediction ---
        refs = {0: (r0y, r1y), 1: (r0u, r1u), 2: (r0v, r1v)}
        planes = []
        mbh = band[1] if band is not None else geom.mb_height
        mbw = geom.mb_width
        for comp in range(3):
            p0, p1 = refs[comp]
            padded0, padded1 = pad_for_mc(p0), pad_for_mc(p1)
            if self.field_support:
                fields0 = jnp.stack([pad_for_mc(p0[0::2]), pad_for_mc(p0[1::2])])
                fields1 = jnp.stack([pad_for_mc(p1[0::2]), pad_for_mc(p1[1::2])])
            else:
                fields0 = fields1 = None
            h = 16 if comp == 0 else 16 >> ys
            w = 16 if comp == 0 else 16 >> xs
            pred = self._pred_component(comp, padded0, padded1, fields0,
                                        fields1, mv, mvfs, fwd, bwd,
                                        field_pred, h, w, bidir, band)
            # --- residual add + saturate + uncoded masking ---
            val = pred.astype(jnp.int16) + res[comp]
            tile = jnp.clip(val, 0, 255).astype(jnp.uint8)
            tile = jnp.where(coded[:, None, None], tile, jnp.uint8(0))
            planes.append(_plane_from_tiles(tile, mbh, mbw, h, w))
        return tuple(planes)

    def _recon_packed(self, cblk, cidx, meta, r0y, r0u, r0v, r1y, r1u, r1v,
                      bidir: bool = True):
        """Packed sparse-interface recon: coded coefficient rows + indices +
        one int16 metadata array in, and an extra flat uint8 output holding
        the three cropped planes concatenated — minimal host<->device
        traffic per picture.  All inputs arrive flat (1-D) and are reshaped
        on device."""
        n = self.geom.n_mb
        cblk = cblk.reshape(-1, 64)
        meta = meta.reshape(n, META_COLS)
        dct_type, fwd, bwd, field_pred, coded, mv, mvfs = _unpack_meta(meta)
        residual = self._residual_sparse(cblk, cidx)
        y, u, v = self._recon_from_residual(
            residual, dct_type, fwd, bwd, field_pred, coded, mv, mvfs,
            r0y, r0u, r0v, r1y, r1u, r1v, bidir=bidir)
        geom = self.geom
        xs, ys, _ = CHROMA_INFO[geom.chroma_format]
        cw = (geom.width + (1 << xs) - 1) >> xs
        ch = (geom.height + (1 << ys) - 1) >> ys
        packed = jnp.concatenate([
            y[:geom.height, :geom.width].reshape(-1),
            u[:ch, :cw].reshape(-1), v[:ch, :cw].reshape(-1)])
        return y, u, v, packed

    # ------------------------------------------------------------------
    def zero_planes(self):
        if self._zero_refs is None:
            g = self.geom
            self._zero_refs = tuple(
                jnp.zeros(s, jnp.uint8) for s in
                (g.luma_padded, g.chroma_padded, g.chroma_padded))
        return self._zero_refs

    def __call__(self, tokens: PictureTokens, ref0=None, ref1=None):
        y, u, v, _ = self.call_packed(tokens, ref0, ref1)
        return y, u, v

    def _upload(self, tokens: PictureTokens):
        g = self.geom
        n_rows = g.n_mb * g.blocks_per_mb
        k = tokens.n_coded_blocks
        cap = _bucket(k + 1, n_rows + 1)  # +1: reserved zero row
        idx = (cap, self._stage_idx)
        self._stage_idx ^= 1
        if idx not in self._stage:
            self._stage[idx] = (
                np.empty((cap, 64), np.int16),
                np.empty(n_rows, np.int32),
                np.zeros((g.n_mb, META_COLS), np.int16))
        if self._stage_busy.get(idx) is not None:
            # wait until the h2d copy that reads this slot has finished
            jax.block_until_ready(self._stage_busy[idx])
        sc, ss, sm = self._stage[idx]
        sc[:k] = tokens.cblk[:k]
        sc[k] = 0  # the zero row uncoded blocks gather from
        _sparse_src_map(tokens.cblk_idx, k, n_rows, dummy=k, out=ss)
        pack_meta(tokens, out=sm)
        # flat views (see _recon_packed)
        out = (jnp.asarray(sc.reshape(-1)), jnp.asarray(ss),
               jnp.asarray(sm.reshape(-1)))
        return out, idx

    def call_packed(self, tokens: PictureTokens, ref0=None, ref1=None):
        """Returns (y, u, v, packed_output); planes stay on device for use
        as references, packed_output is the single-transfer host payload."""
        if ref0 is None:
            ref0 = self.zero_planes()
        if ref1 is None:
            ref1 = self.zero_planes()
        with self._call_lock:
            (cblk, cidx, meta), slot = self._upload(tokens)
            out = self._fn_packed(cblk, cidx, meta, *ref0, *ref1,
                                  bidir=bool(tokens.bwd.any()))
            # Slot guard policy: _slot_guard (cpu aliases staging memory,
            # other backends wait on the upload).
            self._stage_busy[slot] = _slot_guard(out, (cblk, cidx, meta))
        return out


# Process-wide recon cache: compiled XLA programs are keyed by geometry +
# configuration, NOT by decoder instance — a second MP2VDecoder reuses the
# first one's compilations.
_GOP_RECONS: dict = {}


def gop_recon(geom: PictureGeometry, chunk: int,
              field_support: bool = False) -> "GopRecon":
    key = (geom, chunk, field_support)
    if key not in _GOP_RECONS:
        _GOP_RECONS[key] = GopRecon(geom, chunk, field_support=field_support)
    return _GOP_RECONS[key]


class GopRecon:
    """A chunk of pictures decoded in ONE XLA program: ``lax.scan`` over
    pictures with the two reference planes as carry, I/P/B reference
    selection and reference-list update expressed as data (per-step selects).

    This is the device analog of the reference's picture-pipeline
    parallelism (reference: threads.cpp picture ring): instead of
    overlapping pictures across worker threads, the whole dependency chain
    becomes one compiled program — one host->device upload and one packed
    device->host download per chunk, with XLA pipelining every step.

    Host->device traffic is near-entropy-sized: coefficients travel as flat
    sorted (flat_index, value) pairs of the nonzero entries only (~6 B per
    nonzero coefficient vs 128 B per dense block row).  On device one
    1-D scatter rebuilds the coded rows, ONE chunk-wide IDCT transforms
    them, and a row scatter places the residual blocks into the per-picture
    dense grid the scan steps consume.  At 1080p 4:2:0 a dense-row upload
    would be 100 MB per 16-picture chunk.
    """

    def __init__(self, geom: PictureGeometry, chunk: int,
                 field_support: bool = False):
        self.geom = geom
        self.chunk = chunk
        self.inner = DeviceRecon(geom, field_support=field_support)
        # within-picture dense-grid index fits uint16 for every geometry up
        # to ~2.7K-wide video; 0xFFFF is the padding sentinel
        self._scat_u16 = geom.n_mb * geom.blocks_per_mb < 0xFFFF
        self._fn = jax.jit(self._gop,
                           static_argnames=("cap_pairs", "cap_k", "bidir"))
        self._stage = {}       # keyed by (pair cap, row cap, parity)
        self._stage_busy = {}  # see DeviceRecon._upload slot guard
        self._stage_idx = 0
        self._packers = None
        self._nnz_scratch = None
        # gop_recon() shares instances process-wide; staging state is
        # mutable — concurrent decoders must serialize (see DeviceRecon).
        import threading
        self._call_lock = threading.Lock()
        # prepared-but-not-dispatched chunks are bounded so a staging slot
        # is never refilled before its blob was consumed (prepare/dispatch
        # may run on different pipeline threads)
        self._cv = threading.Condition()
        self._seq_prep = 0
        self._seq_disp = 0
        # shape variants that have been dispatched at least once; lets
        # prepare() fall back to a larger already-compiled bucket and
        # background-compile the exact one (no mid-stream compile stall)
        self._compiled: set = set()
        # When this instance is pure transport (StreamBatchRecon /
        # RowShardedRecon run their own jitted programs over the blob), the
        # external dispatcher registers the program that actually needs
        # warming here; ensure_compiled then warms THAT instead of self._fn.
        self.compile_hook = None
        # background-compile outcomes are observable (a permanently failing
        # exact-bucket compile would otherwise silently decode on oversized
        # buckets forever); the runtime folds these into decoder.stats
        self.stats = {"bucket_fallbacks": 0, "bg_compiles": 0,
                      "bg_compile_fails": 0}
        # in-flight background compiles: deduped (every fallback used to
        # re-spawn a thread for the same exact bucket — compiles piling up
        # concurrently with execution) and joinable (quiesce) so benches can separate compile from run
        self._bg_threads = {}

    def _layout(self, cap_pairs: int, cap_k: int):
        """Byte offsets of the seven sections inside the single
        consolidated upload blob (each 4-byte aligned): pair_pos uint8
        (column of each nonzero, 255 for padding), pair_val int16,
        row_nnz uint8 (nonzeros per coded row — pair row ids are rebuilt
        on device by scatter-add + cumsum), scat_pos (uint16
        within-picture index when the dense grid fits — the picture id is
        rebuilt on device from pic_k, halving the section — else int32
        absolute), pic_k int32 (coded rows per picture), step flags uint8
        (bit0 is_b, bit1 is_ip — folded in so the chunk costs ONE logical
        transfer), meta int16.  The blob itself uploads as two concurrent
        halves."""
        g = self.geom
        sb = 2 if self._scat_u16 else 4
        o0 = 0
        o1 = (o0 + cap_pairs + 3) & ~3           # pair_val
        o2 = (o1 + cap_pairs * 2 + 3) & ~3       # row_nnz
        o3 = (o2 + cap_k + 3) & ~3               # scat_pos
        o4 = (o3 + cap_k * sb + 3) & ~3          # pic_k
        o5 = o4 + self.chunk * 4                 # step flags
        o6 = (o5 + self.chunk + 3) & ~3          # meta
        cols = meta2_cols(self.inner.field_support)
        total = o6 + ((self.chunk * g.n_mb * cols * 2 + 3) & ~3)
        return (o0, o1, o2, o3, o4, o5, o6, total)

    def _decode_blob(self, blob, *, cap_pairs, cap_k):
        """Device-side transport decode: consolidated uint8 blob ->
        (residual dense (chunk, n_rows, 64) int16, meta (chunk, n_mb,
        cols) int16, step_flags (chunk,) uint8).  Shared by the GOP-chunk
        scan and the stream-batch vmap (parallel/mesh.py) — 'chunk'
        indexes pictures there streams."""
        inner = self.inner
        geom = self.geom
        n_rows = geom.n_mb * geom.blocks_per_mb
        o0, o1, o2, o3, o4, o5, o6, _ = self._layout(cap_pairs, cap_k)
        bc = jax.lax.bitcast_convert_type
        cols = meta2_cols(inner.field_support)
        pair_pos = blob[o0:o0 + cap_pairs]
        pair_val = bc(blob[o1:o1 + cap_pairs * 2].reshape(-1, 2), jnp.int16)
        row_nnz = blob[o2:o2 + cap_k]
        if self._scat_u16:
            # within-picture index + picture id rebuilt from per-picture
            # row counts (same scatter-add + cumsum trick as the pair row
            # ids below); 0xFFFF rows are padding
            s16 = bc(blob[o3:o3 + cap_k * 2].reshape(-1, 2),
                     jnp.uint16).astype(jnp.int32)
            pic_k = bc(blob[o4:o4 + self.chunk * 4].reshape(-1, 4),
                       jnp.int32)
            offp = jnp.cumsum(pic_k) - pic_k
            markp = jnp.zeros(cap_k, jnp.int32).at[offp].add(1, mode="drop")
            pic = jnp.cumsum(markp) - 1
            scat_pos = jnp.where(
                s16 == 0xFFFF,
                self.chunk * n_rows + jax.lax.iota(jnp.int32, cap_k),
                pic * n_rows + s16)
        else:
            scat_pos = bc(blob[o3:o3 + cap_k * 4].reshape(-1, 4), jnp.int32)
            # padding rows must not share one OOB index under
            # unique_indices=True (documented UB) — spread them
            scat_pos = jnp.where(
                scat_pos >= self.chunk * n_rows,
                self.chunk * n_rows + jax.lax.iota(jnp.int32, cap_k),
                scat_pos)
        flags = blob[o5:o5 + self.chunk]
        nm = self.chunk * geom.n_mb * cols
        meta = bc(blob[o6:o6 + nm * 2].reshape(-1, 2), jnp.int16)
        meta = meta.reshape(self.chunk, geom.n_mb, cols)

        # 1) nonzero pairs -> coded coefficient rows.  The row id of each
        #    pair is reconstructed from per-row nonzero counts: rows mark
        #    their start offset (scatter-add — empty rows and the padding
        #    rows collapse onto the same offset), an inclusive cumsum then
        #    counts the rows whose offset <= pair position.  Padding pairs
        #    (pos=255) and empty-row artifacts land out of range and are
        #    dropped by the scatter.
        off = jnp.cumsum(row_nnz.astype(jnp.int32)) - row_nnz.astype(jnp.int32)
        mark = jnp.zeros(cap_pairs, jnp.int32).at[off].add(
            1, mode="drop")
        row = jnp.cumsum(mark) - 1
        pair_idx = row * 64 + pair_pos.astype(jnp.int32)
        # padding pairs (pos=255) must not share one duplicate index under
        # unique_indices=True (documented UB even though mode='drop' would
        # discard them): give each a distinct ascending OOB index — all
        # >= cap_k*64 > every real index, so sortedness also holds
        pair_idx = jnp.where(pair_pos == 255,
                             cap_k * 64 + jax.lax.iota(jnp.int32, cap_pairs),
                             pair_idx)
        coeff = jnp.zeros(cap_k * 64, jnp.int16).at[pair_idx].set(
            pair_val, indices_are_sorted=True, unique_indices=True,
            mode="drop").reshape(cap_k, 64)
        # 2) one IDCT over every coded block of the whole chunk
        res_rows = idct_blocks_jnp(coeff)
        res_rows = res_rows.reshape(cap_k, 64)
        # 3) place residual blocks into the per-picture dense grid
        dense = jnp.zeros((self.chunk * n_rows, 64), jnp.int16).at[
            scat_pos].set(res_rows, unique_indices=True, mode="drop")
        return dense.reshape(self.chunk, n_rows, 64), meta, flags

    def _gop(self, blob_a, blob_b, r0y, r0u, r0v, r1y, r1u, r1v,
             *, cap_pairs, cap_k, bidir=True):
        """``bidir=False`` compiles the forward-only program — chosen
        statically when no picture of the chunk is B-coded (I/P-only
        streams, and every I/P step on the chunk=1 latency path).  A static
        program split costs one extra compile; within a bidir chunk every
        step runs the bidir gathers and I/P steps gather from ref1 twice."""
        inner = self.inner
        geom = self.geom
        # the blob arrives as two concurrently-uploaded halves
        blob = jnp.concatenate([blob_a, blob_b])
        dense, meta, flags = self._decode_blob(blob, cap_pairs=cap_pairs,
                                               cap_k=cap_k)
        is_b = (flags & 1) != 0
        is_ip = (flags & 2) != 0
        xs_, ys_, _ = CHROMA_INFO[geom.chroma_format]
        cw = (geom.width + (1 << xs_) - 1) >> xs_
        ch = (geom.height + (1 << ys_) - 1) >> ys_

        def step(carry, xs):
            r0, r1 = carry
            res, m, b_flag, ip_flag = xs
            dct_type, fwd, bwd, field_pred, coded, mv, mvfs = _unpack_meta2(
                m, inner.field_support)
            residual = res.reshape(geom.n_mb, geom.blocks_per_mb, 8, 8)
            # B pictures predict from (older, newer); I/P from (newer, -)
            ref0u = tuple(jnp.where(b_flag, a, b) for a, b in zip(r0, r1))
            out = inner._recon_from_residual(
                residual, dct_type, fwd, bwd, field_pred, coded, mv,
                mvfs, *ref0u, *r1, bidir=bidir)
            packed = jnp.concatenate([
                out[0][:geom.height, :geom.width].reshape(-1),
                out[1][:ch, :cw].reshape(-1), out[2][:ch, :cw].reshape(-1)])
            # reference-list update (reference: decoder.cpp:299-304)
            new_r0 = tuple(jnp.where(ip_flag, b, a) for a, b in zip(r0, r1))
            new_r1 = tuple(jnp.where(ip_flag, o, b) for o, b in zip(out, r1))
            return (new_r0, new_r1), packed

        (r0, r1), packs = jax.lax.scan(
            step, ((r0y, r0u, r0v), (r1y, r1u, r1v)),
            (dense, meta, is_b, is_ip))
        return (*r0, *r1, packs)

    def _staging(self, cap_pairs, cap_k, parity):
        """Persistent staging blob + typed section views (parity
        double-buffered so chunk N+1's fill can overlap chunk N's h2d)."""
        key = (cap_pairs, cap_k, parity)
        if self._stage.get(key) is None:
            g = self.geom
            cols = meta2_cols(self.inner.field_support)
            o0, o1, o2, o3, o4, o5, o6, total = self._layout(cap_pairs,
                                                             cap_k)
            sdt, sb = (np.uint16, 2) if self._scat_u16 else (np.int32, 4)
            blob = np.zeros(total, np.uint8)
            self._stage[key] = (
                blob,
                blob[o0:o0 + cap_pairs],
                blob[o1:o1 + cap_pairs * 2].view(np.int16),
                blob[o2:o2 + cap_k],
                blob[o3:o3 + cap_k * sb].view(sdt),
                blob[o4:o4 + self.chunk * 4].view(np.int32),
                blob[o5:o5 + self.chunk],
                blob[o6:o6 + self.chunk * g.n_mb * cols * 2].view(
                    np.int16).reshape(self.chunk, g.n_mb, cols))
        return self._stage[key]

    # number of staging slots per (cap_pairs, cap_k): bounds how many
    # prepared-but-not-uploaded chunks can be in flight
    N_SLOTS = 3

    def __call__(self, tokens_list, pct_list, ref0=None, ref1=None):
        """tokens_list: up to ``chunk`` PictureTokens (padded internally with
        no-op pictures); pct_list: picture_coding_type per picture.
        Returns (ref0, ref1, packed (chunk, frame_bytes)) — caller takes
        packed[:len(tokens_list)]."""
        staged = self.prepare(tokens_list, pct_list)
        return self.dispatch(staged, ref0, ref1)

    def prepare(self, tokens_list, pct_list):
        """Stage 1, host-only: pack nonzero (column, value) pairs + per-row
        counts + metadata into a staging slot.  Pairs are globally sorted:
        sparse rows are numbered in claim order per picture, pictures in
        chunk order, each row walked column-major — strictly ascending.
        The scans run in the C extension when available (single linear
        pass at memory speed, ~10x numpy nonzero/bincount/fancy-indexing).

        Returns an opaque staged tuple for :meth:`dispatch`.  Safe to call
        from a fill thread while another thread dispatches earlier chunks;
        calls themselves are serialized by an internal lock and slots are
        recycled only after their upload completed."""
        with self._call_lock:
            return self._prepare_impl(tokens_list, pct_list)

    def _prepare_impl(self, tokens_list, pct_list):
        t = len(tokens_list)
        assert 0 < t <= self.chunk
        g = self.geom
        n_rows = g.n_mb * g.blocks_per_mb

        if self._packers is None:
            self._packers = _load_packers()
        count_pairs, pack_pairs_fn = self._packers
        total_k = sum(tok.n_coded_blocks for tok in tokens_list)
        cap_k = _ladder(total_k + 1)
        if self._nnz_scratch is None or len(self._nnz_scratch) < cap_k:
            self._nnz_scratch = np.empty(cap_k, np.uint8)
        nnz = self._nnz_scratch
        total_nz = 0
        off = 0
        for tok in tokens_list:
            k = tok.n_coded_blocks
            if tok.row_nnz is not None:
                # per-row nonzero counts were produced DURING the native
                # parse — no counting re-read of the coefficient rows
                nnz[off:off + k] = tok.row_nnz[:k]
                total_nz += int(tok.row_nnz[:k].sum(dtype=np.int64))
            else:
                total_nz += count_pairs(np.ascontiguousarray(tok.cblk[:k]),
                                        nnz[off:off + k])
            off += k
        cap_pairs = _ladder(total_nz + 1, lo=4096)
        # never stall the pipeline on a new shape variant: pick the
        # smallest already-compiled bucket that fits (more padding, same
        # result) and compile the exact one in the background for
        # subsequent chunks
        exact = (cap_pairs, cap_k)
        if self._compiled and exact not in self._compiled:
            fits = [c for c in self._compiled
                    if c[0] >= cap_pairs and c[1] >= cap_k]
            if fits:
                import threading
                if exact not in self._bg_threads:
                    # non-daemon: a daemon thread killed mid-XLA-compile at
                    # interpreter shutdown aborts the process (glibc
                    # "FATAL: exception not rethrown", observed r5);
                    # interpreter exit instead joins the in-flight compile
                    th = threading.Thread(target=self._ensure_quiet,
                                          args=exact, daemon=False)
                    self._bg_threads[exact] = th
                    th.start()
                self.stats["bucket_fallbacks"] += 1
                cap_pairs, cap_k = min(
                    fits, key=lambda c: self._layout(c[0], c[1])[-1])
        with self._cv:
            while self._seq_prep - self._seq_disp >= self.N_SLOTS - 1:
                self._cv.wait()
            self._seq_prep += 1
        key = (cap_pairs, cap_k, self._stage_idx)
        self._stage_idx = (self._stage_idx + 1) % self.N_SLOTS
        blob, pp, pv, pn, sp, pk, fl, sm = self._staging(cap_pairs, cap_k,
                                                         key[2])
        if self._stage_busy.get(key) is not None:
            jax.block_until_ready(self._stage_busy[key])
            self._stage_busy[key] = None
        pn[:off] = nnz[:off]
        p = 0
        off = 0
        fs = self.inner.field_support
        for i, tok in enumerate(tokens_list):
            k = tok.n_coded_blocks
            p += pack_pairs_fn(np.ascontiguousarray(tok.cblk[:k]),
                               pp[p:], pv[p:])
            if self._scat_u16:
                sp[off:off + k] = tok.cblk_idx[:k].astype(np.uint16)
            else:
                sp[off:off + k] = i * n_rows + tok.cblk_idx[:k]
            pk[i] = k
            off += k
            pack_meta2(tok, fs, out=sm[i])
        assert p == total_nz
        pp[p:] = 255                 # padding pairs resolve out of range
        pn[off:] = 0
        sp[off:] = 0xFFFF if self._scat_u16 else self.chunk * n_rows
        pk[t:] = 0
        if t < self.chunk:
            sm[t:] = 0
        is_b = np.zeros(self.chunk, bool)
        is_b[:t] = [pc == 3 for pc in pct_list]
        is_b[t:] = True  # padding steps must not touch the reference list
        fl[:] = is_b.astype(np.uint8) | ((~is_b).astype(np.uint8) << 1)
        return (key, blob)

    def dispatch(self, staged, ref0=None, ref1=None, bidir: bool = True):
        """Stage 2: upload the staged blob and dispatch the chunk program.
        Must be called in chunk order (the reference planes are a carry);
        returns (ref0, ref1, packed).  ``bidir=False`` selects the
        forward-only program — only valid when no picture in the chunk is
        B-coded."""
        key, blob = staged
        cap_pairs, cap_k = key[0], key[1]
        if ref0 is None:
            ref0 = self.inner.zero_planes()
        if ref1 is None:
            ref1 = self.inner.zero_planes()
        try:
            up = _upload_split(blob)
            out = self._fn(*up, *ref0, *ref1,
                           cap_pairs=cap_pairs, cap_k=cap_k, bidir=bidir)
            # Slot guard policy: _slot_guard (cpu aliases the staging
            # memory so the outputs guard it; other backends wait on the
            # uploaded halves).
            self._stage_busy[key] = _slot_guard(out, up)
            self._compiled.add((cap_pairs, cap_k))
        finally:
            # release the staging-slot bound even on failure (a stuck
            # prepare() would otherwise deadlock the fill thread)
            with self._cv:
                self._seq_disp += 1
                self._cv.notify_all()
        r0, r1, packs = out[0:3], out[3:6], out[6]
        return r0, r1, packs

    def mark_dispatched(self, staged, guard) -> None:
        """Release a staged slot on behalf of an external dispatcher
        (StreamBatchRecon runs its own jitted program over the blob).
        ``guard``: array whose readiness implies the blob was consumed —
        the uploaded copy on device backends, a computation output on CPU
        (zero-copy aliasing, see DeviceRecon.__init__)."""
        key = staged[0]
        self._stage_busy[key] = guard
        self._compiled.add((key[0], key[1]))
        with self._cv:
            self._seq_disp += 1
            self._cv.notify_all()

    def _ensure_quiet(self, cap_pairs: int, cap_k: int):
        """Background-thread wrapper around ensure_compiled: failures are
        non-fatal (the stream keeps decoding on the oversized fallback
        bucket) but COUNTED — a permanently failing exact-bucket compile
        shows up in decoder.stats instead of silently padding forever."""
        try:
            self.ensure_compiled(cap_pairs, cap_k)
            self.stats["bg_compiles"] += 1
        except Exception:
            self.stats["bg_compile_fails"] += 1
        finally:
            self._bg_threads.pop((cap_pairs, cap_k), None)

    def quiesce(self) -> None:
        """Join outstanding background compiles.  Benches call this after
        warmup so the timed region measures execution, not compilation
        contending with it."""
        for th in list(self._bg_threads.values()):
            th.join()

    def ensure_compiled(self, cap_pairs: int, cap_k: int):
        """Compile the (cap_pairs, cap_k) shape variant if unseen — called
        from a background thread on first sight of a new bucket so a
        mid-stream density change doesn't stall the pipeline on a compile.

        Compilation only (lower().compile()) — no device execution
        concurrent with the real pipeline.  When an external dispatcher
        (StreamBatchRecon/RowShardedRecon) registered a compile_hook, warm
        ITS program — that is what will actually run — instead of the
        GopRecon scan."""
        if self.compile_hook is not None:
            self.compile_hook(cap_pairs, cap_k)
            self._compiled.add((cap_pairs, cap_k))
            return
        total = self._layout(cap_pairs, cap_k)[-1]
        half = _split_point(total)
        sds = jax.ShapeDtypeStruct
        blob_a = sds((half,), jnp.uint8)
        blob_b = sds((total - half,), jnp.uint8)
        g = self.geom
        planes = (sds(g.luma_padded, jnp.uint8),
                  sds(g.chroma_padded, jnp.uint8),
                  sds(g.chroma_padded, jnp.uint8))
        self._fn.lower(blob_a, blob_b, *planes, *planes,
                       cap_pairs=cap_pairs, cap_k=cap_k).compile()
        if self.chunk == 1:
            # the per-picture latency path uses both static programs
            # (fwd-only for I/P, bidir for B) of every bucket
            self._fn.lower(blob_a, blob_b, *planes, *planes,
                           cap_pairs=cap_pairs, cap_k=cap_k,
                           bidir=False).compile()
        self._compiled.add((cap_pairs, cap_k))
