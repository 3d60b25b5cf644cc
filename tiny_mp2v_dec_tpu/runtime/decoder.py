"""Production decoder: host parse/tokenize -> device reconstruction.

The device counterpart of the reference's ``mp2v_decoder_c``
(reference: src/core/decoder.h:82-131, decoder.cpp:278-329): the host walks
start codes, maintains sequence/picture state and the two-slot reference
list, tokenizes each picture's slices into dense tensors (native C++
tokenizer when built, Python fallback), and dispatches one compiled XLA
reconstruction per picture.  Reference planes live on device between
pictures; display reordering matches decoder.cpp:346-379.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import headers as H
from ..golden.decoder import DecodedFrame, scan_start_codes
from ..tokenizer import get_tokenizer
from ..tokenizer.types import CHROMA_INFO, PictureGeometry, PictureParams, PictureTokens


@dataclass
class DecoderConfig:
    """Mirrors the reference's decoder_config_t (decoder.h:25-32) plus the
    device batching knobs."""
    width: int = 0                # 0 = take from the sequence header
    height: int = 0
    chroma_format: int = 0
    # max undelivered pictures in flight on device (0 = unbounded) —
    # back-pressure, reference: threads.cpp:161-169.  Applies uniformly:
    # every path (per-picture, gop_chunk, mesh="rows") routes frames
    # through _emit, which blocks on the oldest undelivered frame's
    # device buffer once the pool is exceeded.  The chunk path ALSO
    # bounds in-flight device chunks (<=3 submitted, <=2 unfinished) and
    # staging slots (3), which cap device/host memory independently of
    # frame delivery.  NOTE: with gop_chunk > pictures_pool_size and no
    # consumer draining frames, the back-pressure engages INSIDE each
    # chunk and serializes chunk N's execution with chunk N+1's dispatch
    # — for throughput measurement with device-resident frames use
    # pool=0 (unbounded) or pool >= 2*gop_chunk.
    pictures_pool_size: int = 10
    num_threads: int = 0          # 0 = auto (native tokenizer threads)
    reordering: bool = True
    # >0: decode pictures in chunks of this size as ONE device program
    # (lax.scan over the GOP) — max throughput; 0: picture-at-a-time (min
    # latency).
    gop_chunk: int = 0
    # False: deliver frames as device-resident LazyFrame objects (planes
    # pulled to host only on attribute access) — the mode for device-side
    # consumers and for throughput measurement (the reference's README
    # likewise advises timing with file output off, README.md:48).
    output_host: bool = True
    # Multi-card scale-out: "rows" shards each picture's MB rows across all
    # local devices (latency mode; reference planes all-gather over the
    # links between cards).  None = one card.  ``decode_batch`` (throughput
    # mode: one stream per card) is independent of this knob.  The device
    # analog of the reference's worker threading (reference:
    # decoder.cpp:381-406).
    mesh: Optional[str] = None
    mesh_devices: int = 0         # 0 = all local devices
    # "raise": abort the decode on the first malformed slice; "drop_slice":
    # error containment — the bad slice's parsed prefix is kept, every
    # other slice/picture decodes normally, stats["bad_slices"] counts the
    # drops (the reference silently decodes garbage instead,
    # reference: src/core/mp2v_vlc_dec.hpp:69)
    on_error: str = "raise"


def _fetch_concurrent(packed):
    """Device->host pull as two concurrent transfers."""
    if packed.ndim < 1 or packed.shape[0] < 2:
        return np.asarray(packed)
    from ..ops.recon import _fetch_pool
    half = packed.shape[0] // 2
    fa = _fetch_pool().submit(np.asarray, packed[:half])
    fb = _fetch_pool().submit(np.asarray, packed[half:])
    return np.concatenate([fa.result(), fb.result()])


class LazyFrame:
    """A decoded frame whose planes live on device until first access."""

    def __init__(self, packed, index, geom: PictureGeometry,
                 temporal_reference: int, picture_coding_type: int,
                 shared=None):
        self._packed = packed      # device array (chunk, bytes) or (bytes,)
        self._index = index        # row within a chunk, or None
        self._geom = geom
        self._host = None
        # frames of one decoded chunk share a single device->host transfer
        self._shared = shared if shared is not None else [None]
        self.temporal_reference = temporal_reference
        self.picture_coding_type = picture_coding_type

    def device_buffer(self):
        return self._packed

    def _flat(self):
        if self._host is None:
            if self._shared[0] is None:
                self._shared[0] = _fetch_concurrent(self._packed)
            arr = self._shared[0]
            self._host = arr if self._index is None else arr[self._index]
        return self._host

    @property
    def y(self):
        g = self._geom
        return self._flat()[:g.height * g.width].reshape(g.height, g.width)

    def _chroma(self, second):
        g = self._geom
        xs, ys, _ = CHROMA_INFO[g.chroma_format]
        cw = (g.width + (1 << xs) - 1) >> xs
        ch = (g.height + (1 << ys) - 1) >> ys
        ny = g.height * g.width
        nc = ch * cw
        off = ny + (nc if second else 0)
        return self._flat()[off:off + nc].reshape(ch, cw)

    @property
    def u(self):
        return self._chroma(False)

    @property
    def v(self):
        return self._chroma(True)

    def tobytes(self) -> bytes:
        return self.y.tobytes() + self.u.tobytes() + self.v.tobytes()


class PlanesFrame:
    """A decoded frame backed by (possibly sharded) device planes."""

    def __init__(self, planes, geom: PictureGeometry,
                 temporal_reference: int, picture_coding_type: int):
        self._planes = planes      # (y, u, v) padded device planes
        self._geom = geom
        self._host = None
        self.temporal_reference = temporal_reference
        self.picture_coding_type = picture_coding_type

    def device_buffer(self):
        return self._planes

    def _fetch(self):
        if self._host is None:
            from ..ops.recon import _fetch_pool
            self._host = tuple(_fetch_pool().map(np.asarray, self._planes))
        return self._host

    _flat = _fetch  # uniform materialization hook (see MP2VDecoder._drain)

    @property
    def y(self):
        g = self._geom
        return self._fetch()[0][:g.height, :g.width]

    def _chroma(self, i):
        g = self._geom
        xs, ys, _ = CHROMA_INFO[g.chroma_format]
        cw = (g.width + (1 << xs) - 1) >> xs
        ch = (g.height + (1 << ys) - 1) >> ys
        return self._fetch()[i][:ch, :cw]

    @property
    def u(self):
        return self._chroma(1)

    @property
    def v(self):
        return self._chroma(2)

    def tobytes(self) -> bytes:
        return self.y.tobytes() + self.u.tobytes() + self.v.tobytes()


class MP2VDecoder:
    """Decode MPEG-2 elementary streams to YUV frames on the device.

    Frames are delivered to ``renderer`` (if given) and returned from
    ``decode`` in display order (or decode order with reordering off).
    """

    def __init__(self, config: DecoderConfig = DecoderConfig(),
                 renderer: Optional[Callable[[DecodedFrame], None]] = None):
        self.config = config
        self.renderer = renderer
        self.tokenize_picture = get_tokenizer(config.num_threads,
                                              config.on_error)
        self._recons = {}
        self.reset()

    def reset(self) -> None:
        if getattr(self, "_chunk_jobs", None):
            self._join_chunks()
        self._chunk_jobs = []
        if not hasattr(self, "_fill_pool"):
            # created lazily, persist across resets: fill thread packs
            # chunk N+1's staging while the dispatch thread uploads/runs
            # chunk N and the main thread tokenizes chunk N+2
            self._fill_pool = None
            self._disp_pool = None
        self.seq: Optional[H.SequenceHeader] = None
        self.sext = H.SequenceExtension()
        self.sscal = None
        self.gop = None
        self.qmext = None
        self._refs = [None, None]      # device plane tuples, decode order
        self._reorder_slot = None
        self._out_fifo = []            # pending frames with in-flight copies
        self.user_data: List[bytes] = []  # reference: decoder.cpp:194-200
        self._chunk: List[tuple] = []  # (tokens, geom, ph) awaiting batch
        self._frames: List[DecodedFrame] = []
        self._recon_snaps = {}         # id(recon) -> last stats snapshot
        self.stats = {"pictures": 0, "tokenize_s": 0.0, "fill_s": 0.0,
                      "device_s": 0.0, "output_s": 0.0,
                      # transport shape-variant observability: a permanently
                      # failing background compile (bg_compile_fails keeps
                      # rising while bucket_fallbacks does too) means the
                      # stream is stuck decoding on oversized buckets
                      "bucket_fallbacks": 0, "bg_compiles": 0,
                      "bg_compile_fails": 0,
                      # error-containment counter (on_error="drop_slice")
                      "bad_slices": 0}

    # ------------------------------------------------------------------
    def _gop_recon_for(self, geom: PictureGeometry, field_support: bool,
                       size: int = 0):
        from ..ops.recon import gop_recon
        return gop_recon(geom, size or self.config.gop_chunk,
                         field_support=field_support)

    @staticmethod
    def _tail_chunk_size(t: int, full: int) -> int:
        """Compiled chunk size for a tail of t pictures: the next power of
        two (so a 17-picture stream costs 16+1 scan steps, not 32)."""
        s = 1
        while s < t:
            s <<= 1
        return min(s, full)

    def _mesh_recon_for(self, geom: PictureGeometry, field_support: bool):
        from ..parallel.mesh import RowShardedRecon, make_mesh
        key = (geom, field_support, "rows")
        if key not in self._recons:
            n = self.config.mesh_devices or None
            mesh = make_mesh(n, axes=("row",))
            self._recons[key] = RowShardedRecon(geom, mesh,
                                                field_support=field_support)
        return self._recons[key]

    def _emit(self, pending) -> None:
        """Queue a decoded picture (its device->host copy is already in
        flight); materialization is deferred one picture so the transfer
        overlaps the next picture's decode.  ``pictures_pool_size`` bounds
        the number of undelivered pictures in flight — the back-pressure
        the reference applies by blocking ``create_task`` until a ring slot
        recycles (reference: threads.cpp:161-169)."""
        self._out_fifo.append(pending)
        pool = self.config.pictures_pool_size
        if pool > 0 and len(self._out_fifo) > pool:
            import jax
            oldest = self._out_fifo[0]
            jax.block_until_ready(oldest.device_buffer())

    def _drain(self, keep_last: bool) -> None:
        keep = 1 if keep_last else 0
        while len(self._out_fifo) > keep:
            frame = self._out_fifo.pop(0)
            if self.config.output_host:
                t0 = time.perf_counter()
                frame._flat()
                self.stats["output_s"] += time.perf_counter() - t0
            if self.renderer is not None:
                self.renderer(frame)
            self._frames.append(frame)

    # ------------------------------------------------------------------
    def decode(self, data: bytes) -> List[DecodedFrame]:
        self._frames = []
        self._walk(data, self._decode_picture)
        self.flush()
        return self._frames

    def _walk(self, data: bytes, on_picture) -> None:
        """Start-code dispatch loop (reference: decoder.cpp:278-329);
        ``on_picture(data, cur)`` fires once per complete picture."""
        cur = None
        ended = False
        offs = [int(o) for o in scan_start_codes(data)]
        for i, off in enumerate(offs):
            code = data[off + 3]
            r_pos = (off + 4) * 8
            if code == H.USER_DATA_START_CODE:
                # capture user data verbatim (reference: decoder.cpp:194-200)
                end = offs[i + 1] if i + 1 < len(offs) else len(data)
                self.user_data.append(data[off + 4:end])
                continue
            if code == H.SEQUENCE_HEADER_CODE:
                self.seq = H.SequenceHeader.parse(H.BitReader(data, r_pos))
                # spec 6.3.11: sequence header resets downloaded matrices
                self.qmext = None
            elif code == H.EXTENSION_START_CODE:
                r = H.BitReader(data, r_pos)
                ext_id = r.read(4)
                if ext_id == H.SEQUENCE_EXTENSION_ID:
                    self.sext = H.SequenceExtension.parse(r)
                elif ext_id == H.SEQUENCE_SCALABLE_EXTENSION_ID:
                    self.sscal = H.SequenceScalableExtension.parse(r)
                elif ext_id == H.PICTURE_CODING_EXTENSION_ID and cur is not None:
                    cur["pcext"] = H.PictureCodingExtension.parse(r)
                elif ext_id == H.QUANT_MATRIX_EXTENSION_ID:
                    # persists across pictures until the next sequence header
                    self.qmext = H.QuantMatrixExtension.parse(r)
            elif code == H.GROUP_START_CODE:
                self.gop = H.GroupOfPicturesHeader.parse(H.BitReader(data, r_pos))
            elif code == H.PICTURE_START_CODE:
                if cur is not None:
                    on_picture(data, cur)
                ph = H.PictureHeader.parse(H.BitReader(data, r_pos))
                cur = {"header": ph,
                       "pcext": H.PictureCodingExtension(
                           f_code=((ph.forward_f_code,) * 2,
                                   (ph.backward_f_code,) * 2)),
                       "slices": []}
            elif code in (H.SEQUENCE_END_CODE, H.SEQUENCE_ERROR_CODE):
                if cur is not None:
                    on_picture(data, cur)
                    cur = None
                ended = True
                break
            elif H.SLICE_START_CODE_MIN <= code <= H.SLICE_START_CODE_MAX:
                if cur is not None:
                    cur["slices"].append((r_pos, code))
        if cur is not None:
            on_picture(data, cur)

    def flush(self) -> None:
        self._flush_chunk()
        self._join_chunks()
        if self._reorder_slot is not None:
            self._emit(self._reorder_slot)
            self._reorder_slot = None
        self._drain(keep_last=False)

    def tokenize_stream(self, data: bytes):
        """Host-only pass: parse + tokenize every picture of a stream.
        Returns [(PictureTokens, PictureGeometry, PictureHeader), ...]."""
        out = []
        self._walk(data, lambda d, cur: out.append(self._picture_tokens(d, cur)))
        return out

    def decode_batch(self, streams: List[bytes]) -> List[List[DecodedFrame]]:
        """Decode N independent streams data-parallel, one shard per card
        (StreamBatchRecon) — the serving/throughput scale-out.  Streams may
        have entirely different GOP structures and lengths: per-stream
        picture types are data (is_b/is_ip selects inside the batched
        program), shorter streams pad with no-op pictures, and streams are
        grouped by geometry (one batched decode per geometry group).
        Per-stream reference lists ride a stacked (N, H, W) plane axis.
        Returns per-stream frame lists in display order.  The multi-stream
        analog of the reference's content-agnostic picture-pipeline workers
        (reference: threads.cpp:100-159)."""
        assert streams, "no streams"

        def tokenize_one(s):
            # each stream gets its own decoder shell: header state is
            # per-stream, and the instances share compiled recons anyway
            shell = MP2VDecoder(self.config)
            return shell.tokenize_stream(s)

        from concurrent.futures import ThreadPoolExecutor
        import os as _os
        with ThreadPoolExecutor(
                max_workers=min(len(streams), _os.cpu_count() or 2)) as ex:
            seqs = list(ex.map(tokenize_one, streams))

        out_frames: List[List[DecodedFrame]] = [[] for _ in streams]
        by_geom: dict = {}
        for i, q in enumerate(seqs):
            assert q, f"stream {i} has no pictures"
            by_geom.setdefault(q[0][1], []).append(i)
        for geom, idxs in by_geom.items():
            group = [seqs[i] for i in idxs]
            frames = self._decode_batch_group(geom, group)
            for i, fl in zip(idxs, frames):
                out_frames[i] = fl
        return out_frames

    def _decode_batch_group(self, geom: PictureGeometry, seqs):
        from ..parallel.mesh import StreamBatchRecon, make_mesh
        from ..tokenizer.types import PictureTokens
        field = any(bool(t.field_pred.any()) for q in seqs for t, _, _ in q)
        S = len(seqs)
        import jax
        avail = self.config.mesh_devices or len(jax.devices())
        n = max(d for d in range(1, min(S, avail) + 1) if S % d == 0)
        sb = StreamBatchRecon(geom, make_mesh(n, axes=("stream",)),
                              field_support=field, n_streams=S)
        noop = PictureTokens.empty(geom)   # all-uncoded padding picture
        refs0 = refs1 = None
        n_steps = max(len(q) for q in seqs)
        out_frames: List[List[DecodedFrame]] = [[] for _ in range(S)]
        reorder: List[Optional[PlanesFrame]] = [None] * S

        def emit(i, frame):
            if self.config.output_host:
                frame._fetch()
            out_frames[i].append(frame)

        for idx in range(n_steps):
            toks, is_b, is_ip, phs = [], [], [], []
            for q in seqs:
                if idx < len(q):
                    t, _, ph = q[idx]
                    toks.append(t)
                    is_b.append(ph.picture_coding_type == H.PCT_B)
                    is_ip.append(ph.picture_coding_type != H.PCT_B)
                    phs.append(ph)
                else:
                    # padding: decodes to nothing, leaves the refs alone
                    toks.append(noop)
                    is_b.append(True)
                    is_ip.append(False)
                    phs.append(None)
            refs0, refs1, (y, u, v) = sb.step(toks, is_b, is_ip,
                                              refs0, refs1)
            for i in range(S):
                ph = phs[i]
                if ph is None:
                    continue
                frame = PlanesFrame((y[i], u[i], v[i]), geom,
                                    ph.temporal_reference,
                                    ph.picture_coding_type)
                if is_ip[i] and self.config.reordering:
                    if reorder[i] is not None:
                        emit(i, reorder[i])
                    reorder[i] = frame
                else:
                    emit(i, frame)
        for i in range(S):
            if reorder[i] is not None:
                emit(i, reorder[i])
        return out_frames

    def _route_frame(self, pending, pct: int) -> None:
        """Display reordering (reference: decoder.cpp:346-379)."""
        if pct in (H.PCT_I, H.PCT_P) and self.config.reordering:
            if self._reorder_slot is not None:
                self._emit(self._reorder_slot)
            self._reorder_slot = pending
        else:
            self._emit(pending)

    def _flush_chunk(self) -> None:
        """Hand the collected chunk to the two-stage reconstruction
        pipeline: a fill thread packs the staging blob (GopRecon.prepare),
        a dispatch thread uploads + runs the chunk program
        (GopRecon.dispatch) and owns the device reference list.  So at
        steady state: main thread tokenizes chunk N+2, fill thread packs
        N+1, dispatch thread uploads N while the device still executes
        N-1 — the wall clock per chunk is the slowest single stage, not
        their sum."""
        if not self._chunk:
            return
        batch, self._chunk = self._chunk, []
        if self._fill_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._fill_pool = ThreadPoolExecutor(max_workers=1)
            self._disp_pool = ThreadPoolExecutor(max_workers=1)
        geom = batch[0][1]
        tokens_list = [b[0] for b in batch]
        pcts = [b[2].picture_coding_type for b in batch]
        field = any(bool(t.field_pred.any()) for t in tokens_list)
        size = self._tail_chunk_size(len(batch), self.config.gop_chunk)
        recon = self._gop_recon_for(geom, field, size)
        fill_f = self._fill_pool.submit(self._fill_job, recon,
                                        tokens_list, pcts)
        disp_f = self._disp_pool.submit(self._disp_job, recon, fill_f, batch)
        self._chunk_jobs.append(disp_f)
        # bound in-flight chunks (device memory back-pressure) and surface
        # worker exceptions promptly
        while len(self._chunk_jobs) > 2:
            self._chunk_jobs.pop(0).result()

    def _join_chunks(self) -> None:
        while self._chunk_jobs:
            self._chunk_jobs.pop(0).result()

    def _fill_job(self, recon, tokens_list, pcts):
        t0 = time.perf_counter()
        staged = recon.prepare(tokens_list, pcts)
        self.stats["fill_s"] += time.perf_counter() - t0
        return staged

    def _disp_job(self, recon, fill_f, batch) -> None:
        """Dispatch-thread body: sequential across chunks (one executor
        thread), owns the device reference list."""
        staged = fill_f.result()
        geom = batch[0][1]
        t0 = time.perf_counter()
        # B-free chunks (I/P-only streams) run the forward-only program —
        # half the MC gather cost
        bidir = any(ph.picture_coding_type == H.PCT_B for _, _, ph in batch)
        r0, r1, packs = recon.dispatch(staged, self._refs[0], self._refs[1],
                                       bidir=bidir)
        self._refs = [r0, r1]
        self.stats["device_s"] += time.perf_counter() - t0
        # transport counters are per (shared) GopRecon instance and
        # cumulative — fold in the delta since this decoder last looked
        snap = self._recon_snaps.setdefault(
            id(recon), dict.fromkeys(
                ("bucket_fallbacks", "bg_compiles", "bg_compile_fails"), 0))
        for k in snap:
            self.stats[k] += recon.stats[k] - snap[k]
            snap[k] = recon.stats[k]

        if self.config.output_host:
            try:
                packs.copy_to_host_async()
            except AttributeError:
                pass
        # frames of one chunk share the packed device buffer (and its single
        # host transfer, cached on first access)
        shared_host: list = [None]
        for i, (_, _, ph) in enumerate(batch):
            lf = LazyFrame(packs, i, geom, ph.temporal_reference,
                           ph.picture_coding_type, shared=shared_host)
            self._route_frame(lf, ph.picture_coding_type)
        self._drain(keep_last=True)

    # ------------------------------------------------------------------
    def _picture_tokens(self, data: bytes, cur):
        """Header state + slice tokenization for one picture (everything
        host-side, no device work)."""
        assert self.seq is not None, "picture before sequence header"
        ph: H.PictureHeader = cur["header"]
        pcext: H.PictureCodingExtension = cur["pcext"]
        geom = PictureGeometry(
            width=self.config.width or (self.seq.horizontal_size_value
                                        | (self.sext.horizontal_size_extension << 12)),
            height=self.config.height or (self.seq.vertical_size_value
                                          | (self.sext.vertical_size_extension << 12)),
            chroma_format=self.config.chroma_format or self.sext.chroma_format,
        )
        params = PictureParams(
            picture_coding_type=ph.picture_coding_type,
            f_code=pcext.f_code,
            intra_dc_precision=pcext.intra_dc_precision,
            picture_structure=pcext.picture_structure,
            frame_pred_frame_dct=pcext.frame_pred_frame_dct,
            concealment_motion_vectors=pcext.concealment_motion_vectors,
            q_scale_type=pcext.q_scale_type,
            intra_vlc_format=pcext.intra_vlc_format,
            alternate_scan=pcext.alternate_scan,
            chroma_format=geom.chroma_format,
            vertical_size=geom.height,
            quant_matrices=H.build_quant_matrices(self.seq, self.qmext),
        )
        t0 = time.perf_counter()
        tokens = self.tokenize_picture(data, cur["slices"], params, geom)
        self.stats["pictures"] += 1
        self.stats["bad_slices"] += tokens.bad_slices
        self.stats["tokenize_s"] += time.perf_counter() - t0
        return tokens, geom, ph

    def _decode_picture(self, data: bytes, cur) -> None:
        tokens, geom, ph = self._picture_tokens(data, cur)
        t1 = time.perf_counter()

        if self.config.mesh == "rows":
            self._decode_picture_mesh(tokens, geom, ph)
            t2 = time.perf_counter()
            self.stats["device_s"] += t2 - t1
            return

        if self.config.gop_chunk > 0:
            if self._chunk and self._chunk[0][1] != geom:
                self._flush_chunk()
            self._chunk.append((tokens, geom, ph))
            if len(self._chunk) >= self.config.gop_chunk:
                self._flush_chunk()
            return

        # Latency path: one picture per program on the SAME pair-packed
        # split-upload transport as the chunk path (GopRecon with chunk=1).
        # I/P pictures run the forward-only program (static bidir split).
        field_support = bool(tokens.field_pred.any())
        recon = self._gop_recon_for(geom, field_support, size=1)
        pct = ph.picture_coding_type
        staged = recon.prepare([tokens], [pct])
        r0, r1, packs = recon.dispatch(staged, self._refs[0], self._refs[1],
                                       bidir=pct == H.PCT_B)
        self._refs = [r0, r1]
        t2 = time.perf_counter()
        self.stats["device_s"] += t2 - t1

        if self.config.output_host:
            try:
                packs.copy_to_host_async()
            except AttributeError:
                pass
        pending = LazyFrame(packs, 0, geom, ph.temporal_reference, pct)
        self._route_frame(pending, pct)
        # deliver everything whose copy has had a picture's worth of overlap
        self._drain(keep_last=True)

    def _decode_picture_mesh(self, tokens, geom: PictureGeometry,
                             ph: H.PictureHeader) -> None:
        """Row-sharded reconstruction: each picture's MB rows split across
        the mesh; reference planes re-replicate (all-gather) between
        pictures (the multi-card analog of the reference's slice-parallel
        workers, reference: threads.cpp:138-159)."""
        field_support = bool(tokens.field_pred.any())
        recon = self._mesh_recon_for(geom, field_support)
        if ph.picture_coding_type in (H.PCT_I, H.PCT_P):
            ref0, ref1 = self._refs[1], None
        else:
            ref0, ref1 = self._refs[0], self._refs[1]
        planes = recon(tokens, ref0, ref1)
        if ph.picture_coding_type in (H.PCT_I, H.PCT_P):
            self._refs = [self._refs[1], planes]
        frame = PlanesFrame(planes, geom, ph.temporal_reference,
                            ph.picture_coding_type)
        self._route_frame(frame, ph.picture_coding_type)
        self._drain(keep_last=True)
