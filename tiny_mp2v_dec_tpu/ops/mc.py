"""Device motion compensation: batched window gathers + phase-select.

Data-parallel formulation of the reference's 40 scalar/SIMD MC kernels
(reference: src/core/mc.h:9-12, mc_sse2.hpp): instead of dispatching one of
four sub-pel functions per macroblock through a function-pointer table, every
MB gathers an (h+1, w+1) window from the (zero-padded) reference plane via a
batched dynamic-slice, all four half-pel variants are computed vectorized,
and the 2-bit phase *selects* — phase is data, not control flow.

Arithmetic is MPEG-2 exact: ``(a+b+1)>>1`` per stage in uint16, bidirectional
average with the same rounding (golden model: golden/mc.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def pad_for_mc(plane: jax.Array) -> jax.Array:
    """Zero-pad one row/col at bottom/right (matches golden.mc.pad_for_mc)."""
    return jnp.pad(plane, ((0, 1), (0, 1)))


def gather_windows(padded: jax.Array, sy: jax.Array, sx: jax.Array,
                   h: int, w: int) -> jax.Array:
    """(n,) start rows/cols -> (n, h+1, w+1) uint8 windows.

    Starts are clamped into the plane explicitly — jax.lax.dynamic_slice
    interprets *negative* starts Python-style (from the end), which is not
    the golden clamp-to-origin semantics."""
    sy = jnp.clip(sy.astype(jnp.int32), 0, padded.shape[0] - (h + 1))
    sx = jnp.clip(sx.astype(jnp.int32), 0, padded.shape[1] - (w + 1))

    def one(y, x):
        return jax.lax.dynamic_slice(padded, (y, x), (h + 1, w + 1))
    return jax.vmap(one)(sy, sx)


def halfpel_select(win: jax.Array, hx: jax.Array, hy: jax.Array,
                   h: int, w: int) -> jax.Array:
    """win: (n, h+1, w+1) uint8; hx/hy: (n,) {0,1} phase bits -> (n, h, w)."""
    a = win[:, :h, :w].astype(jnp.uint16)
    b = win[:, :h, 1:w + 1].astype(jnp.uint16)
    c = win[:, 1:h + 1, :w].astype(jnp.uint16)
    d = win[:, 1:h + 1, 1:w + 1].astype(jnp.uint16)
    ab = (a + b + 1) >> 1
    ac = (a + c + 1) >> 1
    abcd = (ab + ((c + d + 1) >> 1) + 1) >> 1
    hx = hx.astype(bool)[:, None, None]
    hy = hy.astype(bool)[:, None, None]
    out = jnp.where(hx & hy, abcd, jnp.where(hx, ab, jnp.where(hy, ac, a)))
    return out.astype(jnp.uint8)


def mc_unidir_tiles(padded: jax.Array, pos_y: jax.Array, pos_x: jax.Array,
                    mvx: jax.Array, mvy: jax.Array, h: int, w: int) -> jax.Array:
    """Batched unidirectional prediction: (n,) positions + half-pel MVs ->
    (n, h, w) uint8 tiles."""
    sy = pos_y + (mvy.astype(jnp.int32) >> 1)
    sx = pos_x + (mvx.astype(jnp.int32) >> 1)
    win = gather_windows(padded, sy, sx, h, w)
    return halfpel_select(win, mvx & 1, mvy & 1, h, w)


def mc_bidir_tiles(p0: jax.Array, p1: jax.Array) -> jax.Array:
    return ((p0.astype(jnp.uint16) + p1.astype(jnp.uint16) + 1) >> 1).astype(jnp.uint8)


def gather_windows_fields(fields: jax.Array, sel: jax.Array, sy: jax.Array,
                          sx: jax.Array, h: int, w: int) -> jax.Array:
    """fields: (2, Hf+1, Wf+1) stacked padded field views; sel: (n,) {0,1}
    motion_vertical_field_select -> (n, h+1, w+1)."""
    sy = jnp.clip(sy.astype(jnp.int32), 0, fields.shape[1] - (h + 1))
    sx = jnp.clip(sx.astype(jnp.int32), 0, fields.shape[2] - (w + 1))

    def one(s, y, x):
        return jax.lax.dynamic_slice(
            fields, (s, y, x), (1, h + 1, w + 1))[0]
    return jax.vmap(one)(sel.astype(jnp.int32), sy, sx)


def mc_field_tiles(fields: jax.Array, sel: jax.Array, pos_y: jax.Array,
                   pos_x: jax.Array, mvx: jax.Array, mvy: jax.Array,
                   h: int, w: int) -> jax.Array:
    """Field-based prediction (frame pictures): positions in field coords,
    (n, h, w) output for one prediction unit."""
    sy = pos_y + (mvy.astype(jnp.int32) >> 1)
    sx = pos_x + (mvx.astype(jnp.int32) >> 1)
    win = gather_windows_fields(fields, sel, sy, sx, h, w)
    return halfpel_select(win, mvx & 1, mvy & 1, h, w)
