"""Device IDCT: the fixed-point butterfly as plain jnp, fused by XLA.

It computes the identical fixed-point arithmetic as the numpy golden model
(golden/idct.py — the single spec, replicating the reference's production
SSE2 kernel, reference: src/core/idct_sse2.hpp) and is parity-tested
bit-exact against it.  The transform is elementwise integer work on 128 B
in and 128 B out per block, so it is bound by memory traffic; XLA fuses the
whole butterfly into one loop.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..golden.idct import idct_blocks


@jax.jit
def idct_blocks_jnp(coeffs: jax.Array) -> jax.Array:
    """(..., 64) int16 -> (..., 8, 8) int16 residual."""
    return idct_blocks(coeffs, xp=jnp)
