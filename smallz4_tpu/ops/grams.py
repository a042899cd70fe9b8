"""Device-side gram/byte-view primitives shared by the device kernels.

All serialization stays on the host (SURVEY.md §7 byte-order rule); these
ops only build integer *views* of the byte stream for vectorized compare/
hash work on the device.
"""
from __future__ import annotations

import jax.numpy as jnp

from .. import format as fmt


def grams4(ctx_u8: jnp.ndarray) -> jnp.ndarray:
    """uint32 little-endian 4-byte gram at every position (same length as
    input; the last 3 entries are zero-padded and must be masked by the
    caller).  Mirrors oracle.grams4 (reference read: smallz4.h:646)."""
    c = ctx_u8.astype(jnp.uint32)
    n = c.shape[0]
    if n < 4:
        return jnp.zeros(n, jnp.uint32)
    g = c[:-3] | (c[1:-2] << 8) | (c[2:-1] << 16) | (c[3:] << 24)
    return jnp.concatenate([g, jnp.zeros(3, jnp.uint32)])


def hash20(grams: jnp.ndarray) -> jnp.ndarray:
    """The reference's LCG hash on device (smallz4.h:163-169)."""
    return (grams * jnp.uint32(fmt.HASH_MULTIPLIER)) >> jnp.uint32(32 - fmt.HASH_BITS)


def mismatch_bytes_in_u32(x: jnp.ndarray) -> jnp.ndarray:
    """Number of equal low-order bytes before the first differing byte of a
    xor'd little-endian u32 (0..3; caller handles x == 0 as 4)."""
    b0 = (x & 0xFF) != 0
    b1 = (x & 0xFF00) != 0
    b2 = (x & 0xFF0000) != 0
    return jnp.where(b0, 0, jnp.where(b1, 1, jnp.where(b2, 2, 3))).astype(jnp.int32)
