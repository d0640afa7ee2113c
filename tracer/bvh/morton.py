"""Morton (Z-order) codes — vectorized on-device bit interleaving.

Used to sort triangles into spatially coherent order for both the cluster
acceleration structure (bvh.cluster) and the Karras LBVH (bvh.lbvh).
SURVEY.md §3.2 F: 30-bit codes, bit-interleave via shifts (branch-free vector ops).
"""
from __future__ import annotations

import jax.numpy as jnp


def expand_bits_10(v: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of each uint32 out to every 3rd bit."""
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton3d(q: jnp.ndarray) -> jnp.ndarray:
    """(N, 3) integer coords in [0, 1024) -> (N,) 30-bit morton codes."""
    x = expand_bits_10(q[..., 0])
    y = expand_bits_10(q[..., 1])
    z = expand_bits_10(q[..., 2])
    return (x << jnp.uint32(2)) | (y << jnp.uint32(1)) | z


def quantize_positions(p: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """Normalize points into the scene AABB and quantize to 10-bit grid."""
    extent = jnp.maximum(hi - lo, 1e-12)
    u = (p - lo) / extent
    return jnp.clip(u * 1024.0, 0.0, 1023.0).astype(jnp.uint32)


def morton_decode3d(code: jnp.ndarray) -> jnp.ndarray:
    """Inverse of morton3d (testing): (N,) codes -> (N, 3) coords."""
    def compact(v):
        v = v.astype(jnp.uint32) & jnp.uint32(0x49249249)
        v = (v | (v >> jnp.uint32(2))) & jnp.uint32(0xC30C30C3)
        v = (v | (v >> jnp.uint32(4))) & jnp.uint32(0x0F00F00F)
        v = (v | (v >> jnp.uint32(8))) & jnp.uint32(0xFF0000FF)
        v = (v | (v >> jnp.uint32(16))) & jnp.uint32(0x000003FF)
        return v

    return jnp.stack(
        [compact(code >> jnp.uint32(2)), compact(code >> jnp.uint32(1)), compact(code)],
        axis=-1,
    )
