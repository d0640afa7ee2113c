"""Core pytree types: SoA ray batches and hit records.

Reference parity: the OpenCL reference carries per-work-item `struct Ray`
and hit info in registers (SURVEY.md R1/R2). This design is
structure-of-arrays over a whole wavefront of rays so every field is a dense
(N, ...) array amenable to vectorized work.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

# Sentinel triangle id for "ray missed everything".
NO_HIT = jnp.int32(-1)

# Large t used as "infinity" for nearest-hit reductions (fp32-safe).
T_FAR = 1e30
# Epsilon used to offset secondary-ray origins off surfaces.
RAY_EPS = 1e-4


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Ray:
    """A batch of rays in SoA layout.

    o: (..., 3) origins. d: (..., 3) directions (not necessarily unit).
    """

    o: jax.Array
    d: jax.Array

    @property
    def batch_shape(self):
        return self.o.shape[:-1]

    def at(self, t: jax.Array) -> jax.Array:
        """Points o + t*d; t broadcasts against the batch shape."""
        return self.o + t[..., None] * self.d

    def homogeneous(self) -> tuple[jax.Array, jax.Array]:
        """(o4, d4) with o4 = [o,1], d4 = [d,0] — the layout consumed by the
        affine-map (matmul) intersection path (see core.intersect)."""
        ones = jnp.ones(self.o.shape[:-1] + (1,), self.o.dtype)
        zeros = jnp.zeros_like(ones)
        return (
            jnp.concatenate([self.o, ones], axis=-1),
            jnp.concatenate([self.d, zeros], axis=-1),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Hit:
    """Nearest-hit record for a batch of rays (SoA).

    t:    (...,) hit distance (T_FAR when miss)
    tri:  (...,) int32 triangle index (NO_HIT when miss)
    uv:   (..., 2) barycentric coordinates at the hit
    """

    t: jax.Array
    tri: jax.Array
    uv: jax.Array

    @property
    def valid(self) -> jax.Array:
        return self.tri >= 0

    @staticmethod
    def miss(batch_shape: tuple[int, ...], dtype: Any = jnp.float32) -> "Hit":
        return Hit(
            t=jnp.full(batch_shape, T_FAR, dtype),
            tri=jnp.full(batch_shape, -1, jnp.int32),
            uv=jnp.zeros(batch_shape + (2,), dtype),
        )


def normalize(v: jax.Array, eps: float = 1e-20) -> jax.Array:
    """Safe normalize along the last axis."""
    return v * jax.lax.rsqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), eps))


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.sum(a * b, axis=-1)


def cross(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.cross(a, b)
