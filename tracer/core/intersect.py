"""Ray-triangle intersection.

Reference parity: the OpenCL reference implements classic Moller-Trumbore per
(work-item ray, leaf triangle) with scalar branching (SURVEY.md R2,
BASELINE capability "BVH-accelerated ray-triangle intersection using
Moller-Trumbore"). That formulation is branchy and gather-heavy — a poor fit
for dense wavefront execution.

Redesign: triangles are *precompiled* into per-triangle affine maps
(a 3x4 matrix each, the Baldwin-Weber form of Moller-Trumbore). With

    W[k] = [[ n | -n.v0 ],          n  = e1 x e2        (plane row)
            [ au | -au.v0 ],        au = (e2 x n)/|n|^2 (barycentric-u row)
            [ av | -av.v0 ]]        av = (n x e1)/|n|^2 (barycentric-v row)

the whole intersection of R rays against T triangles reduces to two matmuls

    So = O4 @ W_flat.T     (R,4)@(4,3T) -> plane/u/v evaluated at origins
    Sd = D4 @ W_flat.T     (R,4)@(4,3T) -> plane/u/v evaluated at directions

followed by cheap elementwise math:

    t = -So_n / Sd_n ;  u = So_u + t*Sd_u ;  v = So_v + t*Sd_v
    hit = (u>=0) & (v>=0) & (u+v<=1) & (t_min < t < t_max)

i.e. the brute tier's inner loop is two fp32 matrix products plus an
elementwise epilogue. This computes the same
(t, u, v, hit) as Moller-Trumbore (proved equal in tests/unit/test_intersect.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from tracer.core.types import Ray, Hit, T_FAR


def moller_trumbore(
    ray_o: jax.Array,
    ray_d: jax.Array,
    v0: jax.Array,
    v1: jax.Array,
    v2: jax.Array,
    t_min: float = 1e-4,
    t_max: float = T_FAR,
    eps: float = 1e-12,
    bary_eps: float = 0.0,
):
    """Classic Moller-Trumbore, broadcasting over any leading batch dims.

    `bary_eps` relaxes the barycentric inclusion bounds — used by hit
    RECOVERY paths that must not re-adjudicate a selection made by the
    (fp-differently-rounded) affine-map formulation (see
    render.tiled.mt_from_edges).

    Kept as the readable jnp reference implementation (CPU path / oracle for
    the packed-matmul path below). Returns (t, u, v, hit_mask); t == T_FAR on
    miss. Double-sided (no backface culling), matching the reference tracer's
    behavior for closed scenes.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(ray_d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvec = ray_o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(ray_d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > eps)
        & (u >= -bary_eps)
        & (v >= -bary_eps)
        & (u + v <= 1.0 + bary_eps)
        & (t > t_min)
        & (t < t_max)
    )
    return jnp.where(hit, t, T_FAR), u, v, hit


def triangle_affine_maps(verts: jax.Array, tris: jax.Array) -> jax.Array:
    """Precompile triangles into (T, 3, 4) affine intersection maps.

    Differentiable w.r.t. `verts` — vertex-position gradients for the
    differentiable renderer flow through this precompute (tracer.diff).
    Degenerate triangles (|n|^2 ~ 0) get zero u/v rows -> never report a hit.
    """
    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    n = jnp.cross(e1, e2)  # (T, 3)
    n2 = jnp.sum(n * n, axis=-1, keepdims=True)
    inv_n2 = jnp.where(n2 > 1e-24, 1.0 / jnp.where(n2 == 0, 1.0, n2), 0.0)
    au = jnp.cross(e2, n) * inv_n2
    av = jnp.cross(n, e1) * inv_n2
    rows = jnp.stack([n, au, av], axis=1)  # (T, 3, 3)
    offs = -jnp.sum(rows * v0[:, None, :], axis=-1)  # (T, 3)
    return jnp.concatenate([rows, offs[..., None]], axis=-1)  # (T, 3, 4)


def intersect_packed(
    o4: jax.Array,
    d4: jax.Array,
    tri_maps: jax.Array,
    t_min: float = 1e-4,
    t_max: float = T_FAR,
    eps: float = 1e-12,
):
    """Dense R rays x T triangles intersection via two matrix products.

    o4, d4: (R, 4) homogeneous rays (Ray.homogeneous()).
    tri_maps: (T, 3, 4) from triangle_affine_maps.
    Returns (t, u, v, hit) each (R, T); t == T_FAR where miss.
    """
    T = tri_maps.shape[0]
    w = tri_maps.reshape(T * 3, 4)
    # precision=HIGHEST: true fp32 products. On the GPU the default lets
    # the tensor cores round fp32 inputs to TF32 (~1e-3 relative error),
    # which breaks hit classification (t is compared against eps-scale
    # bounds -> spurious self-shadowing).
    so = jax.lax.dot_general(
        o4, w, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
    ).reshape(-1, T, 3)
    sd = jax.lax.dot_general(
        d4, w, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
    ).reshape(-1, T, 3)
    return _packed_epilogue(so, sd, t_min, t_max, eps)


def _packed_epilogue(so, sd, t_min, t_max, eps):
    """Shared elementwise tail of the packed intersection (also used by the
    Pallas kernel's in-kernel epilogue reference)."""
    denom = sd[..., 0]
    safe = jnp.abs(denom) > eps
    t = -so[..., 0] / jnp.where(safe, denom, 1.0)
    u = so[..., 1] + t * sd[..., 1]
    v = so[..., 2] + t * sd[..., 2]
    hit = safe & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return jnp.where(hit, t, T_FAR), u, v, hit


def nearest_hit(t: jax.Array, u: jax.Array, v: jax.Array, tri_ids: jax.Array | None = None) -> Hit:
    """Reduce (R, T) per-pair results to the nearest Hit per ray."""
    idx = jnp.argmin(t, axis=-1)  # (R,)
    r = jnp.arange(t.shape[0])
    t_best = t[r, idx]
    uv = jnp.stack([u[r, idx], v[r, idx]], axis=-1)
    tri = idx.astype(jnp.int32) if tri_ids is None else tri_ids[idx]
    tri = jnp.where(t_best < T_FAR, tri, -1)
    return Hit(t=t_best, tri=tri, uv=jnp.where(t_best[..., None] < T_FAR, uv, 0.0))


def intersect_brute(
    ray: Ray,
    verts: jax.Array,
    tris: jax.Array,
    t_min: float = 1e-4,
    t_max: float = T_FAR,
) -> Hit:
    """All-rays x all-triangles brute force (BASELINE config 1: Cornell box,
    no BVH). Flattens the ray batch, runs the packed matmul path, reduces to the
    nearest hit, and restores the batch shape.

    Differentiating through this function backpropagates the dense (R x T)
    pass — fine under shard_map (the varying-axes machinery sees every op).
    Single-device optimization loops should prefer tracer.diff.vjp's
    make_replay_tracers: identical forward, O(R) custom-VJP backward via
    saved-hit-id replay.
    """
    batch_shape = ray.batch_shape
    flat = Ray(o=ray.o.reshape(-1, 3), d=ray.d.reshape(-1, 3))
    o4, d4 = flat.homogeneous()
    tri_maps = triangle_affine_maps(verts, tris)
    t, u, v, _ = intersect_packed(o4, d4, tri_maps, t_min, t_max)
    hit = nearest_hit(t, u, v)
    return Hit(
        t=hit.t.reshape(batch_shape),
        tri=hit.tri.reshape(batch_shape),
        uv=hit.uv.reshape(batch_shape + (2,)),
    )


def any_hit_brute(
    ray: Ray,
    verts: jax.Array,
    tris: jax.Array,
    t_min: float = 1e-4,
    t_max=T_FAR,
) -> jax.Array:
    """Occlusion (shadow-ray) test: True where *any* triangle blocks the ray
    within (t_min, t_max). Brute-force counterpart of the BVH any-hit pass.
    `t_max` may be a scalar or a per-ray array of the ray batch shape
    (shadow rays are limited to the surface->light distance)."""
    batch_shape = ray.batch_shape
    flat = Ray(o=ray.o.reshape(-1, 3), d=ray.d.reshape(-1, 3))
    o4, d4 = flat.homogeneous()
    if isinstance(t_max, jax.Array) and t_max.ndim > 0:
        t_max = t_max.reshape(-1, 1)  # broadcast against (R, T)
    tri_maps = triangle_affine_maps(verts, tris)
    _, _, _, hit = intersect_packed(o4, d4, tri_maps, t_min, t_max)
    return jnp.any(hit, axis=-1).reshape(batch_shape)
