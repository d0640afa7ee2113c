"""Ray tiling and the plain jnp cluster traversal.

Reference parity: this replaces the reference's divergent per-ray stack
traversal + per-leaf Moller-Trumbore (SURVEY.md R2/R3, the OpenCL hot loop)
with a wavefront design (BASELINE: "stackless/short-stack traversal over a
flattened LBVH, wavefront ray batching, SoA triangle layout"):

  1. rays are tiled into coherent blocks of TR (image-space tiles for
     primary rays, chunks for secondary wavefronts);
  2. bvh.cull produces per-tile candidate cluster lists (conservative);
  3. each (tile, candidate-cluster) pair is intersected as dense
     (TR, 4) x (4, 3C) products with an elementwise epilogue and a masked
     running-min reduction.

`trace_tiles_jnp` / `any_hit_tiles_jnp` run step 3 as a lax.scan over
candidate slots: pure jnp, differentiable, runnable anywhere. They back the
jnp accel tier (`make_accel_tracers`) and the ring-sharded geometry tier.
The sorted front-to-back walk of the tiled renderer is kernels.walk.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tracer.bvh.cluster import ClusterAccel
from tracer.bvh.cull import cull_clusters
from tracer.core.types import Ray, Hit, T_FAR

DEFAULT_TILE = 256  # rays per tile of the jnp tier (16x16 pixels)
T_MIN = 1e-4


# ---------------------------------------------------------------------------
# Ray tiling
# ---------------------------------------------------------------------------

class Tiling(NamedTuple):
    batch_shape: tuple
    n_rays: int
    tile_hw: tuple | None  # (th, tw, H, W) when image-tiled


def tile_rays(o: jax.Array, d: jax.Array, tr: int = DEFAULT_TILE):
    """(..., 3) ray SoA -> (Ntiles, TR, 3) + tiling info.

    2D (H, W) batches are tiled spatially (16x16 blocks when TR=256) for
    frustum coherence; other shapes are chunked in order. Padding rays have
    d = 0 and can never hit.
    """
    batch_shape = o.shape[:-1]
    if len(batch_shape) == 2:
        H, W = batch_shape
        th = tw = int(tr ** 0.5)
        if th * tw == tr and H % th == 0 and W % tw == 0:
            def fold(x):
                f = x.reshape(H // th, th, W // tw, tw, 3)
                return f.transpose(0, 2, 1, 3, 4).reshape(-1, tr, 3)

            return fold(o), fold(d), Tiling(batch_shape, H * W, (th, tw, H, W))
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n = o.shape[0]
    n_pad = -(-n // tr) * tr
    if n_pad != n:
        o = jnp.concatenate([o, jnp.zeros((n_pad - n, 3), o.dtype)])
        d = jnp.concatenate([d, jnp.zeros((n_pad - n, 3), d.dtype)])
    return o.reshape(-1, tr, 3), d.reshape(-1, tr, 3), Tiling(batch_shape, n, None)


def generate_rays_tiled(camera, height: int, width: int, tr: int):
    """Primary rays generated DIRECTLY in the (Ntiles, TR, 3) tiled layout.

    Bit-identical to generate_rays + tile_rays (same arithmetic on the same
    pixel-center values, asserted in tests) but with the spatial fold done
    by integer index math instead of a 5-D transpose of the o/d
    wavefronts, which is an addressing change only. Differentiable w.r.t. the
    camera exactly like generate_rays (reference parity: SURVEY.md R1).

    Returns (o_t, d_t, tiling); requires tr a perfect square whose side
    divides both image dimensions (the tile_rays fast-path condition).
    """
    th = tw = int(tr ** 0.5)
    if th * tw != tr or height % th or width % tw:
        from tracer.core.camera import generate_rays

        rays = generate_rays(camera, height, width)
        return tile_rays(rays.o, rays.d, tr)
    ntx = width // tw
    tiles = jnp.arange((height // th) * ntx, dtype=jnp.int32)[:, None]
    slot = jnp.arange(tr, dtype=jnp.int32)[None, :]
    yy = ((tiles // ntx) * th + slot // tw).astype(jnp.float32)
    xx = ((tiles % ntx) * tw + slot % tw).astype(jnp.float32)
    right, up, fwd = camera.basis()
    aspect = width / height
    tan_half = jnp.tan(camera.fov_y * 0.5)
    ndc_x = ((xx + 0.5) / width * 2.0 - 1.0) * aspect * tan_half
    ndc_y = (1.0 - (yy + 0.5) / height * 2.0) * tan_half
    d = (ndc_x[..., None] * right + ndc_y[..., None] * up
         + jnp.broadcast_to(fwd, ndc_x.shape + (3,)))
    o = jnp.broadcast_to(camera.position, d.shape)
    from tracer.core.types import normalize

    return o, normalize(d), Tiling((height, width), height * width,
                                   (th, tw, height, width))


def untile(x: jax.Array, tiling: Tiling):
    """(Ntiles, TR, ...) -> original batch shape."""
    tail = x.shape[2:]
    if tiling.tile_hw is not None:
        th, tw, H, W = tiling.tile_hw
        x = x.reshape(H // th, W // tw, th, tw, *tail)
        perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(tail)))
        return x.transpose(perm).reshape(H, W, *tail)
    x = x.reshape(-1, *tail)[: tiling.n_rays]
    return x.reshape(*tiling.batch_shape, *tail)


def _homog(o: jax.Array, d: jax.Array):
    ones = jnp.ones(o.shape[:-1] + (1,), o.dtype)
    return (
        jnp.concatenate([o, ones], axis=-1),
        jnp.concatenate([d, jnp.zeros_like(ones)], axis=-1),
    )


# ---------------------------------------------------------------------------
# Shared epilogue (field-major layout: cols [0:C)=plane, [C:2C)=u, [2C:3C)=v)
# ---------------------------------------------------------------------------

def _affine_products(o4, d4, w):
    """so, sd = o4 @ w, d4 @ w via explicit broadcast FMA (fp32 multiplies
    and adds, no matrix unit, identical numerics on every backend).

    o4, d4: (..., TR, 4); w: (..., 4, 3C) -> (..., TR, 3C)."""
    so = (
        o4[..., :, 0:1] * w[..., 0:1, :]
        + o4[..., :, 1:2] * w[..., 1:2, :]
        + o4[..., :, 2:3] * w[..., 2:3, :]
        + o4[..., :, 3:4] * w[..., 3:4, :]
    )
    sd = (
        d4[..., :, 0:1] * w[..., 0:1, :]
        + d4[..., :, 1:2] * w[..., 1:2, :]
        + d4[..., :, 2:3] * w[..., 2:3, :]
        + d4[..., :, 3:4] * w[..., 3:4, :]
    )
    return so, sd


def _field_epilogue(so, sd, c, t_min, t_max):
    """(..., 3C) products -> (t, u, v, hit) each (..., C)."""
    den = sd[..., 0:c]
    safe = jnp.abs(den) > 1e-12
    t = -so[..., 0:c] / jnp.where(safe, den, 1.0)
    u = so[..., c : 2 * c] + t * sd[..., c : 2 * c]
    v = so[..., 2 * c : 3 * c] + t * sd[..., 2 * c : 3 * c]
    hit = safe & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return jnp.where(hit, t, T_FAR), u, v, hit


# ---------------------------------------------------------------------------
# jnp reference / differentiable path
# ---------------------------------------------------------------------------

def trace_tiles_jnp(o_t, d_t, accel: ClusterAccel, cand, counts, t_min=T_MIN):
    """Closest-hit over candidate clusters, lax.scan over candidate slots.

    o_t, d_t: (Ntiles, TR, 3). Returns (t, tri, u, v) each (Ntiles, TR).
    """
    n_tiles, tr, _ = o_t.shape
    c = accel.cluster_size
    o4, d4 = _homog(o_t, d_t)
    k_cap = cand.shape[1]

    def step(carry, k):
        bt, btri, bu, bv = carry
        cidx = cand[:, k]  # (Ntiles,)
        w = accel.tri_w[cidx]  # (Ntiles, 4, 3C)
        ids = accel.tri_ids[cidx]  # (Ntiles, C)
        so, sd = _affine_products(o4, d4, w)
        t, u, v, _ = _field_epilogue(so, sd, c, t_min, T_FAR)
        active = (k < counts)[:, None]
        t = jnp.where(active[..., None], t, T_FAR)
        tmin = jnp.min(t, axis=-1)  # (Ntiles, TR)
        am = jnp.argmin(t, axis=-1)
        onehot = am[..., None] == jnp.arange(c)[None, None, :]
        ub = jnp.sum(jnp.where(onehot, u, 0.0), axis=-1)
        vb = jnp.sum(jnp.where(onehot, v, 0.0), axis=-1)
        idb = jnp.sum(jnp.where(onehot, ids[:, None, :], 0), axis=-1).astype(jnp.int32)
        better = tmin < bt
        return (
            jnp.where(better, tmin, bt),
            jnp.where(better, idb, btri),
            jnp.where(better, ub, bu),
            jnp.where(better, vb, bv),
        ), None

    # Under shard_map the scan carry must carry the same varying-axes type
    # as the body output (which depends on rays AND accel, possibly sharded
    # over different mesh axes). 0*x terms propagate both inputs' axes onto
    # the init without changing values (cannot constant-fold: 0*NaN != 0).
    # d_t must participate: a pinhole wavefront's o_t is a replicated
    # broadcast of the camera position even when the DIRECTIONS are
    # device-varying (shard_map band rendering), and a non-varying init
    # against a varying body output is a scan type error.
    vary_f = (0.0 * o_t[..., 0] + 0.0 * d_t[..., 0]
              + 0.0 * accel.tri_w.reshape(-1)[0] + 0.0 * counts[:, None])
    init = (
        jnp.full((n_tiles, tr), T_FAR, jnp.float32) + vary_f,
        jnp.full((n_tiles, tr), -1, jnp.int32) + vary_f.astype(jnp.int32),
        jnp.zeros((n_tiles, tr), jnp.float32) + vary_f,
        jnp.zeros((n_tiles, tr), jnp.float32) + vary_f,
    )
    # Remat the per-candidate step: without it, reverse-mode AD saves every
    # step's dense (Ntiles, TR, C) intermediates — k_cap x that tensor was
    # an 86 GB residual for the bunny512 grad benchmark. Recomputing the
    # step in the backward pass trades ~2x candidate FLOPs for O(carry)
    # memory (SURVEY.md: jax.checkpoint to trade FLOPs for HBM).
    step = jax.checkpoint(step, prevent_cse=False)
    (bt, btri, bu, bv), _ = jax.lax.scan(step, init, jnp.arange(k_cap, dtype=jnp.int32))
    return bt, btri, bu, bv


def any_hit_tiles_jnp(o_t, d_t, t_max_t, accel: ClusterAccel, cand, counts, t_min=T_MIN):
    """Occlusion over candidate clusters. t_max_t: (Ntiles, TR)."""
    n_tiles, tr, _ = o_t.shape
    c = accel.cluster_size
    o4, d4 = _homog(o_t, d_t)
    k_cap = cand.shape[1]

    def step(occ, k):
        cidx = cand[:, k]
        w = accel.tri_w[cidx]
        so, sd = _affine_products(o4, d4, w)
        _, _, _, hit = _field_epilogue(so, sd, c, t_min, t_max_t[..., None])
        active = (k < counts)[:, None]
        return occ | (jnp.any(hit, axis=-1) & active), None

    # See trace_tiles_jnp: init must carry both inputs' varying axes.
    vary_b = (0.0 * o_t[..., 0] + 0.0 * d_t[..., 0] + 0.0 * t_max_t
              + 0.0 * accel.tri_w.reshape(-1)[0] + 0.0 * counts[:, None]) > 0.0
    occ0 = jnp.zeros((n_tiles, tr), bool) | vary_b
    # Remat: see trace_tiles_jnp (occlusion is boolean so its cotangents
    # are zero anyway, but the saved primals still cost k_cap x dense).
    step = jax.checkpoint(step, prevent_cse=False)
    occ, _ = jax.lax.scan(step, occ0, jnp.arange(k_cap, dtype=jnp.int32))
    return occ


# ---------------------------------------------------------------------------
# High-level tracers
# ---------------------------------------------------------------------------

def make_accel_tracers(scene, accel: ClusterAccel, k_cap: int | None = None,
                       tr: int = DEFAULT_TILE):
    """Build (trace_fn, occlude_fn) over the cluster acceleration structure
    with the jnp scan traversal (differentiable end to end).

    k_cap caps the per-tile candidate list (None = all clusters: exact).
    A capped list that drops candidates prints a warning from the device.
    """
    n_cl = accel.num_clusters
    k = n_cl if k_cap is None else min(k_cap, n_cl)

    def _warn_overflow(flag):
        jax.lax.cond(
            flag != 0,
            lambda: jax.debug.print(
                "WARNING: tracer candidate-cap overflow — image may be "
                "incomplete; raise k_cap"),
            lambda: None,
        )

    def trace_fn(ray: Ray) -> Hit:
        o_t, d_t, tiling = tile_rays(ray.o, ray.d, tr)
        cand, counts, cap_over = cull_clusters(accel, o_t, d_t, T_FAR, k)
        bt, btri, bu, bv = trace_tiles_jnp(o_t, d_t, accel, cand, counts)
        if k < n_cl:
            _warn_overflow(cap_over)
        uv = jnp.stack([bu, bv], axis=-1)
        return Hit(t=untile(bt, tiling), tri=untile(btri, tiling), uv=untile(uv, tiling))

    def occlude_fn(ray: Ray, t_max) -> jax.Array:
        o_t, d_t, tiling = tile_rays(ray.o, ray.d, tr)
        if jnp.ndim(t_max) == 0:
            t_max_t = jnp.full(o_t.shape[:2], t_max, jnp.float32)
        else:
            tm3 = jnp.broadcast_to(t_max[..., None], t_max.shape + (3,))
            t_max_t, _, _ = tile_rays(tm3, tm3, tr)
            t_max_t = t_max_t[..., 0]
        cand, counts, cap_over = cull_clusters(accel, o_t, d_t, t_max_t, k)
        occ = any_hit_tiles_jnp(o_t, d_t, t_max_t, accel, cand, counts)
        if k < n_cl:
            _warn_overflow(cap_over)
        return untile(occ, tiling)

    return trace_fn, occlude_fn
