"""Tile-resident Whitted integrator — the main render path.

Reference parity: same light transport as render.whitted (the OpenCL
reference's shade + shadow + mirror-bounce kernel, SURVEY.md R4), but the
whole pipeline stays in the walk's tiled (Ntiles, TR) layout from primary
rays to the final image, and all per-hit data comes from ONE wide gather of
the packed shade table (bvh.cluster.SHADE_COLS layout) indexed by the
walk's sorted-slot id:

  * no (H, W) <-> tile transposes between passes (one untile at the end);
  * no chained narrow gathers (tris -> verts -> normals -> materials);
  * the walk (kernels.walk) is used for SELECTION only (which triangle,
    conservative t); hit attributes (t, u, v, normal, position) are
    recomputed outside it from the gathered rows. The recompute is
    differentiable w.r.t. vertices / normals / materials / camera, so
    `jax.grad` flows through this integrator without a custom VJP on the
    walk — the walk sees only stop-gradiented inputs (discrete selection is
    piecewise constant; edge terms are handled by tracer.diff's
    reparameterization).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tracer.bvh.cluster import ClusterAccel
from tracer.bvh.cull import cull_clusters_sorted2
from tracer.core.camera import Camera
from tracer.core.types import Ray, T_FAR, RAY_EPS, normalize
from tracer.kernels.traversal import T_MIN, untile, generate_rays_tiled
from tracer.kernels.walk import occlude_walk, trace_walk
from tracer.render.whitted import WhittedConfig, phong_specular


def mt_from_edges(o, d, v0, e1, e2, t_min=T_MIN, eps=1e-12, bary_eps=1e-5):
    """Moller-Trumbore given (v0, e1, e2) rows — the differentiable hit
    recompute for the shade-table path. Returns (t, u, v, hit).

    `bary_eps` relaxes the barycentric bounds: the KERNEL (affine-map
    formulation) already adjudicated the hit; this recompute only recovers
    (t, u, v) and must not veto it over formulation-level fp differences.
    Without the slack, rays through a quad's shared diagonal can be
    selected by the kernel (u >= 0 in affine arithmetic) yet recompute to
    u ~ -5e-8 classically, leaving a black pixel (measured: 9/256 pixels
    on a 2-triangle plane, camera-position dependent)."""
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv = jnp.where(jnp.abs(det) > eps, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv
    t = jnp.sum(e2 * qvec, axis=-1) * inv
    hit = ((jnp.abs(det) > eps) & (u >= -bary_eps) & (v >= -bary_eps)
           & (u + v <= 1.0 + bary_eps) & (t > t_min))
    return t, u, v, hit


def _trace_rows(accel: ClusterAccel, o_t, d_t, k_cap, s_cap, interpret,
                origin=None):
    """Walk selection pass -> (gid, rows, excess, need). All walk inputs
    are stop-gradiented; gradients flow through the row recompute
    instead. `origin`: the pass's single shared ray origin, if any."""
    sg = jax.lax.stop_gradient
    accel_sg = sg(accel)
    words, counts, excess, need = cull_clusters_sorted2(
        accel_sg, sg(o_t), sg(d_t), T_FAR, k_cap, s_cap)
    _bt, gid = trace_walk(
        sg(o_t), sg(d_t), accel_sg, words, counts,
        origin=None if origin is None else sg(origin), interpret=interpret)
    # One gather of the packed SHADE_COLS-wide rows (padding them to 128
    # columns first measured no faster on the H100, PERF.md).
    rows = accel.shade[jnp.maximum(gid, 0)]  # (Nt, TR, SHADE_COLS)
    return gid, rows, excess, need


def _segment_occluded(accel: ClusterAccel, light_pos, p_t, eps_t, k_cap,
                      s_cap, interpret):
    """Occlusion of the segment light<->p, traced FROM THE LIGHT.

    Shadow rays share the light as a common origin, so the per-tile frustum
    is a tight cone (like primary rays from the camera) instead of the fat
    interval hull a surface-origin wavefront produces, and the walk takes
    the shared-origin products. The segment is parameterized o = light,
    d = p - light, t in (t_min, 1 - eps_rel): the direction is
    intentionally unnormalized so t_max == 1 uniformly. `eps_t` is the
    absolute surface offset (RAY_EPS-scale) to exclude the receiving
    surface itself at t ~ 1."""
    sg = jax.lax.stop_gradient
    accel_sg = sg(accel)
    light_pos = sg(light_pos)
    o_t = jnp.broadcast_to(light_pos, p_t.shape)
    d_t = sg(p_t) - light_pos
    seg_len = jnp.sqrt(jnp.maximum(jnp.sum(d_t * d_t, axis=-1), 1e-20))
    t_max_t = 1.0 - eps_t / seg_len
    words, counts, excess, need = cull_clusters_sorted2(
        accel_sg, o_t, d_t, t_max_t, k_cap, s_cap)
    occ = occlude_walk(o_t, d_t, t_max_t, accel_sg, words, counts,
                       origin=light_pos, interpret=interpret)
    return occ, excess, need


# Closest-hit candidate cap the sizing loop starts from: primary/bounce
# frusta are tight, so a small first guess keeps the cull's sort narrow;
# overflow is surfaced, never silent, and the sizing loop widens the cap.
K_CLOSEST = 64
# Shadow-pass candidate cap the sizing loop starts from (light-origin
# frusta typically need a few times the camera's).
K_SHADOW = 256


# Supercluster cap for the two-stage cull (see bvh.cull); overflow past it
# is surfaced, and the API's cap sizing escalates it per scene.
S_CAP = 16


def render_tiled(scene, accel: ClusterAccel, camera: Camera,
                 height: int, width: int, cfg: WhittedConfig,
                 k_cap: int = K_SHADOW, tr: int = 64,
                 interpret: bool = False, with_aux: bool = False,
                 k_closest: int = K_CLOSEST, s_cap: int = S_CAP):
    """Full-image Whitted render on the sorted-walk path -> (H, W, 3), or
    ((H, W, 3), aux) when with_aux: aux['overflow'] counts cull candidates
    dropped by the k/s caps (0 == exact); aux['need_*'] are the caps this
    frame would need to be exact; aux['live_rays'] counts rays traced.

    tr=64 (8x8-pixel tiles): tighter tile frusta mean fewer candidates per
    tile than 16x16 tiles, which outweighs the 4x tile count.
    `interpret=True` runs the walk's Pallas kernel in interpret mode."""
    k = min(k_cap, accel.num_clusters)
    k = max(8, -(-k // 8) * 8)
    kc = min(k_closest, accel.num_clusters)
    kc = max(8, -(-kc // 8) * 8)
    overflow = jnp.int32(0)
    # Max over all passes of the unclipped candidate counts: what the caps
    # would have to be for this frame to be exact (api cap sizing).
    need_closest = jnp.int32(0)
    need_shadow = jnp.int32(0)
    need_s = jnp.int32(0)
    o_t, d_t, tiling = generate_rays_tiled(camera, height, width, tr)

    sky = jnp.asarray(cfg.sky_color, jnp.float32)
    shape = o_t.shape[:2]
    radiance = jnp.zeros(shape + (3,), jnp.float32)
    throughput = jnp.ones(shape + (3,), jnp.float32)
    live = jnp.ones(shape, bool)
    # Honest throughput accounting: wavefront slots whose ray is dead
    # (d == 0 — bounce rays of non-mirror pixels, unlit shadow targets)
    # cost ~nothing (the cull gives them no candidates), so `live_rays`
    # counts only rays actually traced: per bounce the d != 0 closest
    # wavefront plus each light's lit shadow segments.
    live_rays = jnp.int32(0)

    for bounce in range(cfg.max_bounces):
        live_rays = live_rays + jnp.sum(jnp.any(d_t != 0.0, axis=-1),
                                        dtype=jnp.int32)
        # bounce 0 = primary rays: one exact camera origin for every ray
        # (generate_rays_tiled broadcasts camera.position), so the walk
        # takes the shared-origin products; bounce rays have per-pixel
        # origins and cannot.
        gid, rows, exc, need = _trace_rows(
            accel, o_t, d_t, kc, s_cap, interpret,
            origin=camera.position if bounce == 0 else None)
        overflow = overflow + exc
        need_closest = jnp.maximum(need_closest, need[0])
        need_s = jnp.maximum(need_s, need[1])
        v0 = rows[..., 0:3]
        e1 = rows[..., 3:6]
        e2 = rows[..., 6:9]
        t, u, v, hitm = mt_from_edges(o_t, d_t, v0, e1, e2)
        found = (gid >= 0) & hitm & (rows[..., 25] > 0.5)
        valid = found & live

        p = o_t + t[..., None] * d_t
        if cfg.smooth_shading:
            uu = u[..., None]
            vv = v[..., None]
            n = normalize(rows[..., 9:12] * (1.0 - uu - vv)
                          + rows[..., 12:15] * uu + rows[..., 15:18] * vv)
        else:
            n = normalize(jnp.cross(e1, e2))
        n = jnp.where(jnp.sum(n * d_t, axis=-1, keepdims=True) > 0, -n, n)
        albedo = rows[..., 18:21]
        emission = rows[..., 21:24]
        mirror = rows[..., 24:25]
        spec = rows[..., 26]
        shin = rows[..., 27]

        # Direct lighting with shadow rays (tiled layout throughout).
        direct = jnp.zeros_like(p)
        for li in range(scene.lights.count):
            lpos = scene.lights.position[li]
            lint = scene.lights.intensity[li]
            to_l = lpos - p
            dist2 = jnp.sum(to_l * to_l, axis=-1)
            dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
            wi = to_l / dist[..., None]
            cos = jnp.maximum(jnp.sum(n * wi, axis=-1), 0.0)
            # Rays that can't receive light (miss, or surface back-facing
            # the light) target the light itself: a zero-length segment
            # (d == 0) is ignored by the cull's tile bounds and never hits,
            # so they don't fatten the shadow frusta or cost walk work.
            lit = valid & (cos > 0.0)
            live_rays = live_rays + jnp.sum(lit, dtype=jnp.int32)
            target = jnp.where(lit[..., None], p + n * RAY_EPS, lpos)
            occ, exc, need = _segment_occluded(
                accel, lpos, target, jnp.float32(RAY_EPS), k, s_cap,
                interpret)
            overflow = overflow + exc
            need_shadow = jnp.maximum(need_shadow, need[0])
            need_s = jnp.maximum(need_s, need[1])
            vis = jnp.where(occ | ~lit, 0.0, 1.0)
            falloff = (vis / jnp.maximum(dist2, 1e-20))[..., None] * lint
            brdf = (albedo / jnp.pi * cos[..., None]
                    + phong_specular(d_t, n, wi, spec, shin)[..., None])
            direct = direct + brdf * falloff

        local = emission + albedo * cfg.ambient + direct
        miss_contrib = jnp.where((live & ~found)[..., None], sky, 0.0)
        surf_contrib = jnp.where(valid[..., None], local * (1.0 - mirror), 0.0)
        radiance = radiance + throughput * (surf_contrib + miss_contrib)

        if bounce + 1 < cfg.max_bounces:
            refl_d = d_t - 2.0 * jnp.sum(d_t * n, axis=-1, keepdims=True) * n
            live = valid & (mirror[..., 0] > 0.0)
            # Dead rays (miss or non-mirror surface) get d = 0: the cull's
            # tile bounds ignore them and whole-dead tiles get no
            # candidates, so bounce passes cost little for the (usually
            # large) non-mirror fraction of the frame.
            m = live[..., None]
            o_t = jnp.where(m, p + n * RAY_EPS, 0.0)
            d_t = jnp.where(m, normalize(refl_d), 0.0)
            throughput = throughput * mirror

    img = untile(radiance, tiling)
    if with_aux:
        return img, {"overflow": overflow, "need_closest": need_closest,
                     "need_shadow": need_shadow, "need_s": need_s,
                     "live_rays": live_rays}
    return img
