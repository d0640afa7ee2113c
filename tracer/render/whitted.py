"""Whitted-style light transport: direct lighting + shadow rays + mirror
bounces.

Reference parity: the OpenCL reference's render kernel shades each hit with
Lambert/Phong direct lighting, casts shadow rays toward the lights, and
(Whitted-style) follows mirror reflections (SURVEY.md R4, BASELINE capability
"shading and shadow rays", multi-bounce per BASELINE config 4).

Wavefront structure: the bounce loop runs at fixed depth over the whole ray
wavefront; dead rays carry zero throughput instead of exiting (dense SPMD,
no divergence). Tracing is pluggable: `trace_fn(ray) -> Hit` and
`occlude_fn(ray, t_max) -> bool` so the same integrator drives the brute
force path (config 1), the BVH paths (config 2+), and the sharded
distributed paths.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from tracer.core.types import Ray, Hit, normalize, RAY_EPS
from tracer.core import intersect as ci
from tracer.scene.types import Scene

TraceFn = Callable[[Ray], Hit]
OccludeFn = Callable[[Ray, jax.Array], jax.Array]


def make_brute_tracers(scene: Scene) -> tuple[TraceFn, OccludeFn]:
    """Brute-force all-pairs tracers (BASELINE config 1: Cornell, no BVH)."""

    def trace(ray: Ray) -> Hit:
        return ci.intersect_brute(ray, scene.verts, scene.tris)

    def occlude(ray: Ray, t_max: jax.Array) -> jax.Array:
        return ci.any_hit_brute(ray, scene.verts, scene.tris, t_min=RAY_EPS, t_max=t_max)

    return trace, occlude


def shading_frame(scene: Scene, ray: Ray, hit: Hit, smooth: bool):
    """Surface point, shading normal (faced toward the ray), and material
    index at each hit. Misses get harmless defaults (masked out later)."""
    tri = jnp.maximum(hit.tri, 0)
    idx = scene.tris[tri]  # (..., 3)
    p = ray.at(hit.t)
    if smooth:
        n0 = scene.normals[idx[..., 0]]
        n1 = scene.normals[idx[..., 1]]
        n2 = scene.normals[idx[..., 2]]
        u = hit.uv[..., 0:1]
        v = hit.uv[..., 1:2]
        n = normalize(n0 * (1.0 - u - v) + n1 * u + n2 * v)
    else:
        v0 = scene.verts[idx[..., 0]]
        v1 = scene.verts[idx[..., 1]]
        v2 = scene.verts[idx[..., 2]]
        n = normalize(jnp.cross(v1 - v0, v2 - v0))
    # Face the normal against the incoming ray (double-sided shading).
    n = jnp.where(jnp.sum(n * ray.d, axis=-1, keepdims=True) > 0, -n, n)
    mat = scene.mat_id[tri]
    return p, n, mat


def phong_specular(d, n, wi, spec, shin):
    """Classic Phong lobe: ks * max(0, R . wi)^shininess with R the view
    ray's mirror direction about the shading normal. `d` is the (unit)
    incoming ray direction; returns a (...,) scalar weight. Guarded so
    ks == 0 contributes exactly zero with zero gradient (0^n and pow-grad
    NaNs at base 0 are both masked). Mirrored verbatim in both oracles
    (refcpu/oracle.py, cpp/oracle.cpp) — reference parity: SURVEY.md R4
    "Lambert/Phong direct lighting"."""
    r = d - 2.0 * jnp.sum(d * n, axis=-1, keepdims=True) * n
    cos_r = jnp.maximum(jnp.sum(r * wi, axis=-1), 0.0)
    on = spec > 0.0
    base = jnp.where(cos_r > 0.0, cos_r, 1.0)  # pow grad is NaN at 0
    lobe = jnp.where((cos_r > 0.0) & on, base ** shin, 0.0)
    return spec * lobe


def direct_lighting(
    scene: Scene,
    p: jax.Array,
    n: jax.Array,
    d: jax.Array,
    albedo: jax.Array,
    spec: jax.Array,
    shin: jax.Array,
    valid: jax.Array,
    occlude_fn: OccludeFn,
) -> jax.Array:
    """Lambert + Phong direct lighting with shadow rays to every point
    light (SURVEY.md R4). `d` is the incoming ray direction (unit).

    Python loop over lights (light count is small and static) — each light is
    one dense occlusion wavefront.
    """
    total = jnp.zeros_like(p)
    for li in range(scene.lights.count):
        lpos = scene.lights.position[li]
        lint = scene.lights.intensity[li]
        to_l = lpos - p
        dist2 = jnp.sum(to_l * to_l, axis=-1)
        dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
        wi = to_l / dist[..., None]
        cos = jnp.maximum(jnp.sum(n * wi, axis=-1), 0.0)
        # Shadow ray: only meaningful where the surface faces the light
        # AND the receiver is a real hit — invalid rays get d = 0 so the
        # count-driven accel tiers skip them for free (their vis is
        # masked to 0 below either way).
        lit = valid & (cos > 0.0)
        wi_trace = jnp.where(lit[..., None], wi, 0.0)
        shadow_origin = p + n * RAY_EPS
        occluded = occlude_fn(Ray(o=shadow_origin, d=wi_trace),
                              dist - 2 * RAY_EPS)
        vis = jnp.where(occluded | ~valid, 0.0, 1.0)
        falloff = (vis / jnp.maximum(dist2, 1e-20))[..., None] * lint
        brdf = albedo / jnp.pi * cos[..., None] + phong_specular(
            d, n, wi, spec, shin)[..., None]
        total = total + brdf * falloff
    return total


@dataclasses.dataclass(frozen=True)
class WhittedConfig:
    max_bounces: int = 1  # 1 = primary rays only
    smooth_shading: bool = True
    sky_color: tuple = (0.0, 0.0, 0.0)
    ambient: float = 0.04


def bounce_step(
    scene: Scene,
    ray: Ray,
    throughput: jax.Array,
    live: jax.Array,
    cfg: WhittedConfig,
    trace_fn: TraceFn,
    occlude_fn: OccludeFn,
):
    """One Whitted bounce on an explicit wavefront state.

    Returns (contrib, next_ray, next_throughput, next_live): the radiance
    this bounce adds per ray, and the mirror-continuation state. Factored
    out of render_wavefront so distributed drivers can interleave the
    bounce loop with ray re-sharding (dist.ulysses)."""
    sky = jnp.asarray(cfg.sky_color, jnp.float32)
    hit = trace_fn(ray)
    valid = hit.valid & live
    p, n, mat = shading_frame(scene, ray, hit, cfg.smooth_shading)
    albedo = scene.materials.albedo[mat]
    emission = scene.materials.emission[mat]
    mirror = scene.materials.mirror[mat][..., None]
    spec = scene.materials.specular[mat]
    shin = scene.materials.shininess[mat]

    direct = direct_lighting(scene, p, n, ray.d, albedo, spec, shin,
                             valid, occlude_fn)
    local = emission + albedo * cfg.ambient + direct
    # Miss -> sky, weighted by throughput; then the ray dies.
    miss_contrib = jnp.where((live & ~hit.valid)[..., None], sky, 0.0)
    surf_contrib = jnp.where(valid[..., None], local * (1.0 - mirror), 0.0)
    contrib = throughput * (surf_contrib + miss_contrib)

    refl_d = ray.d - 2.0 * jnp.sum(ray.d * n, axis=-1, keepdims=True) * n
    next_live = valid & (mirror[..., 0] > 0.0)
    # Dead rays bounce with d = 0 (see render/tiled.py): brute tiers miss
    # them trivially and count-driven accel tiers skip them for free.
    m = next_live[..., None]
    next_ray = Ray(o=jnp.where(m, p + n * RAY_EPS, 0.0),
                   d=jnp.where(m, normalize(refl_d), 0.0))
    return contrib, next_ray, throughput * mirror, next_live


def render_wavefront(
    scene: Scene,
    ray: Ray,
    cfg: WhittedConfig,
    trace_fn: TraceFn,
    occlude_fn: OccludeFn,
) -> jax.Array:
    """Integrate a wavefront of rays -> linear RGB (..., 3).

    Fixed-depth bounce loop: every iteration traces the full wavefront,
    shades, then continues mirror reflections with multiplied throughput.
    (Unrolled Python loop over a static small bounce count — each bounce has
    different live-mask statistics so XLA sees straight-line fusable code.)
    """
    radiance = jnp.zeros(ray.batch_shape + (3,), jnp.float32)
    throughput = jnp.ones(ray.batch_shape + (3,), jnp.float32)
    live = jnp.ones(ray.batch_shape, bool)

    for bounce in range(cfg.max_bounces):
        contrib, ray, throughput, live = bounce_step(
            scene, ray, throughput, live, cfg, trace_fn, occlude_fn)
        radiance = radiance + contrib
    return radiance


def render_image(
    scene: Scene,
    camera,
    height: int,
    width: int,
    cfg: WhittedConfig = WhittedConfig(),
    trace_fn: TraceFn | None = None,
    occlude_fn: OccludeFn | None = None,
) -> jax.Array:
    """Full-image render -> (H, W, 3) linear RGB."""
    from tracer.core.camera import generate_rays

    if trace_fn is None or occlude_fn is None:
        bt, bo = make_brute_tracers(scene)
        trace_fn = trace_fn or bt
        occlude_fn = occlude_fn or bo
    rays = generate_rays(camera, height, width)
    return render_wavefront(scene, rays, cfg, trace_fn, occlude_fn)
