"""Sorted front-to-back cluster walk: the traversal hot loop.

Reference parity: this plays the role of the reference's divergent per-ray
stack traversal (SURVEY.md R3). Rays are grouped into 64-ray tiles; the
sorted cull (bvh.cull.cull_clusters_sorted2) hands every tile its candidate
clusters as packed words `quantized-entry-t | cluster-id`, sorted ascending,
so the word order IS the front-to-back traversal order and the high bits
are a conservative floor of the distance at which any ray of the tile can
first touch the cluster. The walk intersects the tile with one candidate
cluster at a time and stops as soon as the next candidate's entry distance
exceeds every live ray's current best hit.

Result contract (both implementations, bit-for-bit on one backend): per ray
the lexicographic minimum of (t, gid) over every candidate triangle hit in
(t_min, t_max), where gid = cluster * C + lane is the sorted-slot id that
indexes the accel's shade table; gid = -1 and t = T_FAR on a miss. Because
the minimum is over a set, it does not depend on the candidate order, and
the early exit only skips clusters whose every hit is strictly farther than
the bound, so it changes no result.

Two implementations of one contract:
  * `_closest_reference` / `_anyhit_reference`: plain XLA, a `while_loop`
    over candidate slots for all tiles at once, each tile masked past its
    count and its own early-out bound; the loop ends when no tile is active.
    It runs on the CPU (tests, `--cpu`) and is the reference the kernel is
    checked against.
  * `_closest_pallas` / `_anyhit_pallas`: a Pallas kernel through Triton for
    Hopper. One program per tile; each program loads its own count and
    words from global memory and runs a per-tile `while_loop`. The cluster's
    (4, 3C) affine rows are read from global memory (they stay L2-resident:
    bench100k's ~801 clusters are ~4.9 MB against a 50 MB L2) as 12
    power-of-two (CSUB,) row slices per CSUB-lane chunk. The running best
    is kept per (ray, lane-in-chunk) in registers and reduced across lanes
    once per candidate for the bound and once at the end for the result.

All arithmetic is fp32 FMA / divide / compare on the CUDA cores; there is no
matrix product, so TF32 never enters.

Inputs are selection-only: callers stop-gradient them, and gradients flow
through the differentiable hit recompute (render.tiled, recover_hit), so no
VJP is needed here.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from tracer.bvh.cluster import ClusterAccel
from tracer.bvh.cull import CLUSTER_BITS, cull_clusters_sorted2
from tracer.core.intersect import moller_trumbore
from tracer.core.types import Hit, Ray, T_FAR
from tracer.kernels.traversal import T_MIN, tile_rays, untile

_CL_MASK = (1 << CLUSTER_BITS) - 1
_INT_MAX = 2147483647
# Launch shape, chosen by a sweep on the H100 (PERF.md): one program per
# 64-ray tile, cluster lanes taken 32 at a time, 8 warps. A (64, 32) fp32
# tensor is then 8 registers per thread, so the ~10 live tensors of the
# epilogue plus the (t, gid) carry stay far inside the register file; a
# 64-lane chunk or fewer warps measured slower. The loop is a
# data-dependent while, so there is nothing for software pipelining to
# overlap: one stage.
CSUB = 32
NUM_WARPS = 8
NUM_STAGES = 1


def choose_walk(platform: str, interpret: bool = False) -> str:
    """Which walk implementation runs on `platform`.

    "interpret" only when the caller asks for it (tests, debugging);
    otherwise the Triton kernel on the GPU and the plain XLA walk on the
    CPU. Any other platform has no walk and raises, so nothing falls back
    silently."""
    if interpret:
        return "interpret"
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "reference"
    raise NotImplementedError(
        f"no traversal walk for platform {platform!r} (supported: gpu, cpu)")


def _vma(*xs):
    """The mesh axes any of `xs` varies over inside a `shard_map` (empty
    outside one, or with its check_vma off). The walk's outputs vary over
    exactly these: both implementations type their results with them, so
    every caller's shard_map keeps its varying-axes check."""
    out = frozenset()
    for x in xs:
        if x is not None:
            out |= jax.typeof(x).vma
    return out


def _vary(x, vma):
    """`x` typed as varying over `vma` too; values unchanged."""
    missing = tuple(sorted(vma - jax.typeof(x).vma))
    return jax.lax.pcast(x, missing, to="varying") if missing else x


def _pack_rays(o_t, d_t, t_max_t):
    """(Nt, TR, 3) rays + (Nt, TR) t_max -> (Nt, 8, TR) rows: origin xyz,
    direction xyz, t_max, zero. Row layout keeps every kernel load a
    contiguous power-of-two (TR,) vector."""
    rows = [o_t[..., 0], o_t[..., 1], o_t[..., 2],
            d_t[..., 0], d_t[..., 1], d_t[..., 2], t_max_t,
            jnp.zeros_like(t_max_t)]
    return jnp.stack(rows, axis=1).astype(jnp.float32)


def _origin8(origin):
    return jnp.concatenate([jnp.asarray(origin, jnp.float32).reshape(3),
                            jnp.zeros((5,), jnp.float32)])


def _plane_products(w0, w1, w2, w3, ox, oy, oz, dx, dy, dz):
    """One plane's (so, sd) = (o4 . w, d4 . w) with o4 = [o, 1], d4 = [d, 0]:
    3 FMAs + 1 add and 1 mul + 2 FMAs. Shapes broadcast: w rows (1, L) or
    (L,), rays (R, 1) or scalars (shared origin)."""
    so = w3 + ox * w0 + oy * w1 + oz * w2
    sd = dx * w0 + dy * w1 + dz * w2
    return so, sd


def _epilogue(so_t, sd_t, so_u, sd_u, so_v, sd_v, t_min, t_max):
    """Products -> t where the ray hits the triangle in (t_min, t_max), else
    T_FAR. Raw IEEE divide: where den == 0 the quotient is inf/NaN and every
    comparison below is false. The |den| > 1e-12 test stays so the walk
    never selects a grazing hit that recover_hit's Moller-Trumbore rejects
    (that would mask a real hit behind it)."""
    t = -so_t / sd_t
    u = so_u + t * sd_u
    v = so_v + t * sd_v
    ok = ((jnp.minimum(jnp.minimum(u, v), 1.0 - u - v) >= 0.0)
          & (t > t_min) & (t < t_max) & (jnp.abs(sd_t) > 1e-12))
    return jnp.where(ok, t, T_FAR)


# ---------------------------------------------------------------------------
# Plain XLA walk (CPU path and reference)
# ---------------------------------------------------------------------------

def _ref_setup(o_t, d_t, origin, tri_w):
    c = tri_w.shape[-1] // 3
    if origin is not None:
        o = jnp.asarray(origin, jnp.float32).reshape(3)
        ox, oy, oz = o[0], o[1], o[2]
    else:
        ox, oy, oz = (o_t[..., i:i + 1] for i in range(3))
    dx, dy, dz = (d_t[..., i:i + 1] for i in range(3))
    return c, (ox, oy, oz), (dx, dy, dz)


def _ref_tv(w, c, o3, d3, t_min, t_max):
    """(Nt, 4, 3C) gathered cluster rows -> (Nt, TR, C) t-or-T_FAR."""
    w = w[:, :, None, :]  # (Nt, 4, 1, 3C): rows broadcast over rays
    prods = []
    for p in range(3):
        wp = [w[:, r, :, p * c:(p + 1) * c] for r in range(4)]
        if jnp.ndim(o3[0]) == 0:  # shared origin: (Nt, 1, C) product row
            so = wp[3] + o3[0] * wp[0] + o3[1] * wp[1] + o3[2] * wp[2]
            sd = d3[0] * wp[0] + d3[1] * wp[1] + d3[2] * wp[2]
        else:
            so, sd = _plane_products(*wp, *o3, *d3)
        prods += [so, sd]
    return _epilogue(*prods, t_min, t_max)


def _closest_reference(o_t, d_t, tri_w, words, counts, origin, t_min,
                       vma=frozenset()):
    n_tiles, tr, _ = d_t.shape
    k_cap = words.shape[1]
    n_cl = tri_w.shape[0]
    c, o3, d3 = _ref_setup(o_t, d_t, origin, tri_w)
    live = jnp.any(d_t != 0.0, axis=-1)
    lane = jnp.arange(c, dtype=jnp.int32)

    def active(k, bt):
        word = words[:, jnp.minimum(k, k_cap - 1)]
        bound = jnp.max(jnp.where(live, bt, 0.0), axis=1)
        bound_bits = jax.lax.bitcast_convert_type(bound, jnp.int32)
        return (k < counts) & ((word & ~_CL_MASK) <= bound_bits)

    def cond(carry):
        k, bt, _ = carry
        return (k < k_cap) & jnp.any(active(k, bt))

    def body(carry):
        k, bt, bg = carry
        act = active(k, bt)
        cl = jnp.minimum(words[:, k] & _CL_MASK, n_cl - 1)
        tv = _ref_tv(tri_w[cl], c, o3, d3, t_min, T_FAR)
        tv = jnp.where(act[:, None, None], tv, T_FAR)
        tmin = jnp.min(tv, axis=-1)
        g = cl[:, None, None] * c + lane
        gmin = jnp.min(jnp.where(tv == tmin[..., None], g, _INT_MAX), axis=-1)
        better = (tmin < bt) | ((tmin == bt) & (gmin < bg))
        return (k + 1, jnp.where(better, tmin, bt), jnp.where(better, gmin, bg))

    bt0 = _vary(jnp.full((n_tiles, tr), T_FAR, jnp.float32), vma)
    bg0 = _vary(jnp.full((n_tiles, tr), _INT_MAX, jnp.int32), vma)
    _, bt, bg = jax.lax.while_loop(cond, body, (jnp.int32(0), bt0, bg0))
    return bt, jnp.where(bt < T_FAR, bg, -1)


def _anyhit_reference(o_t, d_t, t_max_t, tri_w, words, counts, origin,
                      t_min, vma=frozenset()):
    n_tiles, tr, _ = d_t.shape
    k_cap = words.shape[1]
    n_cl = tri_w.shape[0]
    c, o3, d3 = _ref_setup(o_t, d_t, origin, tri_w)

    def active(k, occ):
        word = words[:, jnp.minimum(k, k_cap - 1)]
        bound = jnp.max(jnp.where(occ, 0.0, t_max_t), axis=1)
        bound_bits = jax.lax.bitcast_convert_type(bound, jnp.int32)
        return (k < counts) & ((word & ~_CL_MASK) < bound_bits)

    def cond(carry):
        k, occ = carry
        return (k < k_cap) & jnp.any(active(k, occ))

    def body(carry):
        k, occ = carry
        act = active(k, occ)
        cl = jnp.minimum(words[:, k] & _CL_MASK, n_cl - 1)
        tv = _ref_tv(tri_w[cl], c, o3, d3, t_min, t_max_t[..., None])
        hit = jnp.any(tv < T_FAR, axis=-1) & act[:, None]
        return k + 1, occ | hit

    occ0 = _vary(jnp.zeros((n_tiles, tr), bool), vma)
    _, occ = jax.lax.while_loop(cond, body, (jnp.int32(0), occ0))
    return occ


# ---------------------------------------------------------------------------
# Triton kernel (Hopper)
# ---------------------------------------------------------------------------

def _kernel_rays(rays_ref, origin_ref, tile, shared):
    d3 = tuple(rays_ref[tile, 3 + i, :] for i in range(3))
    if shared:
        o3 = tuple(origin_ref[i] for i in range(3))
    else:
        o3 = tuple(rays_ref[tile, i, :][:, None] for i in range(3))
    return o3, d3


def _kernel_chunk_tv(w_ref, cl, j, c, csub, o3, d3, t_min, t_max, shared):
    """Tile x lanes [j*csub, (j+1)*csub) of cluster `cl` -> (TR, csub)."""
    dcol = tuple(x[:, None] for x in d3)
    prods = []
    for p in range(3):
        off = p * c + j * csub
        w0, w1, w2, w3 = (w_ref[cl, r, pl.ds(off, csub)][None, :]
                          for r in range(4))
        if shared:  # one (1, csub) origin-side row for the whole tile
            so = w3 + o3[0] * w0 + o3[1] * w1 + o3[2] * w2
            sd = dcol[0] * w0 + dcol[1] * w1 + dcol[2] * w2
        else:
            so, sd = _plane_products(w0, w1, w2, w3, *o3, *dcol)
        prods += [so, sd]
    return _epilogue(*prods, t_min, t_max)


def _closest_kernel(rays_ref, origin_ref, words_ref, counts_ref, w_ref,
                    bt_ref, gid_ref, *, c, csub, k_cap, n_cl, t_min, shared):
    tile = pl.program_id(0)
    tr = bt_ref.shape[1]
    o3, d3 = _kernel_rays(rays_ref, origin_ref, tile, shared)
    live = (d3[0] != 0.0) | (d3[1] != 0.0) | (d3[2] != 0.0)
    n = counts_ref[tile]
    lane = jax.lax.broadcasted_iota(jnp.int32, (tr, csub), 1)

    def cond(carry):
        k, bound_bits, _, _ = carry
        word = words_ref[tile, jnp.minimum(k, k_cap - 1)]
        return (k < n) & ((word & ~_CL_MASK) <= bound_bits)

    def body(carry):
        k, _, bt, bg = carry
        cl = jnp.minimum(words_ref[tile, k] & _CL_MASK, n_cl - 1)
        for j in range(c // csub):
            tv = _kernel_chunk_tv(w_ref, cl, j, c, csub, o3, d3, t_min,
                                  T_FAR, shared)
            g = lane + (cl * c + j * csub)
            better = (tv < bt) | ((tv == bt) & (g < bg))
            bt = jnp.where(better, tv, bt)
            bg = jnp.where(better, g, bg)
        bound = jnp.max(jnp.where(live, jnp.min(bt, axis=1), 0.0))
        return k + 1, jax.lax.bitcast_convert_type(bound, jnp.int32), bt, bg

    init = (jnp.int32(0),
            jnp.int32(int(np.float32(T_FAR).view(np.int32))),
            jnp.full((tr, csub), T_FAR, jnp.float32),
            jnp.full((tr, csub), _INT_MAX, jnp.int32))
    _, _, bt, bg = jax.lax.while_loop(cond, body, init)
    tmin = jnp.min(bt, axis=1)
    gsel = jnp.min(jnp.where(bt == tmin[:, None], bg, _INT_MAX), axis=1)
    bt_ref[tile, :] = tmin
    gid_ref[tile, :] = jnp.where(tmin < T_FAR, gsel, -1)


def _anyhit_kernel(rays_ref, origin_ref, words_ref, counts_ref, w_ref,
                   occ_ref, *, c, csub, k_cap, n_cl, t_min, shared):
    tile = pl.program_id(0)
    tr = occ_ref.shape[1]
    o3, d3 = _kernel_rays(rays_ref, origin_ref, tile, shared)
    t_max = rays_ref[tile, 6, :]
    n = counts_ref[tile]

    def bound_bits(occ2):
        occ = jnp.max(occ2, axis=1)
        bound = jnp.max(jnp.where(occ > 0.0, 0.0, t_max))
        return jax.lax.bitcast_convert_type(bound, jnp.int32)

    def cond(carry):
        k, bb, _ = carry
        word = words_ref[tile, jnp.minimum(k, k_cap - 1)]
        return (k < n) & ((word & ~_CL_MASK) < bb)

    def body(carry):
        k, _, occ2 = carry
        cl = jnp.minimum(words_ref[tile, k] & _CL_MASK, n_cl - 1)
        for j in range(c // csub):
            tv = _kernel_chunk_tv(w_ref, cl, j, c, csub, o3, d3, t_min,
                                  t_max[:, None], shared)
            occ2 = jnp.maximum(occ2, jnp.where(tv < T_FAR, 1.0, 0.0))
        return k + 1, bound_bits(occ2), occ2

    occ0 = jnp.zeros((tr, csub), jnp.float32)
    _, _, occ2 = jax.lax.while_loop(cond, body,
                                    (jnp.int32(0), bound_bits(occ0), occ0))
    occ_ref[tile, :] = jnp.max(occ2, axis=1)


def _pallas_walk(kernel, out_dtypes, rays, origin, tri_w, words, counts,
                 t_min, interpret, name, vma):
    n_tiles, _, tr = rays.shape
    c = tri_w.shape[-1] // 3
    shared = origin is not None
    body = functools.partial(
        kernel, c=c, csub=min(CSUB, c), k_cap=words.shape[1],
        n_cl=tri_w.shape[0], t_min=t_min, shared=shared)
    origin8 = _origin8(origin) if shared else jnp.zeros((8,), jnp.float32)
    out_shape = tuple(jax.ShapeDtypeStruct((n_tiles, tr), dt, vma=vma)
                      for dt in out_dtypes)
    return pl.pallas_call(
        body,
        out_shape=out_shape,
        grid=(n_tiles,),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        name=name,
    )(rays, origin8, words, counts, tri_w)


def _closest_pallas(o_t, d_t, tri_w, words, counts, origin, t_min, interpret,
                    vma=frozenset()):
    n_tiles, tr, _ = d_t.shape
    rays = _pack_rays(o_t, d_t, jnp.zeros((n_tiles, tr), jnp.float32))
    return _pallas_walk(_closest_kernel, (jnp.float32, jnp.int32), rays,
                        origin, tri_w, words, counts, t_min, interpret,
                        "walk_closest", vma)


def _anyhit_pallas(o_t, d_t, t_max_t, tri_w, words, counts, origin, t_min,
                   interpret, vma=frozenset()):
    rays = _pack_rays(o_t, d_t, t_max_t)
    (occ,) = _pallas_walk(_anyhit_kernel, (jnp.float32,), rays, origin,
                          tri_w, words, counts, t_min, interpret,
                          "walk_anyhit", vma)
    return occ > 0.0


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _selection_inputs(o_t, d_t, tri_w, origin):
    """The walk only selects (which triangle); gradients flow through the
    callers' differentiable hit recompute, so its inputs carry none."""
    sg = jax.lax.stop_gradient
    return (sg(o_t), sg(d_t), sg(tri_w),
            None if origin is None else sg(origin))


def trace_walk(o_t, d_t, accel: ClusterAccel, words, counts, *, origin=None,
               t_min=T_MIN, interpret: bool = False):
    """Closest hit of (Nt, TR, 3) tiled rays over sorted candidate words
    -> (bt, gid) each (Nt, TR); see the module docstring for the contract.

    `origin`: the single exact (3,) origin every ray of the pass shares
    (primary rays, light-origin shadow segments); the walk then computes
    the origin-side products once per cluster row instead of once per ray.
    With `origin` given, `o_t` is ignored."""
    o_t, d_t, tri_w, origin = _selection_inputs(o_t, d_t, accel.tri_w, origin)
    vma = _vma(o_t, d_t, tri_w, words, counts, origin)
    impl = choose_walk(jax.default_backend(), interpret)
    if impl == "reference":
        return _closest_reference(o_t, d_t, tri_w, words, counts, origin,
                                  t_min, vma)
    return _closest_pallas(o_t, d_t, tri_w, words, counts, origin, t_min,
                           impl == "interpret", vma)


def occlude_walk(o_t, d_t, t_max_t, accel: ClusterAccel, words, counts, *,
                 origin=None, t_min=T_MIN, interpret: bool = False):
    """Any hit in (t_min, t_max) of (Nt, TR, 3) tiled rays -> (Nt, TR) bool.
    Padding rays (d == 0) never hit; their t_max is zeroed so they cannot
    hold the early-out bound open."""
    o_t, d_t, tri_w, origin = _selection_inputs(o_t, d_t, accel.tri_w, origin)
    live = jnp.any(d_t != 0.0, axis=-1)
    t_max_t = jnp.where(live, jax.lax.stop_gradient(t_max_t), 0.0)
    vma = _vma(o_t, d_t, t_max_t, tri_w, words, counts, origin)
    impl = choose_walk(jax.default_backend(), interpret)
    if impl == "reference":
        return _anyhit_reference(o_t, d_t, t_max_t, tri_w, words, counts,
                                 origin, t_min, vma)
    return _anyhit_pallas(o_t, d_t, t_max_t, tri_w, words, counts, origin,
                          t_min, impl == "interpret", vma)


def recover_hit(scene, ray: Ray, bt, gid, accel: ClusterAccel,
                t_min=T_MIN) -> Hit:
    """Map the walk's (best-t, sorted-slot id) back to a full Hit: original
    triangle id + exact (t, u, v) via one single-triangle Moller-Trumbore
    per ray (the walk's t is only used for selection)."""
    valid = gid >= 0
    gid_safe = jnp.maximum(gid, 0)
    tri = jnp.where(valid, accel.tri_ids.reshape(-1)[gid_safe], -1)
    tri_safe = jnp.maximum(tri, 0)
    idx = scene.tris[tri_safe]
    v0 = scene.verts[idx[..., 0]]
    v1 = scene.verts[idx[..., 1]]
    v2 = scene.verts[idx[..., 2]]
    # Relaxed barycentric bounds: recovery must not veto the walk's
    # affine-formulation selection over fp rounding (see mt_from_edges).
    t, u, v, hitm = moller_trumbore(ray.o, ray.d, v0, v1, v2, t_min=t_min,
                                    bary_eps=1e-5)
    valid = valid & hitm
    uv = jnp.stack([u, v], axis=-1)
    return Hit(
        t=jnp.where(valid, t, T_FAR),
        tri=jnp.where(valid, tri, -1),
        uv=jnp.where(valid[..., None], uv, 0.0),
    )


def make_sorted_tracers(scene, accel: ClusterAccel, tr: int = 64,
                        interpret: bool = False, t_min=T_MIN):
    """(trace_fn, occlude_fn) over the sorted walk for render_wavefront
    and the dist tiers. The cull keeps every candidate (k = all clusters,
    s = all superclusters), so nothing can be dropped: these tracers are
    exact by construction and have no caps to size. Only the cull's sort
    width grows with the scene; the walk stops at each tile's count."""
    k = max(8, -(-accel.num_clusters // 8) * 8)
    s = accel.super_lo.shape[0]

    def trace_fn(ray: Ray) -> Hit:
        o_t, d_t, tiling = tile_rays(ray.o, ray.d, tr)
        words, counts, _excess, _need = cull_clusters_sorted2(
            accel, o_t, d_t, T_FAR, k, s)
        bt, gid = trace_walk(o_t, d_t, accel, words, counts, t_min=t_min,
                             interpret=interpret)
        return recover_hit(scene, ray, untile(bt, tiling),
                           untile(gid, tiling), accel, t_min=t_min)

    def occlude_fn(ray: Ray, t_max) -> jax.Array:
        o_t, d_t, tiling = tile_rays(ray.o, ray.d, tr)
        if jnp.ndim(t_max) == 0:
            t_max_t = jnp.full(o_t.shape[:2], t_max, jnp.float32)
        else:
            tm3 = jnp.broadcast_to(t_max[..., None], t_max.shape + (3,))
            t_max_t, _, _ = tile_rays(tm3, tm3, tr)
            t_max_t = t_max_t[..., 0]
        words, counts, _excess, _need = cull_clusters_sorted2(
            accel, o_t, d_t, t_max_t, k, s)
        occ = occlude_walk(o_t, d_t, t_max_t, accel, words, counts,
                           t_min=t_min, interpret=interpret)
        return untile(occ, tiling)

    return trace_fn, occlude_fn
