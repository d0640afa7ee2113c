"""Sorted-walk tracers vs brute force (the walk's kernel in interpret mode
on CPU).

Mirrors the reference's implicit correctness contract: the accelerated
traversal must agree with testing every triangle (SURVEY.md §4 unit tests —
"Pallas traversal vs intersect_brute on random scenes").
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.bvh.cluster import build_clusters
from tracer.bvh.cull import cull_clusters_sorted, pack_candidates, WORD_INVALID
from tracer.core.camera import Camera, generate_rays
from tracer.core.intersect import intersect_brute, any_hit_brute
from tracer.core.types import Ray, T_FAR
from tracer.kernels.walk import make_sorted_tracers
from tracer.scene.procedural import bunny_scene, cornell_box


def _cam(c):
    return Camera.make(**c) if isinstance(c, dict) else c


@pytest.fixture(scope="module")
def bunny():
    scene, cam = bunny_scene(subdiv=3)
    return scene, _cam(cam)


def test_pack_candidates_monotone():
    t = jnp.array([0.0, 0.5, 1.0, 2.0, 1e6], jnp.float32)
    w = pack_candidates(t, jnp.arange(5, dtype=jnp.int32), jnp.ones(5, bool))
    assert bool(jnp.all(w[1:] >= w[:-1]))
    # invalid slots sort last
    w2 = pack_candidates(t, jnp.arange(5, dtype=jnp.int32),
                         jnp.array([True, False, True, True, True]))
    assert int(w2[1]) == int(WORD_INVALID)


def test_closest_matches_brute(bunny):
    scene, cam = bunny
    rays = generate_rays(cam, 64, 64)
    accel = build_clusters(scene.verts, scene.tris)
    trace, _ = make_sorted_tracers(scene, accel, interpret=True)
    got = trace(rays)
    want = intersect_brute(rays, scene.verts, scene.tris)
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want.valid))
    m = np.asarray(want.valid)
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(want.t)[m],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.tri)[m], np.asarray(want.tri)[m])
    np.testing.assert_allclose(np.asarray(got.uv)[m], np.asarray(want.uv)[m],
                               rtol=1e-4, atol=1e-5)


def test_anyhit_matches_brute(bunny):
    scene, cam = bunny
    rays = generate_rays(cam, 48, 48)
    accel = build_clusters(scene.verts, scene.tris)
    _, occlude = make_sorted_tracers(scene, accel, interpret=True)
    t_max = jnp.full(rays.batch_shape, 10.0)
    got = occlude(rays, t_max)
    want = any_hit_brute(rays, scene.verts, scene.tris, t_max=t_max)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_random_soup_closest():
    key = jax.random.PRNGKey(7)
    kv, kr = jax.random.split(key)
    n_tri = 400
    base = jax.random.uniform(kv, (n_tri, 1, 3), minval=-1, maxval=1)
    verts = (base + 0.2 * jax.random.normal(kr, (n_tri, 3, 3))).reshape(-1, 3)
    tris = jnp.arange(n_tri * 3, dtype=jnp.int32).reshape(-1, 3)
    import dataclasses
    from tracer.scene.types import Scene
    scene0, _ = cornell_box()
    scene = dataclasses.replace(
        scene0, verts=verts, tris=tris,
        normals=jnp.zeros_like(verts),
        mat_id=jnp.zeros((n_tri,), jnp.int32))
    o = jnp.zeros((32, 32, 3)) + jnp.array([0.0, 0.0, 3.0])
    ko = jax.random.split(kr)[0]
    d = jax.random.normal(ko, (32, 32, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    rays = Ray(o=o, d=d)
    accel = build_clusters(verts, tris)
    trace, _ = make_sorted_tracers(scene, accel, interpret=True)
    got = trace(rays)
    want = intersect_brute(rays, verts, tris)
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want.valid))
    m = np.asarray(want.valid)
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(want.t)[m],
                               rtol=1e-5, atol=1e-6)


def test_cull_sorted_is_conservative(bunny):
    scene, cam = bunny
    rays = generate_rays(cam, 32, 32)
    accel = build_clusters(scene.verts, scene.tris)
    from tracer.kernels.traversal import tile_rays
    o_t, d_t, _ = tile_rays(rays.o, rays.d, 256)
    words, counts, overflow = cull_clusters_sorted(accel, o_t, d_t, T_FAR,
                                                   accel.num_clusters)
    # words sorted ascending per tile
    w = np.asarray(words)
    assert (np.diff(w, axis=1) >= 0).all()
    # every cluster that brute-force traversal needs must be in the list:
    # check via full render equality in the closest test above; here check
    # counts bounded and valid words decode to real clusters.
    cl = w & ((1 << 17) - 1)
    k = np.asarray(counts)
    for i in range(w.shape[0]):
        assert (cl[i, :k[i]] < accel.num_clusters).all()


def test_shared_origin_bit_identical(bunny):
    """Passing the pass's single origin point (the primary/shadow-pass
    specialization: origin-side products once per cluster row) is
    BIT-identical to per-ray origins whenever every ray carries that exact
    origin, for both the closest walk and the any-hit walk."""
    from tracer.bvh.cull import cull_clusters_sorted2
    from tracer.kernels.traversal import generate_rays_tiled
    from tracer.kernels.walk import occlude_walk, trace_walk

    scene, cam = bunny
    accel = build_clusters(scene.verts, scene.tris, cluster_size=32)
    # Primary rays: generate_rays_tiled broadcasts cam.position exactly.
    o_t, d_t, _ = generate_rays_tiled(cam, 64, 64, 64)
    k = max(8, -(-min(64, accel.num_clusters) // 8) * 8)
    words, counts, e0, _ = cull_clusters_sorted2(accel, o_t, d_t, T_FAR, k)
    assert int(e0) == 0
    bt0, gid0 = trace_walk(o_t, d_t, accel, words, counts, interpret=True)
    bt1, gid1 = trace_walk(o_t, d_t, accel, words, counts,
                           origin=cam.position, interpret=True)
    np.testing.assert_array_equal(np.asarray(bt0), np.asarray(bt1))
    np.testing.assert_array_equal(np.asarray(gid0), np.asarray(gid1))

    # Light-origin shadow segments: o = broadcast(light), d = p - light.
    lpos = jnp.asarray([0.3, 1.4, 0.2], jnp.float32)
    p = o_t + jnp.minimum(bt0, 3.0)[..., None] * d_t
    o2 = jnp.broadcast_to(lpos, p.shape)
    d2 = p - lpos
    tm = jnp.full(o2.shape[:2], 1.0 - 1e-3, jnp.float32)
    w2, c2, x0, _ = cull_clusters_sorted2(accel, o2, d2, tm, k)
    assert int(x0) == 0
    occ0 = occlude_walk(o2, d2, tm, accel, w2, c2, interpret=True)
    occ1 = occlude_walk(o2, d2, tm, accel, w2, c2, origin=lpos,
                        interpret=True)
    np.testing.assert_array_equal(np.asarray(occ0), np.asarray(occ1))
    assert float(np.asarray(occ1).mean()) > 0.0
