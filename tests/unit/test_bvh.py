"""BVH/cluster invariants + traversal vs brute force (SURVEY.md §4: every tri
in exactly one leaf, conservative culling, traversal == brute force)."""
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.bvh.morton import morton3d, morton_decode3d
from tracer.bvh.cluster import build_clusters
from tracer.bvh.cull import cull_clusters
from tracer.core.types import Ray, T_FAR
from tracer.core import intersect as ci
from tracer.kernels.traversal import (
    tile_rays, untile, trace_tiles_jnp, any_hit_tiles_jnp,
)
from tracer.scene.procedural import random_tri_soup, bunny_scene


def test_morton_roundtrip():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 1024, size=(1000, 3)).astype(np.uint32)
    codes = morton3d(jnp.asarray(q))
    back = np.asarray(morton_decode3d(codes))
    np.testing.assert_array_equal(q, back)


def test_morton_orders_locally():
    # Nearby points should have nearby codes more often than far ones.
    a = morton3d(jnp.asarray([[0, 0, 0]], jnp.uint32))[0]
    b = morton3d(jnp.asarray([[1, 0, 0]], jnp.uint32))[0]
    c = morton3d(jnp.asarray([[1023, 1023, 1023]], jnp.uint32))[0]
    assert int(b) - int(a) < int(c) - int(a)


def test_cluster_build_partitions_tris():
    scene = random_tri_soup(300, seed=2)
    accel = build_clusters(scene.verts, scene.tris, cluster_size=64)
    ids = np.asarray(accel.tri_ids).reshape(-1)
    real = ids[ids >= 0]
    # Every triangle appears exactly once.
    assert sorted(real.tolist()) == list(range(300))
    # Cluster AABBs contain their triangles.
    verts = np.asarray(scene.verts)
    tris = np.asarray(scene.tris)
    lo = np.asarray(accel.cluster_lo)
    hi = np.asarray(accel.cluster_hi)
    for ci_, row in enumerate(np.asarray(accel.tri_ids)):
        for t in row[row >= 0]:
            tv = verts[tris[t]]
            assert (tv.min(0) >= lo[ci_] - 1e-5).all()
            assert (tv.max(0) <= hi[ci_] + 1e-5).all()


def _random_rays(n, seed, spread=3.0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * spread
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_cull_is_conservative():
    """No cluster an actual hit lives in may ever be culled."""
    scene = random_tri_soup(500, seed=3)
    accel = build_clusters(scene.verts, scene.tris, cluster_size=64)
    o, d = _random_rays(512, 4)
    hit = ci.intersect_brute(Ray(o=o, d=d), scene.verts, scene.tris)

    o_t, d_t, tiling = tile_rays(o, d, 256)
    cand, counts, _ = cull_clusters(accel, o_t, d_t, T_FAR, accel.num_clusters)
    cand = np.asarray(cand)
    counts = np.asarray(counts)
    # Which cluster holds each tri?
    tri2cl = {}
    for c_idx, row in enumerate(np.asarray(accel.tri_ids)):
        for t in row[row >= 0]:
            tri2cl[int(t)] = c_idx
    tri_flat = np.asarray(hit.tri)
    for i in range(512):
        if tri_flat[i] >= 0:
            tile = i // 256
            cl = tri2cl[int(tri_flat[i])]
            assert cl in cand[tile][: counts[tile]], f"ray {i}: cluster {cl} culled"


@pytest.mark.parametrize("n_tris,c", [(100, 32), (1000, 128)])
def test_traversal_matches_brute(n_tris, c):
    scene = random_tri_soup(n_tris, seed=5)
    accel = build_clusters(scene.verts, scene.tris, cluster_size=c)
    o, d = _random_rays(512, 6)
    ref = ci.intersect_brute(Ray(o=o, d=d), scene.verts, scene.tris)

    o_t, d_t, tiling = tile_rays(o, d, 256)
    cand, counts, over = cull_clusters(accel, o_t, d_t, T_FAR, accel.num_clusters)
    assert not bool(over)
    bt, btri, bu, bv = trace_tiles_jnp(o_t, d_t, accel, cand, counts)
    t = np.asarray(untile(bt, tiling))
    tri = np.asarray(untile(btri, tiling))

    ref_t = np.asarray(ref.t)
    ref_tri = np.asarray(ref.tri)
    # Same triangle or same-distance duplicate hit everywhere.
    same_tri = tri == ref_tri
    same_t = np.isclose(t, ref_t, rtol=1e-4, atol=1e-6)
    assert (same_tri | same_t).all(), f"{(~(same_tri | same_t)).sum()} rays disagree"
    np.testing.assert_allclose(t[ref_tri >= 0], ref_t[ref_tri >= 0], rtol=1e-4)


def test_any_hit_matches_brute():
    scene = random_tri_soup(300, seed=7)
    accel = build_clusters(scene.verts, scene.tris, cluster_size=64)
    o, d = _random_rays(512, 8)
    t_max = jnp.full((512,), 2.5, jnp.float32)
    ref = ci.any_hit_brute(Ray(o=o, d=d), scene.verts, scene.tris, t_max=t_max)

    o_t, d_t, tiling = tile_rays(o, d, 256)
    tm3 = jnp.broadcast_to(t_max[:, None], (512, 3))
    tm_t, _, _ = tile_rays(tm3, tm3, 256)
    tm_t = tm_t[..., 0]
    cand, counts, _ = cull_clusters(accel, o_t, d_t, tm_t, accel.num_clusters)
    occ = untile(any_hit_tiles_jnp(o_t, d_t, tm_t, accel, cand, counts), tiling)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))


def test_image_tiling_roundtrip():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(32, 48, 3)).astype(np.float32)
    o_t, d_t, tiling = tile_rays(jnp.asarray(img), jnp.asarray(img), 256)
    assert o_t.shape == (6, 256, 3)
    back = untile(o_t, tiling)
    np.testing.assert_array_equal(np.asarray(back), img)


def _random_rays_for_cull(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.3, (n, 3)).astype(np.float32) + np.array([0, 0, 2.5], np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[:, 2] -= 1.5  # bias toward the soup
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("n_tris,tr,seed", [(3000, 64, 0), (12000, 64, 1),
                                            (12000, 256, 2)])
def test_two_stage_cull_matches_dense(n_tris, tr, seed):
    """cull_clusters_sorted2 == cull_clusters_sorted whenever no tile
    exceeds the supercluster cap (the monotone-containment argument in its
    docstring, checked exactly: same words, counts, and zero excess)."""
    from tracer.bvh.cull import cull_clusters_sorted, cull_clusters_sorted2

    scene = random_tri_soup(n_tris, seed=seed)
    accel = build_clusters(scene.verts, scene.tris, cluster_size=32)
    assert accel.super_lo.shape[0] > 2  # the two-stage path is exercised
    o, d = _random_rays_for_cull(1024, seed)
    o_t, d_t, _ = tile_rays(o, d, tr)
    k = accel.num_clusters - accel.num_clusters // 3  # force k < Ncl
    k = max(8, -(-k // 8) * 8)
    w1, c1, e1 = cull_clusters_sorted(accel, o_t, d_t, T_FAR, k)
    w2, c2, e2, _need = cull_clusters_sorted2(accel, o_t, d_t, T_FAR, k,
                                              s_cap=accel.super_lo.shape[0])
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
    assert int(e1) == int(e2)


def test_two_stage_cull_supercluster_overflow_reported():
    """A starved supercluster cap must report nonzero excess (never
    silently truncate), even when the cluster-level k_cap is generous."""
    from tracer.bvh.cull import cull_clusters_sorted2

    scene = random_tri_soup(12000, seed=3)
    accel = build_clusters(scene.verts, scene.tris, cluster_size=32)
    o, d = _random_rays_for_cull(1024, 3)
    o_t, d_t, _ = tile_rays(o, d, 256)  # fat tiles: many superclusters hit
    _, _, e, _need = cull_clusters_sorted2(accel, o_t, d_t, T_FAR,
                                           accel.num_clusters // 2, s_cap=1)
    assert int(e) > 0
