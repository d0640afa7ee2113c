"""Unit tests for the intersection core (SURVEY.md §4: Moller-Trumbore vs
hand-computed hits; packed matmul path vs classic formulation)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.core.types import Ray, T_FAR
from tracer.core import intersect as ci


def test_mt_hand_computed_hit():
    # Unit triangle in z=0 plane, ray straight down the z axis at (.25, .25).
    t, u, v, hit = ci.moller_trumbore(
        jnp.array([0.25, 0.25, 1.0]),
        jnp.array([0.0, 0.0, -1.0]),
        jnp.array([0.0, 0.0, 0.0]),
        jnp.array([1.0, 0.0, 0.0]),
        jnp.array([0.0, 1.0, 0.0]),
    )
    assert bool(hit)
    np.testing.assert_allclose(float(t), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(u), 0.25, rtol=1e-5)
    np.testing.assert_allclose(float(v), 0.25, rtol=1e-5)


def test_mt_miss_outside_and_behind():
    v0, v1, v2 = (jnp.array([0.0, 0.0, 0.0]), jnp.array([1.0, 0.0, 0.0]),
                  jnp.array([0.0, 1.0, 0.0]))
    # Outside the triangle.
    *_, hit = ci.moller_trumbore(jnp.array([0.9, 0.9, 1.0]), jnp.array([0.0, 0.0, -1.0]),
                                 v0, v1, v2)
    assert not bool(hit)
    # Behind the origin.
    *_, hit = ci.moller_trumbore(jnp.array([0.25, 0.25, -1.0]), jnp.array([0.0, 0.0, -1.0]),
                                 v0, v1, v2)
    assert not bool(hit)
    # Parallel to the plane.
    *_, hit = ci.moller_trumbore(jnp.array([0.25, 0.25, 1.0]), jnp.array([1.0, 0.0, 0.0]),
                                 v0, v1, v2)
    assert not bool(hit)


def test_packed_matches_moller_trumbore_random():
    """The matmul affine-map formulation must agree with classic M-T on random
    ray/triangle soups (t, u, v AND the hit mask)."""
    rng = np.random.default_rng(0)
    R, T = 257, 63  # deliberately non-aligned sizes
    o = rng.normal(size=(R, 3)).astype(np.float32) * 2
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    verts = rng.normal(size=(T * 3, 3)).astype(np.float32)
    tris = np.arange(T * 3, dtype=np.int32).reshape(T, 3)

    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    t_ref, u_ref, v_ref, hit_ref = ci.moller_trumbore(
        jnp.asarray(o)[:, None, :], jnp.asarray(d)[:, None, :],
        jnp.asarray(v0)[None], jnp.asarray(v1)[None], jnp.asarray(v2)[None],
    )

    ray = Ray(o=jnp.asarray(o), d=jnp.asarray(d))
    o4, d4 = ray.homogeneous()
    maps = ci.triangle_affine_maps(jnp.asarray(verts), jnp.asarray(tris))
    t_new, u_new, v_new, hit_new = ci.intersect_packed(o4, d4, maps)

    hit_ref = np.asarray(hit_ref)
    hit_new = np.asarray(hit_new)
    # Hit masks may legitimately differ only within float eps of an edge.
    disagree = hit_ref != hit_new
    assert disagree.mean() < 1e-3, f"hit masks disagree on {disagree.mean():.2%}"
    both = hit_ref & hit_new
    np.testing.assert_allclose(np.asarray(t_new)[both], np.asarray(t_ref)[both],
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(u_new)[both], np.asarray(u_ref)[both],
                               rtol=5e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(v_new)[both], np.asarray(v_ref)[both],
                               rtol=5e-3, atol=2e-3)


def test_brute_nearest_hit_vs_cpu_oracle():
    from tracer.refcpu.oracle import _trace
    rng = np.random.default_rng(1)
    T = 40
    verts = rng.normal(size=(T * 3, 3)).astype(np.float32)
    tris = np.arange(T * 3, dtype=np.int32).reshape(T, 3)
    o = rng.normal(size=(32, 3)).astype(np.float32) * 3
    d = rng.normal(size=(32, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    hit = ci.intersect_brute(Ray(o=jnp.asarray(o), d=jnp.asarray(d)),
                             jnp.asarray(verts), jnp.asarray(tris))
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    for i in range(len(o)):
        t_ref, tri_ref, _, _ = _trace(o[i].astype(np.float64), d[i].astype(np.float64),
                                      v0, v1, v2)
        if tri_ref < 0:
            assert int(hit.tri[i]) == -1
        else:
            assert int(hit.tri[i]) == tri_ref, f"ray {i}"
            np.testing.assert_allclose(float(hit.t[i]), t_ref, rtol=1e-3)


def test_degenerate_triangle_never_hits():
    verts = jnp.array([[0.0, 0, 0], [1, 0, 0], [2, 0, 0]], jnp.float32)  # collinear
    tris = jnp.array([[0, 1, 2]], jnp.int32)
    ray = Ray(o=jnp.array([[0.5, 0.0, 1.0]]), d=jnp.array([[0.0, 0.0, -1.0]]))
    hit = ci.intersect_brute(ray, verts, tris)
    assert int(hit.tri[0]) == -1


def test_any_hit_with_per_ray_tmax():
    verts = jnp.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]], jnp.float32)
    tris = jnp.array([[0, 1, 2]], jnp.int32)
    o = jnp.array([[0.25, 0.25, 1.0], [0.25, 0.25, 1.0]])
    d = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    # Triangle at t=1: first ray allowed to reach it, second stops short.
    occ = ci.any_hit_brute(Ray(o=o, d=d), verts, tris,
                           t_max=jnp.array([2.0, 0.5]))
    assert bool(occ[0]) and not bool(occ[1])
