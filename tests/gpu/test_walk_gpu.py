"""The walk's Triton kernel as compiled for the card, against the plain XLA
walk (no interpret mode). Runs only on a GPU:
    TRACER_TEST_GPU=1 python -m pytest -m gpu tests/gpu
"""
import jax
import numpy as np
import pytest

from tracer.bvh.cluster import build_clusters
from tracer.bvh.cull import cull_clusters_sorted2
from tracer.core.camera import Camera
from tracer.core.types import T_FAR
from tracer.kernels import walk
from tracer.kernels.traversal import T_MIN, generate_rays_tiled
from tracer.scene.procedural import bunny_scene


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [False, True], ids=["per-ray", "shared"])
def test_triton_walk_matches_plain_walk(shared):
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (the Triton kernel has no CPU "
                    "lowering; its interpret mode is tested in "
                    "tests/unit/test_walk.py)")
    scene, cam = bunny_scene(subdiv=5)
    cam = Camera.make(**cam)
    accel = build_clusters(scene.verts, scene.tris)
    o_t, d_t, _ = generate_rays_tiled(cam, 256, 256, 64)
    words, counts, excess, _ = cull_clusters_sorted2(
        accel, o_t, d_t, T_FAR, accel.num_clusters, accel.super_lo.shape[0])
    assert int(excess) == 0
    org = cam.position if shared else None
    bt_k, gid_k = walk._closest_pallas(o_t, d_t, accel.tri_w, words, counts,
                                       org, T_MIN, False)
    bt_r, gid_r = walk._closest_reference(o_t, d_t, accel.tri_w, words,
                                          counts, org, T_MIN)
    gid_k, gid_r = np.asarray(gid_k), np.asarray(gid_r)
    bt_k, bt_r = np.asarray(bt_k), np.asarray(bt_r)
    np.testing.assert_array_equal(gid_k >= 0, gid_r >= 0)
    hit = gid_k >= 0
    np.testing.assert_allclose(bt_k[hit], bt_r[hit], rtol=1e-6)
    differ = hit & (gid_k != gid_r)
    assert np.all(np.abs(bt_k - bt_r)[differ] <= 1e-6 * np.abs(bt_r)[differ])
