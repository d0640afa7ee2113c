"""Degenerate-geometry robustness: zero-area triangles, duplicated
vertices, and coincident faces must never produce NaN/Inf pixels or
crash any tier — the walk's raw-IEEE-divide design (kernels.walk
_epilogue) relies on comparisons rejecting inf/NaN lanes, and this
pins that contract end to end."""
import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest

from tracer.core.camera import Camera, generate_rays
from tracer.render.whitted import WhittedConfig, render_wavefront
from tracer.scene.types import Scene, Materials, Lights


@pytest.fixture(scope="module")
def degenerate_scene():
    """A plane the camera sees, plus: a zero-area triangle (all three
    vertices identical), a sliver (two identical vertices), and an exact
    duplicate of a real triangle."""
    verts = np.array([
        [-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2],   # plane
        [0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [0.5, 0.5, 0.5],  # zero-area
        [0.1, 0.3, 0.1], [0.1, 0.3, 0.1], [0.4, 0.3, 0.2],  # sliver
    ], np.float32)
    tris = np.array([
        [0, 1, 2], [0, 2, 3],      # plane
        [4, 5, 6],                 # zero-area
        [7, 8, 9],                 # sliver
        [0, 1, 2],                 # duplicate of a real face
    ], np.int32)
    mats = Materials.make(albedo=jnp.array([[0.6, 0.5, 0.4]]))
    lights = Lights(position=jnp.array([[0.5, 2.0, 0.3]], jnp.float32),
                    intensity=jnp.array([[4.0, 4.0, 4.0]], jnp.float32))
    scene = Scene.make(verts, tris, np.zeros(len(tris), np.int32), mats,
                       lights)
    cam = Camera.make(position=(0.0, 1.5, 3.0), look_at=(0.0, 0.0, 0.0),
                      fov_y_deg=45.0)
    return scene, cam


def _check(img):
    img = np.asarray(img)
    assert np.isfinite(img).all(), "non-finite pixels"
    assert img.max() > 0.01, "black frame"


def test_degenerate_brute(degenerate_scene):
    from tracer.render.whitted import make_brute_tracers

    scene, cam = degenerate_scene
    wcfg = WhittedConfig(max_bounces=2, smooth_shading=False)
    rays = generate_rays(cam, 32, 32)
    _check(render_wavefront(scene, rays, wcfg, *make_brute_tracers(scene)))


def test_degenerate_tiled_interpret(degenerate_scene):
    from tracer.bvh import build_scene_accel
    from tracer.render.tiled import render_tiled

    scene, cam = degenerate_scene
    wcfg = WhittedConfig(max_bounces=2, smooth_shading=False)
    accel = build_scene_accel(scene)
    img, aux = render_tiled(scene, accel, cam, 32, 32, wcfg,
                            interpret=True, with_aux=True)
    assert int(aux["overflow"]) == 0
    _check(img)


def test_degenerate_matches_brute(degenerate_scene):
    """The accel tiers must agree with brute force on the degenerate
    scene (the zero-area/sliver faces are consistently rejected)."""
    from tracer.bvh import build_scene_accel
    from tracer.render.tiled import render_tiled
    from tracer.render.whitted import make_brute_tracers

    scene, cam = degenerate_scene
    wcfg = WhittedConfig(max_bounces=2, smooth_shading=False)
    rays = generate_rays(cam, 32, 32)
    ref = np.asarray(render_wavefront(scene, rays, wcfg,
                                      *make_brute_tracers(scene)))
    accel = build_scene_accel(scene)
    img = np.asarray(render_tiled(scene, accel, cam, 32, 32, wcfg,
                                  interpret=True))
    mismatch = np.mean(~np.isclose(img, ref, rtol=1e-4, atol=1e-4))
    assert mismatch < 1e-2, f"{mismatch:.3%} pixels differ"
