"""Gradients through the TILED grad step: make_grad_step_fn's tiled tier —
the stop-gradiented walk selects, the differentiable shade-row recompute
carries the gradients, with the accel built inside the loss — must produce
the same gradients as the jnp accel tier (itself FD-validated in
test_accel_grads.py). The walk's kernel runs in interpret mode on the CPU
test platform; the identical code path runs it compiled on the GPU
(chip_smoke.py phase (d) checks the same parity there)."""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tracer.api import make_grad_step_fn
from tracer.utils.config import load_config

from tests.grad.test_edge import CAM
from tests.grad.test_accel_grads import _tessellated_plane

CFG = load_config("bunny-grad", height=32, width=32, use_pallas=True)


def _grads_via_sgd(step, scene, camera, target, params):
    """Recover grads from one step of sgd(1.0): g = params - new_params."""
    opt = optax.sgd(1.0)
    loss, new_params, _, aux = step(scene, camera, target, params,
                                    opt.init(params))
    assert int(aux["overflow"]) == 0
    return loss, jax.tree.map(lambda a, b: a - b, params, new_params)


@pytest.fixture(scope="module")
def setup():
    scene = _tessellated_plane()
    camera = CAM
    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)
    params = {"verts": scene.verts,
              "albedo": jnp.asarray(scene.materials.albedo)}
    return scene, camera, target, params


def test_tiled_grad_step_matches_jnp_tier(setup):
    scene, camera, target, params = setup
    opt = optax.sgd(1.0)
    step_t = make_grad_step_fn(CFG, opt, tiled="interpret")
    step_j = make_grad_step_fn(CFG, opt, tiled="off")
    loss_t, g_t = _grads_via_sgd(step_t, scene, camera, target, params)
    loss_j, g_j = _grads_via_sgd(step_j, scene, camera, target, params)
    # Same forward light transport -> same loss.
    np.testing.assert_allclose(float(loss_t), float(loss_j),
                               rtol=1e-5, atol=1e-8)
    # Same gradients through both tiers (fp tolerance: the tiled tier
    # recomputes hits from shade rows, the jnp tier from gathered verts).
    for key in params:
        a, b = np.asarray(g_t[key]), np.asarray(g_j[key])
        assert np.abs(b).max() > 0, f"{key}: jnp-tier grad is zero"
        np.testing.assert_allclose(a, b, rtol=2e-3,
                                   atol=2e-6 * np.abs(b).max() + 1e-10,
                                   err_msg=key)


def test_fit_uses_tiled_tier_and_converges(monkeypatch):
    """fit() routes non-edge-aware optimization through the tiled path
    when _use_tiled_path holds (forced interpret here): caps are
    sized by a forward render and the loss decreases."""
    import tracer.api as api
    from tracer.api import get_scene, make_render_fn
    from tracer.diff.fit import FitConfig, fit

    monkeypatch.setattr(api, "_FORCE_TILED_INTERPRET", True)
    cfg = load_config("bunny-grad", height=24, width=24, scene_arg=2,
                      use_pallas=True)
    scene, camera = get_scene(cfg)
    assert api._use_tiled_path(scene, cfg)
    target = jnp.asarray(make_render_fn(scene, cfg)(scene, camera))

    import dataclasses as sdc

    start = sdc.replace(
        scene, verts=scene.verts + jnp.array([0.02, -0.01, 0.015]))
    fcfg = FitConfig(steps=10, learning_rate=2e-3)
    _, losses = fit(start, camera, target, cfg, fcfg)
    # Adam with a fixed lr oscillates near the optimum on this tiny
    # offset; the convergence signal is the best loss reached.
    assert min(losses) < 0.3 * losses[0], losses


def test_tiled_grad_step_verts_fd(setup):
    """Scalar FD check straight through the tiled step's loss: y-offset of
    the frame-filling plane (interior-only motion)."""
    scene, camera, target, params = setup
    from tracer.bvh import build_scene_accel
    from tracer.render.tiled import render_tiled
    from tracer.render.whitted import WhittedConfig

    wcfg = WhittedConfig(max_bounces=CFG.max_bounces,
                         smooth_shading=CFG.smooth_shading)

    def loss(theta):
        s = dc.replace(scene, verts=scene.verts + jnp.array([0.0, theta, 0.0]))
        accel = build_scene_accel(s)
        img = render_tiled(s, accel, camera, CFG.height, CFG.width, wcfg,
                           interpret=True)
        return jnp.mean((img - target) ** 2)

    g = float(jax.jit(jax.grad(loss))(0.0))
    h = 2e-3
    f = jax.jit(loss)
    fd = (float(f(h)) - float(f(-h))) / (2 * h)
    assert abs(fd) > 1e-9
    assert abs(g - fd) <= 0.05 * abs(fd) + 1e-7, f"AD {g} vs FD {fd}"
