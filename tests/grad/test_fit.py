"""Inverse-rendering fit loop: convergence, checkpoint/resume, and
kill-mid-run fault injection (SURVEY.md §5 'Failure detection / fault
injection' + §7 PR3; VERDICT r2 item 5)."""
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.api import get_scene
from tracer.diff.fit import (
    FitConfig, fit, init_params, latest_checkpoint, make_loss_fn)
from tracer.utils.config import load_config

CFG = load_config("cornell256", height=32, width=32)


def _problem():
    """Target rendered from a vertex-perturbed scene; fit recovers offsets."""
    import dataclasses as dc

    from tracer.core.camera import generate_rays
    from tracer.render.whitted import (
        WhittedConfig, render_wavefront, make_brute_tracers)

    scene, cam = get_scene(CFG)
    rng = np.random.default_rng(0)
    true_off = jnp.asarray(
        rng.normal(0, 0.02, scene.verts.shape).astype(np.float32))
    wcfg = WhittedConfig(max_bounces=CFG.max_bounces,
                         smooth_shading=CFG.smooth_shading)
    s_true = dc.replace(scene, verts=scene.verts + true_off)
    rays = generate_rays(cam, CFG.height, CFG.width)
    target = render_wavefront(s_true, rays, wcfg, *make_brute_tracers(s_true))
    return scene, cam, target


def test_fit_reduces_loss():
    scene, cam, target = _problem()
    fcfg = FitConfig(steps=30, learning_rate=5e-3)
    params, losses = fit(scene, cam, target, CFG, fcfg)
    assert losses[-1] < 0.3 * losses[0], (
        f"no convergence: {losses[0]:.3g} -> {losses[-1]:.3g}")


def test_checkpoint_resume_continues_from_step(tmp_path):
    scene, cam, target = _problem()
    ck = str(tmp_path / "ck")
    fcfg = FitConfig(steps=10, checkpoint_every=5, checkpoint_dir=ck)
    params_a, losses_a = fit(scene, cam, target, CFG, fcfg)
    step, path = latest_checkpoint(ck)
    assert step == 9

    # Resuming with a larger budget continues from step 10, not step 0.
    fcfg2 = FitConfig(steps=14, checkpoint_every=5, checkpoint_dir=ck)
    params_b, losses_b = fit(scene, cam, target, CFG, fcfg2)
    assert len(losses_b) == 4, "resume must run only the remaining steps"
    assert losses_b[0] < losses_a[0], "resumed loss should reflect progress"


_CHILD = """
import sys
import jax; jax.config.update('jax_platforms', 'cpu')
sys.path.insert(0, {root!r})
from tests.grad.test_fit import _problem, CFG
from tracer.diff.fit import FitConfig, fit
scene, cam, target = _problem()
fcfg = FitConfig(steps=1000, checkpoint_every=3, checkpoint_dir={ck!r})
print('CHILD_START', flush=True)
fit(scene, cam, target, CFG, fcfg)
"""


def test_kill_mid_run_then_resume(tmp_path):
    """Fault injection: SIGKILL the optimization once checkpoints exist;
    a fresh process resumes from the last checkpoint and keeps optimizing."""
    ck = str(tmp_path / "ck")
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(root=root, ck=ck)],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 240
        step = None
        while time.time() < deadline:
            step, _ = latest_checkpoint(ck)
            if step is not None and step >= 5:
                break
            if proc.poll() is not None:
                raise AssertionError("fit child exited before checkpointing")
            time.sleep(0.5)
        assert step is not None, "no checkpoint appeared within deadline"
        proc.send_signal(signal.SIGKILL)  # hard fault, no cleanup
    finally:
        proc.wait(timeout=60)

    killed_at, path = latest_checkpoint(ck)
    assert killed_at is not None

    scene, cam, target = _problem()
    fcfg = FitConfig(steps=killed_at + 4, checkpoint_every=3,
                     checkpoint_dir=ck)
    params, losses = fit(scene, cam, target, CFG, fcfg)
    assert len(losses) == 3, "resume must continue from the checkpoint step"
    assert np.isfinite(losses).all()
    new_step, _ = latest_checkpoint(ck)
    assert new_step == killed_at + 3


def test_fit_edge_accel_recovers_occluder():
    """fit(edge_aware=True) on a use_bvh config dispatches to the accel
    edge tier (diff.edge_accel) and solves an occluder-recovery problem
    that interior-only gradients provably cannot: the occluder sits
    outside the frustum, so it affects the image only through the boolean
    shadow test — the naive (edge_aware=False) fit leaves it exactly in
    place, the edge-aware fit moves it toward the target."""
    import dataclasses as dc

    from tests.grad.test_edge import CAM, occluder_scene
    from tracer.render.whitted import WhittedConfig, render_wavefront
    from tracer.core.camera import generate_rays

    cfg = load_config("bunny-grad", height=64, width=64)
    assert cfg.use_bvh
    dx_true = 0.06
    scene0 = occluder_scene(0.0)
    scene_t = occluder_scene(dx_true)
    from tracer.api import build_tracers

    wcfg = WhittedConfig(max_bounces=cfg.max_bounces,
                         smooth_shading=cfg.smooth_shading)
    rays = generate_rays(CAM, cfg.height, cfg.width)
    target = render_wavefront(scene_t, rays, wcfg, *build_tracers(scene_t, cfg))

    occ_x = lambda p: float(np.mean(np.asarray(p["vert_offset"])[4:, 0]))

    fcfg_naive = FitConfig(steps=25, learning_rate=4e-3, edge_aware=False)
    p_naive, _ = fit(scene0, CAM, target, cfg, fcfg_naive)
    assert abs(occ_x(p_naive)) < 1e-6, \
        "interior-only gradients must leave the off-screen occluder in place"

    fcfg = FitConfig(steps=25, learning_rate=4e-3, edge_aware=True,
                     edge_eps=0.01)
    p_edge, losses = fit(scene0, CAM, target, cfg, fcfg)
    assert occ_x(p_edge) > 0.015, \
        f"edge-aware fit should pull the occluder toward dx={dx_true}, " \
        f"moved {occ_x(p_edge):.4f}"
    assert losses[-1] < 0.6 * losses[0], "edge-aware fit did not reduce loss"
