"""Inverse-rendering optimization loop with checkpoint/resume
(SURVEY.md §5 checkpoint/resume, §7 PR3; BASELINE config 3).

Reference parity: the OpenCL reference has no training/optimization of any
kind — this is the differentiable-renderer scope BASELINE adds: recover
scene parameters (vertex offsets, albedo) from a target image by gradient
descent through the renderer, checkpointing optimizer state so a killed run
resumes cleanly (tests/diff/test_fit.py kills mid-run and asserts resume).

Design: the optimized parameters are a small pytree (offset added to the
scene's vertices and/or a replacement albedo table), the loss is image MSE
against the target, and the per-step grads flow through the renderer
selected by cfg (brute tier or the jnp cluster-accel tier for use_bvh
configs — both differentiable; tracer.diff.edge supplies the silhouette
terms when edge_aware=True).
"""
from __future__ import annotations

import dataclasses as dc
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from tracer.core.camera import Camera, generate_rays
from tracer.render.whitted import WhittedConfig, render_wavefront
from tracer.scene.types import Scene
from tracer.utils.config import RenderConfig


@dc.dataclass(frozen=True)
class FitConfig:
    steps: int = 200
    learning_rate: float = 1e-2
    optimize_verts: bool = True
    optimize_albedo: bool = False
    edge_aware: bool = False        # silhouette gradients: diff.edge_accel
    #                                 when cfg.use_bvh, diff.edge otherwise
    edge_eps: float = 1e-2
    edge_clusters: int = 2          # k nearest candidate clusters (accel tier)
    checkpoint_every: int = 25
    checkpoint_dir: str = ""        # empty = no checkpointing


def _apply_params(scene: Scene, params: dict, normal_fn=None) -> Scene:
    if "vert_offset" in params:
        from tracer.scene.types import compute_vertex_normals_jnp

        verts = scene.verts + params["vert_offset"]
        # Recompute smooth-shading normals from the CURRENT vertices
        # (differentiably): stale load-time normals make interior vertex
        # motion nearly invisible to the loss (r5 demo finding).
        # normal_fn = precomputed-incidence gather (make_vertex_normal_fn,
        # ~free) when topology is concrete; scatter fallback otherwise.
        normals = (normal_fn(verts) if normal_fn is not None
                   else compute_vertex_normals_jnp(verts, scene.tris))
        scene = dc.replace(scene, verts=verts, normals=normals)
    if "albedo" in params:
        scene = dc.replace(
            scene, materials=dc.replace(scene.materials, albedo=params["albedo"]))
    return scene


def init_params(scene: Scene, fcfg: FitConfig) -> dict:
    params: dict[str, Any] = {}
    if fcfg.optimize_verts:
        params["vert_offset"] = jnp.zeros_like(scene.verts)
    if fcfg.optimize_albedo:
        params["albedo"] = jnp.asarray(scene.materials.albedo)
    return params


def make_loss_fn(scene: Scene, camera: Camera, target: jax.Array,
                 cfg: RenderConfig, fcfg: FitConfig):
    wcfg = WhittedConfig(max_bounces=cfg.max_bounces,
                         smooth_shading=cfg.smooth_shading)

    # Tiled path for non-edge-aware fits: the stop-gradiented walk selects,
    # the differentiable shade-row recompute carries the gradients. Caps
    # sized by one forward render, widened for parameter motion.
    tiled_caps = None
    if not fcfg.edge_aware:
        from tracer.api import _use_tiled_path, sized_tiled_caps

        if _use_tiled_path(scene, cfg):
            tiled_caps = sized_tiled_caps(scene, camera, cfg)

    from tracer.scene.types import make_vertex_normal_fn

    normal_fn = make_vertex_normal_fn(np.asarray(scene.tris),
                                      scene.verts.shape[0])

    def loss_fn(params):
        s = _apply_params(scene, params, normal_fn=normal_fn)
        if tiled_caps is not None:
            from tracer import api
            from tracer.bvh import build_scene_accel
            from tracer.render.tiled import render_tiled

            accel = build_scene_accel(s)
            img, aux = render_tiled(
                s, accel, camera, cfg.height, cfg.width, wcfg,
                k_closest=tiled_caps[0], k_cap=tiled_caps[1],
                s_cap=tiled_caps[2],
                interpret=api._FORCE_TILED_INTERPRET, with_aux=True)
            # Surfaced truncation: the overflow count rides the loss aux;
            # fit()'s host loop warns on nonzero.
            return jnp.mean((img - target) ** 2), aux["overflow"]
        rays = generate_rays(camera, cfg.height, cfg.width)
        if fcfg.edge_aware and cfg.use_bvh:
            # Accel-tier silhouette gradients: smooth edge terms restricted
            # to the k nearest candidate clusters (diff.edge_accel) — the
            # production edge tier for BVH configs (VERDICT r3 missing #4).
            from tracer.diff.edge_accel import render_diff_accel

            img = render_diff_accel(s, rays, wcfg, edge_eps=fcfg.edge_eps,
                                    k_edge=fcfg.edge_clusters)
        elif fcfg.edge_aware:
            from tracer.diff.edge import render_diff

            img = render_diff(s, rays, wcfg, edge_eps=fcfg.edge_eps)
        elif not cfg.use_bvh:
            # Brute tier with the custom-VJP saved-hit-id replay backward
            # (O(R) instead of O(R x T); tracer.diff.vjp, SURVEY.md §3.2 D).
            from tracer.diff.vjp import make_replay_tracers

            trace_fn, occlude_fn = make_replay_tracers(s)
            img = render_wavefront(s, rays, wcfg, trace_fn, occlude_fn)
        else:
            from tracer.api import build_tracers

            # jnp tier only: the walk is not differentiable through
            # render_wavefront (see api.make_grad_step_fn).
            cfg_nd = (cfg.replace(use_pallas=False) if cfg.use_pallas
                      else cfg)
            trace_fn, occlude_fn = build_tracers(s, cfg_nd)
            img = render_wavefront(s, rays, wcfg, trace_fn, occlude_fn)
        return jnp.mean((img - target) ** 2), jnp.int32(0)

    return loss_fn


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state) -> None:
    """Atomic save of {step, params, opt_state} to ckpt_dir/step_N.npz: the
    flattened tree's leaves go to a temporary file that is then renamed,
    so a run killed mid-write leaves no partial checkpoint behind."""
    leaves = jax.tree_util.tree_leaves((params, opt_state))
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, step=np.int64(step),
                 **{f"leaf_{i:05d}": np.asarray(x)
                    for i, x in enumerate(leaves)})
    os.replace(tmp, path)


def latest_checkpoint(ckpt_dir: str):
    """(step, path) of the newest complete checkpoint, or (None, None)."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None, None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and name.endswith(".npz"):
            try:
                steps.append((int(name[5:-4]), os.path.join(ckpt_dir, name)))
            except ValueError:
                continue
    if not steps:
        return None, None
    return max(steps)


def restore_checkpoint(path: str, like_tree):
    """Load a checkpoint written by save_checkpoint into the structure of
    `like_tree` = {"step", "params", "opt_state"} (values give only the
    tree structure and dtypes)."""
    like = (like_tree["params"], like_tree["opt_state"])
    leaves, treedef = jax.tree_util.tree_flatten(like)
    with np.load(path) as z:
        if len(z.files) != len(leaves) + 1:
            raise ValueError(f"{path}: {len(z.files) - 1} leaves, expected "
                             f"{len(leaves)}")
        loaded = [jnp.asarray(z[f"leaf_{i:05d}"], dtype=jnp.asarray(x).dtype)
                  for i, x in enumerate(leaves)]
        step = int(z["step"])
    params, opt_state = jax.tree_util.tree_unflatten(treedef, loaded)
    return {"step": step, "params": params, "opt_state": opt_state}


def fit(scene: Scene, camera: Camera, target: jax.Array, cfg: RenderConfig,
        fcfg: FitConfig = FitConfig(), optimizer=None, log_every: int = 0,
        metrics=None):
    """Run (or resume) the optimization. Returns (params, losses list).

    Resume: if fcfg.checkpoint_dir holds a checkpoint, optimization
    continues from its step with restored params + optimizer state.
    `metrics` (tracer.utils.metrics.MetricsLogger) gets one record/step.
    """
    import optax

    optimizer = optimizer or optax.adam(fcfg.learning_rate)
    params = init_params(scene, fcfg)
    opt_state = optimizer.init(params)
    start_step = 0

    step_no, path = latest_checkpoint(fcfg.checkpoint_dir)
    if step_no is not None:
        restored = restore_checkpoint(
            path, {"step": step_no, "params": params, "opt_state": opt_state})
        params, opt_state = restored["params"], restored["opt_state"]
        start_step = int(restored["step"]) + 1

    loss_fn = make_loss_fn(scene, camera, target, cfg, fcfg)

    @jax.jit
    def step_fn(params, opt_state):
        (loss, overflow), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return loss, overflow, optax.apply_updates(params, updates), opt_state

    losses = []
    warned = False
    for step in range(start_step, fcfg.steps):
        loss, overflow, params, opt_state = step_fn(params, opt_state)
        losses.append(float(loss))
        if not warned and int(overflow) != 0:
            import sys

            print(f"[fit] WARNING: step {step} dropped {int(overflow)} "
                  f"cull candidates — params outgrew the sized caps' "
                  f"slack; gradients are on truncated geometry",
                  file=sys.stderr)
            warned = True
        if metrics is not None:
            metrics.log(step=step, loss=float(loss))
        if log_every and step % log_every == 0:
            print(f"[fit] step {step:5d}  loss {float(loss):.6g}", flush=True)
        if (fcfg.checkpoint_dir and fcfg.checkpoint_every
                and (step + 1) % fcfg.checkpoint_every == 0):
            save_checkpoint(fcfg.checkpoint_dir, step, params, opt_state)
    if fcfg.checkpoint_dir and fcfg.steps > start_step:
        save_checkpoint(fcfg.checkpoint_dir, fcfg.steps - 1, params, opt_state)
    return params, losses
