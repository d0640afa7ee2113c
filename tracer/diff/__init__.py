"""Differentiable-rendering layer (SURVEY.md T6, L4).

`edge` — edge-aware visibility gradients: straight-through smoothed-indicator
reparameterization of shadow occlusion and primary coverage (exact forward
images, silhouette-aware backward). `fit` — checkpointed inverse-rendering
optimization loops (atomic .npz checkpoints).
"""
from tracer.diff.edge import (
    render_diff,
    render_diff_image,
    soft_any_hit,
    soft_coverage,
    edge_heights,
)
from tracer.diff.edge_accel import (
    render_diff_accel,
    soft_any_hit_accel,
    soft_coverage_accel,
)
from tracer.diff.fit import FitConfig, fit, init_params, latest_checkpoint
from tracer.diff.vjp import intersect_nearest, make_replay_tracers

__all__ = [
    "render_diff",
    "render_diff_image",
    "soft_any_hit",
    "soft_coverage",
    "edge_heights",
    "render_diff_accel",
    "soft_any_hit_accel",
    "soft_coverage_accel",
    "FitConfig",
    "fit",
    "init_params",
    "latest_checkpoint",
    "intersect_nearest",
    "make_replay_tracers",
]
