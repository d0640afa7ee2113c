"""Bucketed gradient all-reduce overlapped with the tile backward (T12).

Reference parity: the OpenCL reference has no training loop and no
multi-device communication at all (SURVEY.md §2.1); this is new
scope mandated by BASELINE config 5 ("overlapped gradient all-reduce").

Mechanism. The image rows owned by each chip are split into B buckets; each
bucket's backward pass produces a partial parameter gradient which is
`psum`-ed over the data axis IMMEDIATELY, instead of one monolithic psum of
the full gradient at the end. The per-bucket psums are mutually independent
of the other buckets' forward+backward compute, so XLA's async collectives
and latency-hiding scheduler run bucket b's all-reduce (NCCL over NVLink)
while bucket b+1's backward occupies the compute units — the equivalent of
gradient-bucketing in DDP stacks, with the scheduling done by the
compiler rather than a comm thread.

Numerics: sum over buckets of psum(bucket-grad) == psum(full grad) exactly
up to fp reassociation; tests/dist/test_grad_overlap.py asserts bucketed ==
unbucketed within fp32 tolerance on an 8-device CPU mesh.
"""
from __future__ import annotations

import dataclasses as dc
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tracer.core.camera import Camera, generate_rays
from tracer.core.types import Ray
from tracer.dist.mesh import DATA_AXIS
from tracer.render.whitted import WhittedConfig, render_wavefront, make_brute_tracers
from tracer.scene.types import Scene


def make_overlapped_grad_fn(cfg, mesh: jax.sharding.Mesh, n_buckets: int = 4,
                            tracer_builder=None):
    """Jitted (scene, camera, target) -> (loss, d loss / d verts).

    The loss is the global image MSE; rows are sharded over the data axis and
    each device runs `n_buckets` forward+backward micro-passes, all-reducing
    each bucket's vertex gradient as soon as it exists.
    """
    wcfg = WhittedConfig(max_bounces=cfg.max_bounces,
                         smooth_shading=cfg.smooth_shading)
    builder = tracer_builder or make_brute_tracers
    n_data = mesh.shape[DATA_AXIS]
    if cfg.height % (n_data * n_buckets):
        raise ValueError(
            f"height {cfg.height} not divisible by data axis {n_data} x "
            f"buckets {n_buckets}")

    def shard_fn(scene: Scene, o, d, tgt):
        # o, d, tgt: this device's row shard (H/n_data, W, 3).
        rows = o.shape[0]
        bh = rows // n_buckets
        n_px = cfg.height * cfg.width * 3

        def bucket_loss(verts, ob, db, tb):
            s = dc.replace(scene, verts=verts)
            trace_fn, occlude_fn = builder(s)
            img = render_wavefront(s, Ray(o=ob, d=db), wcfg, trace_fn,
                                   occlude_fn)
            return jnp.sum((img - tb) ** 2) / n_px

        loss = jnp.float32(0.0)
        grads = jnp.zeros_like(scene.verts)
        for b in range(n_buckets):
            sl = slice(b * bh, (b + 1) * bh)
            lb, gb = jax.value_and_grad(bucket_loss)(
                scene.verts, o[sl], d[sl], tgt[sl])
            # `verts` is replicated (unvarying) under shard_map while the
            # bucket loss is device-varying, so autodiff ALREADY inserts the
            # cross-device psum of the vertex cotangent inside this bucket's
            # backward (shard_map's varying-axes rule) — gb is the full
            # cross-chip bucket gradient, and each bucket's all-reduce is an
            # independent collective that overlaps with the next bucket's
            # fwd+bwd compute. Only the scalar loss still needs an explicit
            # psum here. Do NOT psum gb again (that multiplies by the axis
            # size — caught by tests/dist/test_grad_overlap.py).
            loss = loss + jax.lax.psum(lb, DATA_AXIS)
            grads = grads + gb
        return loss, grads

    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(), P()),
    )

    @jax.jit
    def step(scene: Scene, camera: Camera, target: jax.Array):
        rays = generate_rays(camera, cfg.height, cfg.width)
        return sharded(scene, rays.o, rays.d, target)

    return step


def make_unbucketed_grad_fn(cfg, mesh: jax.sharding.Mesh, tracer_builder=None):
    """Reference: same sharded loss with a single end-of-backward psum."""
    return make_overlapped_grad_fn(cfg, mesh, n_buckets=1,
                                   tracer_builder=tracer_builder)
