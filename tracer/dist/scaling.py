"""Scaling-efficiency sweep (BASELINE.md row 2: >=85% rays/s scaling,
1 chip -> 1 host -> 4 hosts; SURVEY.md §7 PR5).

Measures the PRODUCTION tile-DP path (dist.ray_dp.make_sharded_accel_render_fn
— shard_map over a data mesh, each device generating and tracing only its
row band) on 1, 2, ..., N of whatever devices the process sees, and emits
one row per device count with measured rays/s and efficiency vs the
1-device base. On a multi-card host this produces the BASELINE scaling
table by running one command (`python bench.py --scaling`); on a CPU mesh
the same harness runs end to end (tests) but its timings describe no
device.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def default_device_counts(n: int) -> list[int]:
    """1, 2, 4, ... up to n, always including n itself."""
    counts = []
    k = 1
    while k < n:
        counts.append(k)
        k *= 2
    counts.append(n)
    return counts


def scaling_sweep(cfg, device_counts: list[int] | None = None,
                  iters: int = 3, warmup: int = 1) -> list[dict]:
    """Time the sharded accel render over submeshes of the visible devices.

    Returns one dict per device count: {devices, ms_per_frame, rays_per_s,
    efficiency} — efficiency = rays/s / (devices * rays/s at 1 device).
    The image height is rounded up per count so the row bands divide
    evenly (rays/s uses the actual rendered height).
    """
    from tracer.api import get_scene
    from tracer.dist.mesh import make_render_mesh
    from tracer.dist.ray_dp import make_sharded_accel_render_fn

    devs = jax.devices()
    counts = device_counts or default_device_counts(len(devs))
    checksum = jax.jit(jnp.sum)
    rows: list[dict] = []
    base = None
    for k in counts:
        if k > len(devs):
            break
        h = -(-cfg.height // k) * k
        cfgk = cfg.replace(height=h)
        scene, camera = get_scene(cfgk)
        mesh = make_render_mesh(devs[:k], data=k, geom=1)
        run = make_sharded_accel_render_fn(scene, cfgk, mesh)
        # Pipelined-checksum timing (see api.benchmark): frames enqueue
        # back to back; one scalar readback proves the batch finished.
        float(checksum(run(scene, camera)))
        for _ in range(max(warmup - 1, 0)):
            float(checksum(run(scene, camera)))
        t0 = time.perf_counter()
        img = None
        for _ in range(iters):
            img = run(scene, camera)
        float(checksum(img))
        dt = (time.perf_counter() - t0) / iters
        rays = h * cfgk.width * cfgk.max_bounces * (1 + scene.lights.count)
        rps = rays / dt
        if base is None:
            base = rps / k  # per-device base from the smallest count
        rows.append({
            "devices": k,
            "height": h,
            "ms_per_frame": dt * 1e3,
            "rays_per_s": rps,
            "efficiency": rps / (k * base),
        })
    return rows
