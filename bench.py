#!/usr/bin/env python3
"""Benchmark driver: prints ONE JSON line with the headline metric.

Headline metric (BASELINE.md): rays/s per card on a ~100k-tri BVH scene at
1080p. The detail dict carries the accounting breakdown:
  - rays/frame = H*W * bounces * (1 + lights): every traced wavefront
    (closest-hit + one shadow pass per light) — primary_rays_per_s is the
    stricter closest-hit-only number;
  - overflow: cull candidates dropped by the k-caps (0 == exact geometry);
  - grad_step_ms: one full optimization step on the bunny-grad preset.
It runs on a GPU only and names the card (nvidia-smi name and power limit)
beside its numbers; without a GPU it fails.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def card_name() -> str:
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def scaling_rows() -> int:
    """--scaling: emit BASELINE.md scaling-table rows.

    With >1 visible card this measures the sharded accel render
    (dist.scaling.scaling_sweep) over submeshes of 1, 2, ..., N cards and
    prints efficiency per row. With one card only its row is measured."""
    import jax

    from tracer.utils.config import load_config

    preset = os.environ.get("BENCH_PRESET", "bench100k")
    iters = int(os.environ.get("BENCH_ITERS", "5"))
    devs = jax.devices()
    n = len(devs)
    kind = devs[0].device_kind
    print("| Topology | rays/s | scaling efficiency | status |")
    print("|---|---|---|---|")
    if n > 1:
        from tracer.dist.scaling import scaling_sweep

        rows = scaling_sweep(load_config(preset), iters=iters)
        for r in rows:
            print(f"| {r['devices']}x {kind} | "
                  f"{r['rays_per_s'] / 1e6:.1f} Mrays/s | "
                  f"{r['efficiency'] * 100:.1f}% | measured |")
        return 0

    from tracer.api import benchmark

    result = benchmark(preset, iters=iters)
    mray = result["rays_per_s"] / 1e6
    print(f"| 1 card ({kind}) | {mray:.1f} Mrays/s "
          f"| 100% (definition) | measured |")
    print(f"| 4 cards | not measured | — | this host exposes {n} device |")
    return 0


def main() -> int:
    import jax

    from tracer.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(json.dumps({"error": f"no GPU: JAX platform is {dev.platform}"}))
        return 1
    enable_compile_cache()
    if "--scaling" in sys.argv:
        return scaling_rows()

    from tracer.api import benchmark, benchmark_grad_step

    preset = os.environ.get("BENCH_PRESET", "bench100k")
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    result = benchmark(preset, iters=iters)
    if result["overflow"] is not None and result["overflow"] != 0:
        # A throughput number on truncated geometry is not a result.
        print(json.dumps({"error": "bench frame dropped cull candidates",
                          "overflow": int(result["overflow"])}))
        return 1
    detail = {
        "ms_per_frame": round(result["ms_per_frame"], 3),
        "num_tris": int(result["num_tris"]),
        "preset": preset,
        "primary_rays_per_s": round(result["primary_rays_per_s"], 1),
        "overflow": result["overflow"],
        "device_kind": dev.device_kind,
        "card": card_name(),
    }
    if result.get("live_rays_per_s") is not None:
        # Rays actually traced (dead wavefront slots excluded).
        detail["live_rays_per_s"] = round(result["live_rays_per_s"], 1)
    if os.environ.get("BENCH_GRAD", "1") != "0":
        g = benchmark_grad_step("bunny-grad", iters=3)
        detail["grad_step_ms"] = round(g["grad_step_ms"], 3)
        detail["grad_preset"] = "bunny-grad"
        # Spec-scale grad step (BASELINE config 3 at bunny512 size, all
        # three parameter families) through the tiled path.
        g5 = benchmark_grad_step("bunny512", iters=3, warmup=1,
                                 params=("verts", "albedo", "cam_pos"))
        detail["grad_step_bunny512_ms"] = round(g5["grad_step_ms"], 3)
        # Gradients on truncated geometry are not a result either.
        detail["grad_step_bunny512_overflow"] = g5.get("overflow")
    out = {
        "metric": "rays_per_s_per_card_100ktri_1080p",
        "value": round(result["rays_per_s"], 1),
        "unit": "rays/s",
        "detail": detail,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
