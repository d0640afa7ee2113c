#!/usr/bin/env python3
"""Smoke run of the tracer's main path on an NVIDIA GPU.

    python3 chip_smoke.py          # phases (a)-(f) on one card
    python3 chip_smoke.py --four   # the sharded paths on four cards

One card, in order:
  (a) device      the platform must be "gpu"; prints device kind, count and
                  the card's name and power limit from nvidia-smi;
  (b) kernel      the Triton walk (closest hit and any hit) against the plain
                  XLA walk at bench100k widths, with memory analysis: 1080p
                  primary rays with their shared origin and with per-ray
                  origins, mirror bounce rays from the primary hits, and
                  shadow segments traced from the light and from the
                  surface;
  (c) forward     make_render_fn on bench100k (102k tris, 1080p): cap sizing,
                  3 timed frames, overflow == 0, live rays, and the frame
                  against the same render through the plain walk;
  (d) grad        3 make_grad_step_fn steps on bunny512 (82k tris, 512x512;
                  verts + albedo + cam_pos) against a rendered target, and
                  gradient parity with the jnp tier (rel-L2 <= 5e-3);
  (e) pod-1m      one exact 1-bounce pod-1m frame (3.9M tris, 1080p) through
                  the same tiled path;
  (f) oracle      a 64x64 Cornell frame through the tiled path against the
                  fp64 C++ oracle.

With --four, only the sharded paths, each against its one-card result:
tile-DP rendering of bench100k on a 4x1 mesh, ring-sharded geometry on a
1x4 mesh, and the bucketed grad all-reduce against the unbucketed one, both
through the sorted walk.

Every phase must pass. The last line of output is one JSON object,
{"ok": true, "device": {...}} on success; a failure prints
{"ok": false, ...} and exits nonzero. Times printed are smoke numbers for
the card named beside them, not a benchmark.
"""
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond, what) -> None:
    """Fail the phase unless cond holds (stays active under python -O)."""
    if not cond:
        raise AssertionError(what)


def timed_ms(fn, n: int):
    """Mean wall ms of n calls of fn(), each waited for, after one untimed
    call (compilation); returns (ms, out)."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn()
        jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3, out


@contextlib.contextmanager
def plain_walk():
    """Trace with the plain XLA walk instead of the platform's choice: the
    reference every kernel result is compared with."""
    from tracer.kernels import walk

    orig = walk.choose_walk
    walk.choose_walk = lambda platform, interpret=False: "reference"
    try:
        yield
    finally:
        walk.choose_walk = orig


def phase_device(ctx):
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"[a] platform={d.platform} device_kind={d.device_kind} "
        f"count={len(devs)}")
    if d.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX platform is {d.platform!r}")
    ctx["card"] = nvidia_smi_line()
    ctx["device"] = {"platform": d.platform, "kind": d.device_kind,
                     "count": len(devs)}
    log(f"[a] card: {ctx['card']}")


def _bench_scene():
    from tracer.api import get_scene
    from tracer.utils.config import load_config

    cfg = load_config("bench100k")
    scene, camera = get_scene(cfg)
    return cfg, scene, camera


def _check_closest(label, kern, ref):
    """Kernel (bt, gid) against the plain walk's: the same hits, best t
    within 1e-6 relative, and a different triangle only at fp32 ties."""
    import numpy as np

    (bt_k, gid_k), (bt_r, gid_r) = kern, ref
    bt_k, gid_k = np.asarray(bt_k), np.asarray(gid_k)
    bt_r, gid_r = np.asarray(bt_r), np.asarray(gid_r)
    np.testing.assert_array_equal(gid_k >= 0, gid_r >= 0)
    hit = gid_k >= 0
    rel = np.abs(bt_k - bt_r)[hit] / np.abs(bt_r)[hit]
    rel_max = float(rel.max()) if rel.size else 0.0
    differ = hit & (gid_k != gid_r)
    # A different triangle is allowed only where both t agree (an fp32 tie
    # between triangles, e.g. on a shared edge).
    ties = differ & (np.abs(bt_k - bt_r) <= 1e-6 * np.abs(bt_r))
    log(f"[b] {label}: {hit.mean():.4f} hit, max rel dt {rel_max:.2e}, "
        f"{int(differ.sum())} gid differences ({int(ties.sum())} ties)")
    check(rel_max <= 1e-6, f"{label}: best-t differs by {rel_max:.2e}")
    check(int(differ.sum()) == int(ties.sum()) <= 64,
          f"{label}: gid differences outside fp32 ties")


def _check_occlusion(label, occ_k, occ_r):
    import numpy as np

    occ_k, occ_r = np.asarray(occ_k), np.asarray(occ_r)
    log(f"[b] {label}: {occ_k.mean():.4f} occluded, "
        f"{int((occ_k != occ_r).sum())} differences")
    np.testing.assert_array_equal(occ_k, occ_r)
    check(0.0 < occ_k.mean() < 1.0, f"{label}: degenerate occlusion fixture")


def phase_kernel(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tracer.bvh import build_scene_accel
    from tracer.bvh.cull import cull_clusters_sorted2
    from tracer.core.types import RAY_EPS, T_FAR, normalize
    from tracer.kernels import walk
    from tracer.kernels.traversal import T_MIN, generate_rays_tiled

    cfg, scene, camera = _bench_scene()
    accel = jax.jit(build_scene_accel)(scene)
    n_cl, n_sc = accel.num_clusters, accel.super_lo.shape[0]
    tri_w = accel.tri_w
    cull = jax.jit(lambda o, d, t: cull_clusters_sorted2(
        accel, o, d, t, n_cl, n_sc))
    o_t, d_t, _ = generate_rays_tiled(camera, cfg.height, cfg.width, 64)
    words, counts, exc, _ = cull(o_t, d_t, T_FAR)
    check(int(exc) == 0, "primary cull dropped candidates")
    log(f"[b] bench100k: {scene.num_tris} tris, {n_cl} clusters, "
        f"{o_t.shape[0]} tiles, max count {int(counts.max())}")
    org = camera.position

    # Closest hit: the primary rays with their shared origin, and again
    # with per-ray origins (origin=None), the path that every bounce pass
    # and the dist tiers' tracers take.
    kern_s = jax.jit(lambda o, d, w, c: walk._closest_pallas(
        o, d, tri_w, w, c, org, T_MIN, False))
    kern_p = jax.jit(lambda o, d, w, c: walk._closest_pallas(
        o, d, tri_w, w, c, None, T_MIN, False))
    ref_s = jax.jit(lambda o, d, w, c: walk._closest_reference(
        o, d, tri_w, w, c, org, T_MIN))
    ref_p = jax.jit(lambda o, d, w, c: walk._closest_reference(
        o, d, tri_w, w, c, None, T_MIN))
    args = (o_t, d_t, words, counts)
    log(f"[b] closest kernel memory: "
        f"{kern_s.lower(*args).compile().memory_analysis()}")
    ms_k, prim_k = timed_ms(lambda: kern_s(*args), 3)
    ms_r, prim_r = timed_ms(lambda: ref_s(*args), 3)
    _check_closest("closest, primary rays, shared origin", prim_k, prim_r)
    log(f"[b] closest shared origin: kernel {ms_k:.3f} ms, plain walk "
        f"{ms_r:.3f} ms [{ctx['card']}]")
    ms_kp, prim_kp = timed_ms(lambda: kern_p(*args), 3)
    _check_closest("closest, primary rays, per-ray origins", prim_kp,
                   ref_p(*args))
    log(f"[b] closest per-ray origins: kernel {ms_kp:.3f} ms "
        f"[{ctx['card']}]")

    # Surface points and normals of the primary hits.
    bt, gid = (np.asarray(x) for x in prim_r)
    hit = gid >= 0
    tri = scene.tris[accel.tri_ids.reshape(-1)[np.maximum(gid, 0)]]
    v0, v1, v2 = (scene.verts[tri[..., i]] for i in range(3))
    n = normalize(jnp.cross(v1 - v0, v2 - v0))
    n = jnp.where(jnp.sum(n * d_t, -1, keepdims=True) > 0, -n, n)
    hitj = jnp.asarray(hit)[..., None]
    p = o_t + jnp.asarray(np.minimum(bt, 1e3))[..., None] * d_t
    lpos = scene.lights.position[0]

    # Mirror bounce rays from every hit point (per-ray origins, divergent
    # directions, dead d == 0 slots where the primary ray missed).
    o_b = jnp.where(hitj, p + n * RAY_EPS, 0.0)
    refl = d_t - 2.0 * jnp.sum(d_t * n, -1, keepdims=True) * n
    d_b = jnp.where(hitj, normalize(refl), 0.0)
    w_b, c_b, exc_b, _ = cull(o_b, d_b, T_FAR)
    check(int(exc_b) == 0, "bounce cull dropped candidates")
    args_b = (o_b, d_b, w_b, c_b)
    ms_kb, bounce_k = timed_ms(lambda: kern_p(*args_b), 3)
    _check_closest("closest, mirror bounce rays", bounce_k, ref_p(*args_b))
    log(f"[b] bounce: max count {int(c_b.max())}, kernel {ms_kb:.3f} ms "
        f"[{ctx['card']}]")

    # Any hit. Shadow segments from the light to every hit point (the
    # shared light origin the tiled path uses), then the same segments
    # traced from the surface towards the light (per-ray origins).
    target = jnp.where(hitj, p, lpos)
    o2 = jnp.broadcast_to(lpos, target.shape)
    d2 = target - lpos
    seg = jnp.sqrt(jnp.maximum(jnp.sum(d2 * d2, axis=-1), 1e-20))
    tm = 1.0 - 10 * RAY_EPS / seg
    w2, c2, exc2, _ = cull(o2, d2, tm)
    check(int(exc2) == 0, "shadow cull dropped candidates")
    o3 = jnp.where(hitj, p + n * RAY_EPS, 0.0)
    d3 = jnp.where(hitj, lpos - o3, 0.0)
    seg3 = jnp.sqrt(jnp.maximum(jnp.sum(d3 * d3, axis=-1), 1e-20))
    tm3 = jnp.where(hit, 1.0 - 10 * RAY_EPS / seg3, 0.0)
    w3, c3, exc3, _ = cull(o3, d3, tm3)
    check(int(exc3) == 0, "surface-origin shadow cull dropped candidates")
    cases = [("any hit, light origin", lpos, (o2, d2, tm, w2, c2)),
             ("any hit, surface origins", None, (o3, d3, tm3, w3, c3))]
    for label, origin, a in cases:
        kern_o = jax.jit(lambda o, d, t, w, c, origin=origin:
                         walk.occlude_walk(o, d, t, accel, w, c,
                                           origin=origin))
        if origin is not None:
            log(f"[b] any-hit kernel memory: "
                f"{kern_o.lower(*a).compile().memory_analysis()}")
        ms_ko, occ_k = timed_ms(lambda: kern_o(*a), 3)
        with plain_walk():
            ref_o = jax.jit(lambda o, d, t, w, c, origin=origin:
                            walk.occlude_walk(o, d, t, accel, w, c,
                                              origin=origin))
            ms_ro, occ_r = timed_ms(lambda: ref_o(*a),
                                    3 if origin is not None else 1)
        _check_occlusion(label, occ_k, occ_r)
        log(f"[b] {label}: kernel {ms_ko:.3f} ms, plain walk "
            f"{ms_ro:.3f} ms [{ctx['card']}]")


def phase_forward(ctx):
    import jax
    import numpy as np

    from tracer.api import make_render_fn
    from tracer.render.tiled import render_tiled
    from tracer.utils.metrics import dist_check

    cfg, scene, camera = _bench_scene()
    run = make_render_fn(scene, cfg)
    t0 = time.perf_counter()
    img, aux = run(scene, camera, with_aux=True)
    jax.block_until_ready(img)
    log(f"[c] bench100k sizing + first frame {time.perf_counter() - t0:.1f} s"
        f", caps {run.state['caps']}")
    ms, (img, aux) = timed_ms(lambda: run(scene, camera, with_aux=True), 3)
    overflow, live = int(aux["overflow"]), int(aux["live_rays"])
    rays = cfg.height * cfg.width * cfg.max_bounces * (1 + scene.lights.count)
    log(f"[c] bench100k {cfg.width}x{cfg.height}: {ms:.3f} ms/frame, "
        f"{rays / ms / 1e3:.1f} Mrays/s, live rays {live}, overflow "
        f"{overflow} [{ctx['card']}]")
    check(overflow == 0, f"overflow {overflow}")
    img = np.asarray(img)
    check(img.shape == (cfg.height, cfg.width, 3) and img.max() > 0.01,
          "wrong shape or black frame")

    kc, k, s = run.state["caps"]
    from tracer.api import _whitted_cfg

    with plain_walk():
        plain = jax.jit(lambda sc, acc, cam: render_tiled(
            sc, acc, cam, cfg.height, cfg.width, _whitted_cfg(cfg),
            k_closest=kc, k_cap=k, s_cap=s))
        ms_p, ref = timed_ms(
            lambda: plain(scene, run.state["accel"], camera), 2)
    log(f"[c] same frame through the plain walk: {ms_p:.3f} ms/frame")
    dist_check(img, np.asarray(ref))


def phase_grad(ctx):
    import dataclasses as dc

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from tracer.api import get_scene, make_grad_step_fn, make_render_fn
    from tracer.utils.config import load_config

    cfg = load_config("bunny512")
    scene, camera = get_scene(cfg)
    # A rendered target of a perturbed scene (darker albedo, vertices
    # moved), so loss and gradients are those of a real fit.
    rng = np.random.default_rng(0)
    off = jnp.asarray(rng.normal(0, 2e-3, scene.verts.shape), jnp.float32)
    s_t = dc.replace(scene, verts=scene.verts + off,
                     materials=dc.replace(scene.materials,
                                          albedo=scene.materials.albedo * 0.8))
    target = jnp.asarray(make_render_fn(s_t, cfg)(s_t, camera))
    params = {"verts": scene.verts,
              "albedo": jnp.asarray(scene.materials.albedo),
              "cam_pos": jnp.asarray(camera.position)}
    opt = optax.sgd(1.0)
    step_t = make_grad_step_fn(cfg, opt, scene=scene, camera=camera)
    step_j = make_grad_step_fn(cfg, opt, tiled="off")

    def grads(step):
        loss, new, _, aux = step(scene, camera, target, params,
                                 opt.init(params))
        check(int(aux["overflow"]) == 0, "grad step dropped candidates")
        return loss, jax.tree.map(lambda a, b: a - b, params, new)

    lt, gt = grads(step_t)
    lj, gj = grads(step_j)
    log(f"[d] bunny512 loss tiled {float(lt):.8f} jnp {float(lj):.8f}")
    for key in params:
        a, b = np.asarray(gt[key]), np.asarray(gj[key])
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        log(f"[d] {key}: rel-L2 {rel:.3e}, max |g| {np.abs(b).max():.3e}")
        check(np.abs(b).max() > 0 and rel <= 5e-3,
              f"{key} gradient rel-L2 {rel:.3e}")

    p, st = params, opt.init(params)
    t0 = time.perf_counter()
    for i in range(3):
        loss, p, st, aux = step_t(scene, camera, target, p, st)
        jax.block_until_ready(p)
        check(int(aux["overflow"]) == 0 and np.isfinite(float(loss)),
              f"step {i}: overflow or non-finite loss")
    ms = (time.perf_counter() - t0) / 3 * 1e3
    log(f"[d] bunny512 grad step (tiled): {ms:.3f} ms/step, loss "
        f"{float(loss):.8f} [{ctx['card']}]")


def phase_pod1m(ctx):
    import jax
    import numpy as np

    from tracer.api import get_scene, make_render_fn
    from tracer.utils.config import load_config

    cfg = load_config("pod-1m", max_bounces=1)
    t0 = time.perf_counter()
    scene, camera = get_scene(cfg)
    log(f"[e] pod-1m scene: {scene.num_tris} tris "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    run = make_render_fn(scene, cfg)
    try:
        t0 = time.perf_counter()
        img, aux = run(scene, camera, with_aux=True)
        jax.block_until_ready(img)
        log(f"[e] sizing + first frame {time.perf_counter() - t0:.1f} s, "
            f"caps {run.state['caps']}")
        ms, (img, aux) = timed_ms(lambda: run(scene, camera, with_aux=True),
                                  1)
        overflow = int(aux["overflow"])
        log(f"[e] pod-1m 1 bounce {cfg.width}x{cfg.height}: {ms:.3f} "
            f"ms/frame, overflow {overflow}, live rays "
            f"{int(aux['live_rays'])} [{ctx['card']}]")
        check(overflow == 0, f"overflow {overflow}")
        img = np.asarray(img)
        check(np.isfinite(img).all() and img.max() > 0.01,
              "non-finite or black frame")
    except Exception:
        if run.state.get("run") is not None:
            compiled = run.state["run"].lower(
                scene, run.state["accel"], camera).compile()
            log(f"[e] memory analysis: {compiled.memory_analysis()}")
        raise


def phase_oracle(ctx):
    import numpy as np

    from tracer.api import get_scene, make_render_fn
    from tracer.refcpu import cpp as cpp_oracle
    from tracer.utils.config import load_config

    cfg = load_config("cornell256", height=64, width=64, use_bvh=True,
                      use_pallas=True)
    scene, camera = get_scene(cfg)
    img = np.asarray(make_render_fn(scene, cfg)(scene, camera))
    ref = cpp_oracle.cpp_render(scene, camera, cfg.height, cfg.width,
                                max_bounces=cfg.max_bounces,
                                smooth_shading=cfg.smooth_shading)
    err = np.abs(img - ref).max(axis=-1)
    frac = float((err > 2e-3).mean())
    p98 = float(np.percentile(err, 98))
    log(f"[f] cornell 64x64 vs C++ oracle: {frac:.4f} of pixels off by "
        f">2e-3, p98 err {p98:.2e}")
    check(img.max() > 0.05 and frac < 0.015 and p98 < 2e-3,
          "frame disagrees with the oracle")


def phase_four(ctx):
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tracer.utils.metrics import dist_check
    from tracer.api import build_tracers, get_scene
    from tracer.core.camera import generate_rays
    from tracer.dist.grad_overlap import (
        make_overlapped_grad_fn, make_unbucketed_grad_fn)
    from tracer.dist.mesh import make_render_mesh
    from tracer.dist.ray_dp import make_sharded_accel_render_fn
    from tracer.dist.ring import make_ring_render_fn
    from tracer.kernels import make_accel_tracers
    from tracer.bvh import build_scene_accel
    from tracer.render.whitted import WhittedConfig, render_wavefront
    from tracer.utils.config import load_config

    devs = jax.devices()
    if len(devs) != 4:
        raise RuntimeError(f"--four needs 4 devices, JAX sees {len(devs)}")
    cfg, scene, camera = _bench_scene()
    wcfg = WhittedConfig(max_bounces=cfg.max_bounces,
                         smooth_shading=cfg.smooth_shading)

    # Tile-DP: image rows over 4 cards, each running the sorted walk.
    mesh = make_render_mesh(devs, data=4, geom=1)
    dp = make_sharded_accel_render_fn(scene, cfg, mesh)
    ms_dp, img = timed_ms(lambda: dp(scene, camera), 3)

    @jax.jit
    def one_card(scene, camera):
        rays = generate_rays(camera, cfg.height, cfg.width)
        return render_wavefront(scene, rays, wcfg,
                                *build_tracers(scene, cfg))

    ms_1, ref = timed_ms(lambda: one_card(scene, camera), 3)
    log(f"[4] tile-DP bench100k 4x1: {ms_dp:.3f} ms/frame on 4 cards, "
        f"{ms_1:.3f} ms/frame on one [{ctx['card']}]")
    dist_check(np.asarray(img), np.asarray(ref))

    # Ring-sharded geometry over 4 cards, exact (uncapped) cull.
    rcfg = cfg.replace(height=540, width=960)
    mesh_g = make_render_mesh(devs, data=1, geom=4)
    ring = make_ring_render_fn(scene, rcfg, mesh_g, use_ring=True,
                               use_accel=True, with_aux=True, k_cap=None)
    ms_r, (img_r, aux) = timed_ms(lambda: ring(scene, camera), 2)
    check(int(aux["overflow"]) == 0, "ring render dropped candidates")

    @jax.jit
    def one_card_jnp(scene, camera):
        accel = build_scene_accel(scene)
        rays = generate_rays(camera, rcfg.height, rcfg.width)
        return render_wavefront(scene, rays, wcfg,
                                *make_accel_tracers(scene, accel))

    ms_rr, ref_r = timed_ms(lambda: one_card_jnp(scene, camera), 2)
    log(f"[4] ring geometry bench100k 1x4 at {rcfg.width}x{rcfg.height}: "
        f"{ms_r:.3f} ms/frame, one-card jnp tier {ms_rr:.3f} ms/frame")
    dist_check(np.asarray(img_r), np.asarray(ref_r))

    # Bucketed against unbucketed grad all-reduce with the sorted walk in
    # the backward pass (bunny512's tracers, cut to 128x128 so 4 cards x 4
    # buckets split it into 8-row bands).
    gcfg = load_config("bunny512", height=128, width=128)
    gscene, gcam = get_scene(gcfg)
    builder = partial(build_tracers, cfg=gcfg)
    target = jnp.full((gcfg.height, gcfg.width, 3), 0.1, jnp.float32)
    bucketed = make_overlapped_grad_fn(gcfg, mesh, n_buckets=4,
                                       tracer_builder=builder)
    single = make_unbucketed_grad_fn(gcfg, mesh, tracer_builder=builder)
    ms_b, (lb, gb) = timed_ms(lambda: bucketed(gscene, gcam, target), 2)
    ms_s, (ls, gs) = timed_ms(lambda: single(gscene, gcam, target), 2)
    gs2 = np.asarray(single(gscene, gcam, target)[1]).ravel()
    gb, gs = np.asarray(gb).ravel(), np.asarray(gs).ravel()
    norm = max(np.linalg.norm(gs), 1e-30)
    rel = np.linalg.norm(gb - gs) / norm
    rerun = np.linalg.norm(gs2 - gs) / norm
    log(f"[4] grad all-reduce bunny512 128x128: bucketed {ms_b:.3f} ms, "
        f"unbucketed {ms_s:.3f} ms, loss {float(lb):.8f} vs "
        f"{float(ls):.8f}, grad rel-L2 {rel:.2e} (unbucketed rerun "
        f"{rerun:.2e})")
    check(abs(float(lb) - float(ls)) <= 1e-5 * abs(float(ls)),
          "bucketed loss differs")
    # Bucketing changes only the order of fp32 sums (each bucket's
    # gradient is reduced apart; the card's scatter-adds are unordered):
    # differences of 1e-5 relative are that rounding. A dropped or doubled
    # bucket is off by 0.25 or more.
    check(np.abs(gs).max() > 0 and rel < 1e-4,
          f"bucketed gradient rel-L2 {rel:.2e}")


def main() -> int:
    four = "--four" in sys.argv[1:]
    ctx = {"card": "?"}
    phases = [("device", phase_device)]
    if four:
        phases.append(("four", phase_four))
    else:
        phases += [("kernel", phase_kernel), ("forward", phase_forward),
                   ("grad", phase_grad), ("pod1m", phase_pod1m),
                   ("oracle", phase_oracle)]
    phase = "setup"
    try:
        sys.path.insert(0, HERE)
        from tracer.utils.cache import enable_compile_cache

        log(f"compile cache: {enable_compile_cache()}")
        for phase, fn in phases:
            t0 = time.perf_counter()
            fn(ctx)
            log(f"phase {phase} passed in {time.perf_counter() - t0:.1f} s")
    except Exception as e:  # report which phase failed, then fail the run
        traceback.print_exc()
        log(json.dumps({"ok": False, "phase": phase,
                        "error": f"{type(e).__name__}: {e}"[:500]}))
        return 1
    log(ctx["card"])
    log(json.dumps({"ok": True, "device": ctx["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
