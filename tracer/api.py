"""User-facing API: render / grad_step / benchmark.

Reference parity: this layer replaces the reference's `main()` + window loop
(SURVEY.md R8, layer L8) with a headless, jit-compiled API and CLI
(bin/trace, bin/bench). "Real-time" is demonstrated by frame-sequence
rendering at benchmark rates rather than an interactive window.
"""
from __future__ import annotations

import os
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tracer.core.camera import Camera, generate_rays
from tracer.render.whitted import WhittedConfig, render_wavefront, make_brute_tracers
from tracer.scene import cornell_box, bunny_scene, columned_hall, random_tri_soup, load_obj
from tracer.scene.types import Scene
from tracer.utils.config import RenderConfig, load_config


def get_scene(cfg: RenderConfig) -> tuple[Scene, Camera]:
    """Resolve the scene + canonical camera named by the config."""
    if cfg.scene == "cornell":
        scene, cam = cornell_box()
    elif cfg.scene == "bunny":
        scene, cam = bunny_scene(subdiv=cfg.scene_arg or 5)
    elif cfg.scene == "hall":
        scale = max(cfg.scene_arg, 0)
        scene, cam = columned_hall(
            cols_x=12 * (1 + scale), cols_z=8 * (1 + scale), blob_subdiv=4 + (1 if scale else 0)
        )
    elif cfg.scene == "bench":
        from tracer.scene.procedural import bench_scene

        scene, cam = bench_scene()
    elif cfg.scene == "soup":
        scene = random_tri_soup(cfg.scene_arg or 1024)
        cam = dict(position=(0.0, 0.5, 3.0), look_at=(0.0, 0.0, 0.0), fov_y_deg=45.0)
    elif cfg.scene.startswith("obj:"):
        scene = load_obj(cfg.scene[4:])
        lo = np.asarray(scene.verts).min(0)
        hi = np.asarray(scene.verts).max(0)
        c = (lo + hi) / 2
        cam = dict(
            position=tuple(c + np.array([0.0, 0.3, 1.2]) * np.linalg.norm(hi - lo)),
            look_at=tuple(c),
            fov_y_deg=45.0,
        )
    else:
        raise ValueError(f"unknown scene '{cfg.scene}'")
    return scene, Camera.make(**cam)


def build_tracers(scene: Scene, cfg: RenderConfig):
    """Pick the tracing backend for render_wavefront: brute force, the jnp
    cluster tier, or the sorted walk (kernels.walk, chosen by platform)."""
    if cfg.use_bvh:
        from tracer.bvh import build_scene_accel
        from tracer.kernels import make_accel_tracers
        from tracer.kernels.walk import make_sorted_tracers

        accel = build_scene_accel(scene)
        if cfg.use_pallas:
            return make_sorted_tracers(scene, accel)
        return make_accel_tracers(scene, accel)
    return make_brute_tracers(scene)


def _whitted_cfg(cfg: RenderConfig) -> WhittedConfig:
    return WhittedConfig(max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)


# Test hook: run the tiled path's walk as its Pallas kernel in interpret
# mode, so the sizing / ensure-exact / tiled-grad machinery exercises the
# kernel on the CPU test platform (tests monkeypatch this; production
# leaves it False and the walk is chosen by platform).
_FORCE_TILED_INTERPRET = False

# Memory-bounded cap ceilings for the sizing loop: the cull's stage-2
# intermediates scale with Ntiles * s_cap * SUPER_FACTOR and its words with
# Ntiles * k, so an unbounded escalation can demand tens of GB at compile
# time (a 2-bounce 1080p frame of the 3.9M-tri hall needs nearly every
# supercluster: divergent bounce-ray tiles have fat interval-hull frusta).
# Past these ceilings the sizing stops and the residual overflow stays
# surfaced in aux; the answer for such configs is ring-sharded geometry
# across cards (dist/ring.py). 1-bounce frames at pod-1m scale size to
# exactness inside them.
S_CAP_MAX = 256
K_CAP_MAX = 2048


def _caps_cache_path() -> str:
    from tracer.utils.cache import caps_cache_path

    return caps_cache_path()


def _scene_cap_key(scene: Scene, camera: Camera, cfg: RenderConfig) -> str:
    """Cheap content hash for the sized-caps cache: shapes + sampled vertex
    bytes + camera + the cfg fields that shape the pipeline. A collision or
    a stale entry is SAFE — cached caps only seed the sizing loop, which
    still renders, checks overflow == 0, and widens if the scene outgrew
    them (caps are monotone; excess is always surfaced)."""
    import hashlib

    v = np.asarray(scene.verts)
    t = np.asarray(scene.tris)
    h = hashlib.sha1()
    h.update(str((v.shape, t.shape, cfg.height, cfg.width, cfg.max_bounces,
                  cfg.smooth_shading,
                  tuple(np.asarray(camera.position).tolist()))).encode())
    h.update(v[:: max(1, len(v) // 64)].tobytes())
    h.update(t[:: max(1, len(t) // 64)].tobytes())
    return h.hexdigest()


def _caps_cache_load(key: str):
    import json

    try:
        with open(_caps_cache_path()) as f:
            raw = json.load(f).get(key)
    except (OSError, ValueError):
        return None
    if (isinstance(raw, list) and len(raw) == 3
            and all(isinstance(x, int) for x in raw)):
        return tuple(raw)
    return None


def _caps_cache_store(key: str, caps) -> None:
    import json

    path = _caps_cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        data[key] = list(caps)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except OSError:
        pass  # cache is an optimization only


def _use_tiled_path(scene: Scene, cfg: RenderConfig) -> bool:
    return cfg.use_bvh and cfg.use_pallas


def make_render_fn(scene: Scene, cfg: RenderConfig):
    """Build the (scene, camera) -> image function for this config.

    The scene geometry is a traced argument (differentiable); tracer choice
    and image size are static. Tiled configs (use_bvh and use_pallas) run
    render.tiled with caps sized per scene; the others run the wavefront
    integrator with exact-by-construction tracers.
    """
    wcfg = _whitted_cfg(cfg)

    if _use_tiled_path(scene, cfg):
        from tracer.bvh import build_scene_accel
        from tracer.render.tiled import render_tiled, K_CLOSEST, K_SHADOW, S_CAP

        build = jax.jit(build_scene_accel)
        default_caps = (K_CLOSEST, K_SHADOW, S_CAP)

        def build_run(caps):
            kc, k, s = caps

            @jax.jit
            def run_tiled(scene: Scene, accel, camera: Camera):
                return render_tiled(scene, accel, camera, cfg.height,
                                    cfg.width, wcfg, with_aux=True,
                                    k_closest=kc, k_cap=k, s_cap=s,
                                    interpret=_FORCE_TILED_INTERPRET)

            return run_tiled

        # The accel is built at scene load and reused across frames (the
        # reference builds its BVH once in main(), SURVEY.md §3.1 A); a new
        # scene object triggers a rebuild — and a cap-sizing pass: the
        # (closest k, shadow k, supercluster s) caps are escalated to the
        # measured per-tile needs until the frame reports zero cull
        # overflow, so silent geometry truncation cannot happen for a
        # static scene below the memory ceilings. A camera moving later can
        # still overflow; aux['overflow'] stays exposed and bench fails on
        # it.
        state = {"scene": None, "accel": None, "caps": default_caps,
                 "run": None}

        def _size_caps(scene, accel, camera):
            import sys

            n_cl = accel.num_clusters
            n_sc = accel.super_lo.shape[0]
            r8 = lambda v: max(8, -(-int(v) // 8) * 8)
            for _ in range(8):
                if state["run"] is None:
                    state["run"] = build_run(state["caps"])
                _, aux = state["run"](scene, accel, camera)
                if int(aux["overflow"]) == 0:
                    return
                # need_s is EXACT (stage 1 is measured untruncated); the k
                # needs are exact once s covers need_s and only lower
                # bounds before that — the next iteration re-measures them
                # under the wider s, so monotone escalation converges.
                kc, k, s = state["caps"]
                new = (min(max(r8(aux["need_closest"]), kc), n_cl, K_CAP_MAX),
                       min(max(r8(aux["need_shadow"]), k), n_cl, K_CAP_MAX),
                       min(max(int(aux["need_s"]) + 2, s), n_sc, S_CAP_MAX))
                if new == state["caps"]:
                    print(f"[tracer] sizing at memory ceiling with overflow "
                          f"{int(aux['overflow'])} (caps {new}): this config "
                          f"needs the ring-sharded tier for exactness",
                          file=sys.stderr)
                    return
                print(f"[tracer] sizing (overflow {int(aux['overflow'])}): "
                      f"caps {state['caps']} -> {new}", file=sys.stderr)
                state["caps"] = new
                state["run"] = build_run(new)
            print("[tracer] sizing stopped at its iteration limit; overflow "
                  "stays surfaced in aux", file=sys.stderr)

        def run(scene: Scene, camera: Camera, with_aux: bool = False,
                ensure_exact: bool = False):
            if state["scene"] is not scene:
                state["accel"] = build(scene)
                state["scene"] = scene
                # Reset to the defaults so a small scene after a large one
                # doesn't inherit oversized caps — then seed from the
                # persisted per-scene cache: a warm entry makes the sizing
                # pass converge on its first iteration. Stale entries are
                # safe: the loop still verifies overflow == 0.
                state["key"] = _scene_cap_key(scene, camera, cfg)
                cached = _caps_cache_load(state["key"])
                state["caps"] = cached if cached is not None else default_caps
                state["run"] = None
                _size_caps(scene, state["accel"], camera)
                _caps_cache_store(state["key"], state["caps"])
            img, aux = state["run"](scene, state["accel"], camera)
            if ensure_exact and int(aux["overflow"]) != 0:
                # Camera moved past the sized caps (e.g. mid-animation):
                # re-size (monotone widening) for THIS camera and re-render,
                # so every returned frame is exact — used by
                # bin/trace --animate. The widened caps persist under the
                # scene-load key.
                _size_caps(scene, state["accel"], camera)
                img, aux = state["run"](scene, state["accel"], camera)
                _caps_cache_store(state["key"], state["caps"])
            return (img, aux) if with_aux else img

        run.state = state  # sized caps readable by make_grad_step_fn
        return run

    trace_fn_builder = partial(build_tracers, cfg=cfg)

    @jax.jit
    def run_jit(scene: Scene, camera: Camera) -> jax.Array:
        trace_fn, occlude_fn = trace_fn_builder(scene)
        rays = generate_rays(camera, cfg.height, cfg.width)
        return render_wavefront(scene, rays, wcfg, trace_fn, occlude_fn)

    def run(scene: Scene, camera: Camera, with_aux: bool = False,
            ensure_exact: bool = False):
        # Non-tiled tracers have no caps: every frame is exact by
        # construction, so ensure_exact is a no-op and aux is trivial.
        img = run_jit(scene, camera)
        return (img, {"overflow": jnp.int32(0)}) if with_aux else img

    return run


def render(config: str | RenderConfig | None = None, **overrides) -> np.ndarray:
    """One-call render: resolve config -> scene -> jit -> (H, W, 3) float32."""
    cfg = config if isinstance(config, RenderConfig) else load_config(config, **overrides)
    scene, camera = get_scene(cfg)
    run = make_render_fn(scene, cfg)
    return np.asarray(run(scene, camera))


def _apply_grad_params(scene: Scene, camera: Camera, p: dict,
                       normal_fn=None):
    import dataclasses as dc

    from tracer.scene.types import compute_vertex_normals_jnp

    s = scene
    if "verts" in p:
        # Normals track the optimized vertices (differentiably) — see
        # diff.fit._apply_params. `normal_fn` is the precomputed-incidence
        # gather version (make_vertex_normal_fn) when the topology is
        # known concretely; the scatter fallback works for traced scenes.
        normals = (normal_fn(p["verts"]) if normal_fn is not None
                   else compute_vertex_normals_jnp(p["verts"], s.tris))
        s = dc.replace(s, verts=p["verts"], normals=normals)
    if "albedo" in p:
        s = dc.replace(s, materials=dc.replace(s.materials, albedo=p["albedo"]))
    cam = camera
    if "cam_pos" in p:
        cam = dc.replace(cam, position=p["cam_pos"])
    return s, cam


def sized_tiled_caps(scene: Scene, camera: Camera, cfg: RenderConfig,
                     slack: int = 16):
    """Cap-size the tiled path for (scene, camera) via one forward render
    and return (k_closest, k_shadow, s) widened by `slack` so small
    parameter motion during optimization can't overflow (overflow stays
    surfaced in aux either way)."""
    run = make_render_fn(scene, cfg)
    run(scene, camera)
    kc, k, s = run.state["caps"]
    accel = run.state["accel"]
    n_cl = accel.num_clusters
    n_sc = accel.super_lo.shape[0]
    r8 = lambda v: max(8, -(-int(v) // 8) * 8)
    return (min(r8(kc + slack), n_cl), min(r8(k + slack), n_cl),
            min(s + 2, n_sc))


def make_grad_step_fn(cfg: RenderConfig, optimizer, scene: Scene = None,
                      camera: Camera = None, tiled: str = "auto"):
    """Jitted (scene, camera, target, params, opt_state) ->
    (loss, params, opt_state, aux) optimization step of the image MSE
    w.r.t. scene params. aux["overflow"] counts cull candidates dropped
    because the parameters outgrew the sized caps: 0 means exact
    gradients (the jnp tiers are structurally 0); callers should warn or
    re-size on nonzero. `params` selects what is optimized: dict with optional
    keys 'verts', 'albedo', 'cam_pos'. Used by the inverse-rendering loop
    (tracer.diff.fit, BASELINE config 3).

    tiled: "auto" differentiates through the tiled path (render.tiled: the
    stop-gradiented walk selects, the shade-row recompute carries the
    gradients) when `_use_tiled_path` holds AND (scene, camera) are
    provided for the cap-sizing forward pass. "interpret" forces the tiled
    path with the walk's kernel in interpret mode and unbounded caps (CPU
    tests); "off" always uses the wavefront jnp tracers."""
    import optax

    wcfg = _whitted_cfg(cfg)

    use_tiled = (tiled == "interpret"
                 or (tiled == "auto" and scene is not None
                     and camera is not None and _use_tiled_path(scene, cfg)))
    if use_tiled:
        from tracer.bvh import build_scene_accel
        from tracer.render.tiled import render_tiled

        interpret = tiled == "interpret" or _FORCE_TILED_INTERPRET
        normal_fn = None
        if scene is not None:
            from tracer.scene.types import make_vertex_normal_fn

            normal_fn = make_vertex_normal_fn(np.asarray(scene.tris),
                                              scene.verts.shape[0])
        if tiled == "interpret":
            # Always-correct caps: render_tiled/cull clamp k to the
            # cluster count and s to the supercluster count, so huge
            # requests mean NO truncation anywhere.
            caps = (1 << 20, 1 << 20, 1 << 20)
        else:
            caps = sized_tiled_caps(scene, camera, cfg)

        @jax.jit
        def step_tiled(scene: Scene, camera: Camera, target: jax.Array,
                       params, opt_state):
            def loss_fn(p):
                s, cam = _apply_grad_params(scene, camera, p,
                                            normal_fn=normal_fn)
                # Accel built INSIDE the loss: cluster assignment and the
                # walk are stop-gradiented (piecewise constant), but the
                # shade rows (v0/e1/e2/normals/albedo) are differentiable
                # functions of the current params, so grads flow through
                # the row recompute (render/tiled.py docstring).
                accel = build_scene_accel(s)
                img, aux = render_tiled(s, accel, cam, cfg.height,
                                        cfg.width, wcfg,
                                        interpret=interpret, with_aux=True,
                                        k_closest=caps[0], k_cap=caps[1],
                                        s_cap=caps[2])
                return jnp.mean((img - target) ** 2), aux["overflow"]

            (loss, overflow), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, new_opt_state = optimizer.update(grads, opt_state, params)
            # Parameters that outgrow the sized caps' slack must not
            # silently corrupt gradients: the overflow is a step output.
            return (loss, optax.apply_updates(params, updates),
                    new_opt_state, {"overflow": overflow})

        return step_tiled

    # Non-tiled: the wavefront integrator over the jnp tiers, which are
    # differentiable end to end (render_wavefront does not stop-gradient
    # its tracers the way render_tiled does, so the walk is not used here).
    cfg_nd = cfg.replace(use_pallas=False) if cfg.use_pallas else cfg

    @jax.jit
    def step(scene: Scene, camera: Camera, target: jax.Array, params, opt_state):
        def loss_fn(p):
            s, cam = _apply_grad_params(scene, camera, p)
            trace_fn, occlude_fn = build_tracers(s, cfg_nd)
            rays = generate_rays(cam, cfg.height, cfg.width)
            img = render_wavefront(s, rays, wcfg, trace_fn, occlude_fn)
            return jnp.mean((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, new_opt_state = optimizer.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        # Same 4-output contract as the tiled step; the jnp tiers cannot
        # truncate, so overflow is structurally 0.
        return loss, new_params, new_opt_state, {"overflow": jnp.int32(0)}

    return step


# Compiled-step cache for the grad_step convenience wrapper: without it a
# Python loop over grad_step would rebuild a fresh @jax.jit closure (and
# recompile the full render+backward graph) every iteration. Keyed on the
# frozen config + optimizer identity (optax transforms are NamedTuples of
# functions — hashable). Bounded: each entry pins a compiled
# render+backward executable, so passing a fresh optax instance per call
# must recycle the oldest entry rather than leak compiles. Loops should
# still prefer make_grad_step_fn.
_GRAD_STEP_CACHE: dict = {}
_GRAD_STEP_CACHE_MAX = 4
_GRAD_STEP_CALLS = 0
_DEFAULT_ADAM = None


def grad_step(scene: Scene, camera: Camera, target: jax.Array, cfg: RenderConfig,
              optimizer=None, opt_state=None, params=None):
    """One optimization step (convenience wrapper over make_grad_step_fn).

    Returns (loss, new_params, new_opt_state)."""
    import optax

    global _DEFAULT_ADAM
    if params is None:
        params = {"verts": scene.verts}
    if optimizer is None:
        if _DEFAULT_ADAM is None:
            _DEFAULT_ADAM = optax.adam(1e-3)
        optimizer = _DEFAULT_ADAM
    if opt_state is None:
        opt_state = optimizer.init(params)
    key = (cfg, optimizer)
    step = _GRAD_STEP_CACHE.get(key)
    if step is None:
        while len(_GRAD_STEP_CACHE) >= _GRAD_STEP_CACHE_MAX:
            _GRAD_STEP_CACHE.pop(next(iter(_GRAD_STEP_CACHE)))
        step = _GRAD_STEP_CACHE[key] = make_grad_step_fn(cfg, optimizer)
    loss, new_params, new_opt_state, aux = step(scene, camera, target,
                                                params, opt_state)
    # Overflow check: reading the scalar forces a device sync, which would
    # serialize a tight loop over this wrapper — check the first and then
    # every 16th call (loops should prefer make_grad_step_fn and read the
    # step's aux themselves).
    global _GRAD_STEP_CALLS
    _GRAD_STEP_CALLS += 1
    if _GRAD_STEP_CALLS % 16 in (1,) and int(aux["overflow"]) != 0:
        import sys

        print(f"[tracer] WARNING: grad step dropped {int(aux['overflow'])} "
              f"cull candidates — params outgrew the sized caps",
              file=sys.stderr)
    return loss, new_params, new_opt_state


def benchmark(config: str | RenderConfig | None = None, iters: int = 10,
              warmup: int = 2, **overrides) -> dict:
    """Timed forward renders -> rays/s and ms/frame."""
    cfg = config if isinstance(config, RenderConfig) else load_config(config, **overrides)
    scene, camera = get_scene(cfg)
    run = make_render_fn(scene, cfg)
    img = run(scene, camera)
    img.block_until_ready()
    for _ in range(max(warmup - 1, 0)):
        run(scene, camera).block_until_ready()
    from tracer.utils.metrics import profile_trace

    # Pipelined throughput: frames are enqueued back to back (the device
    # runs them in order) and the last one is waited for.
    with profile_trace(cfg.profile):
        t0 = time.perf_counter()
        for _ in range(iters):
            img = run(scene, camera)
        img.block_until_ready()
        dt = (time.perf_counter() - t0) / iters
    # Every render-fn variant supports with_aux (the tiled path reports
    # real cull overflow; the exact-by-construction tiers report 0).
    _, aux = run(scene, camera, with_aux=True)
    overflow = int(aux["overflow"]) if "overflow" in aux else None
    live_rays = int(aux["live_rays"]) if "live_rays" in aux else None
    primary_rays = cfg.height * cfg.width
    # Count every traced wavefront: per bounce one closest-hit pass plus one
    # shadow pass per light (the standard rays/s accounting for Whitted).
    # `primary_rays_per_s` is the stricter closest-hit-only number;
    # `live_rays_per_s` counts only rays actually traced (dead d == 0
    # wavefront slots excluded — the honest multi-bounce number).
    rays_per_frame = primary_rays * cfg.max_bounces * (1 + scene.lights.count)
    return {
        "config": cfg,
        "ms_per_frame": dt * 1e3,
        "fps": 1.0 / dt,
        "rays_per_s": rays_per_frame / dt,
        "primary_rays_per_s": primary_rays * cfg.max_bounces / dt,
        "live_rays_per_s": None if live_rays is None else live_rays / dt,
        "num_tris": scene.num_tris,
        "overflow": overflow,
        "image": np.asarray(img),
    }


def benchmark_grad_step(config: str | RenderConfig | None = "bunny-grad",
                        iters: int = 5, warmup: int = 1,
                        params: tuple = ("verts",), tiled: str = "auto",
                        **overrides) -> dict:
    """Timed optimization steps (loss+grad+update) -> grad_step_ms.

    BASELINE.md requires grad-step time measured and reported per config.
    `params` selects the optimized leaves: any of "verts", "albedo",
    "cam_pos" (BASELINE config 3 optimizes all three families).
    `tiled="auto"` uses the tiled path when the config supports it (see
    make_grad_step_fn); `"off"` forces the jnp tier.
    """
    import optax

    cfg = config if isinstance(config, RenderConfig) else load_config(config, **overrides)
    scene, camera = get_scene(cfg)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    optimizer = optax.adam(1e-3)
    p = {}
    if "verts" in params:
        p["verts"] = scene.verts
    if "albedo" in params:
        p["albedo"] = jnp.asarray(scene.materials.albedo)
    if "cam_pos" in params:
        p["cam_pos"] = jnp.asarray(camera.position)
    params = p
    opt_state = optimizer.init(params)
    step = make_grad_step_fn(cfg, optimizer, scene=scene, camera=camera,
                             tiled=tiled)
    aux = None
    for _ in range(max(warmup, 1)):
        loss, params, opt_state, aux = step(scene, camera, target, params,
                                            opt_state)
        jax.block_until_ready(loss)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, params, opt_state, aux = step(scene, camera, target, params,
                                            opt_state)
    jax.block_until_ready(loss)
    dt = (time.perf_counter() - t0) / iters
    return {"grad_step_ms": dt * 1e3, "loss": float(loss),
            "overflow": int(aux["overflow"]), "config": cfg}
