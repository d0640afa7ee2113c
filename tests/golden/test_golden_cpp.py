"""Large golden tests against the C++ oracle (SURVEY.md §4, T8; VERDICT r2
item 3): bunny-with-shadows at 512x512 through the production tiled path
(plain walk on CPU), and a columned-hall crop at 256x256 through the walk's
Pallas kernel (interpret mode on CPU). Skipped gracefully if the C++ oracle can't build."""
import numpy as np
import pytest

from tracer.api import get_scene, make_render_fn
from tracer.refcpu import cpp as cpp_oracle
from tracer.utils.config import load_config

pytestmark = pytest.mark.skipif(
    not cpp_oracle.available(), reason="C++ oracle unavailable (g++ build)")


def _golden_check(img, ref, frac_tol=0.015, p98_tol=2e-3):
    assert np.isfinite(img).all()
    err = np.abs(img - ref).max(axis=-1)
    # Edge/silhouette pixels legitimately flip between fp32 (JAX path) and
    # fp64 (oracle); everywhere else agreement must be tight (BASELINE:
    # "image allclose rtol 1e-3" up to discrete hit reassignment).
    frac_bad = (err > 2e-3).mean()
    assert frac_bad < frac_tol, (
        f"{frac_bad:.2%} pixels off (max err {err.max():.4f})")
    assert np.percentile(err, 98) < p98_tol, f"p98 err {np.percentile(err, 98):.2e}"


def test_bunny512_with_shadows_matches_cpp_oracle():
    cfg = load_config("bunny512")  # 512x512, ~82k tris, BVH path
    scene, camera = get_scene(cfg)
    run = make_render_fn(scene, cfg)  # tiled path (plain walk on CPU)
    img = np.asarray(run(scene, camera))
    ref = cpp_oracle.cpp_render(scene, camera, cfg.height, cfg.width,
                                max_bounces=cfg.max_bounces,
                                smooth_shading=cfg.smooth_shading)
    # The bunny must cast a visible shadow for this golden to mean anything.
    assert img.max() > 0.05
    _golden_check(img, ref)


def test_hall256_pallas_interpret_matches_cpp_oracle():
    """Whole tiled pipeline (cull -> sorted closest walk -> light-origin
    shadow walk) with the walk's kernel in interpret mode vs the C++
    oracle."""
    from tracer.bvh import build_scene_accel
    from tracer.render.tiled import render_tiled
    from tracer.render.whitted import WhittedConfig
    from tracer.core.camera import Camera
    from tracer.scene.procedural import columned_hall

    # cols 4x3 keeps the canonical camera in a clear aisle (3x2 would put
    # it inside the center column).
    scene, cam = columned_hall(cols_x=4, cols_z=3, blob_subdiv=3)
    camera = Camera.make(**cam)
    H = W = 256
    wcfg = WhittedConfig(max_bounces=2, smooth_shading=True)
    accel = build_scene_accel(scene)
    img, aux = render_tiled(scene, accel, camera, H, W, wcfg,
                            interpret=True, with_aux=True)
    img = np.asarray(img)
    # Nonzero overflow would mean the k-caps silently truncated geometry —
    # goldens must fail on that, not mask it (VERDICT r2 item 9).
    assert int(aux["overflow"]) == 0, f"cull overflow {int(aux['overflow'])}"
    ref = cpp_oracle.cpp_render(scene, camera, H, W, max_bounces=2,
                                smooth_shading=True)
    assert img.max() > 0.05
    _golden_check(img, ref)


def test_sponza_class_1080p_crop_matches_cpp_oracle():
    """BASELINE config 4 golden: the REAL sponza1080 scene (columned hall,
    ~247k tris) with its 1080p camera frustum and multi-bounce shading —
    a 192-row band of the 1080p frame rendered through the cluster-accel
    tier vs the full-frame C++ oracle, compared on the crop."""
    import jax.numpy as jnp

    from tracer.api import get_scene, build_tracers
    from tracer.core.camera import generate_rays_band
    from tracer.render.whitted import WhittedConfig, render_wavefront

    from tracer.bvh import build_scene_accel
    from tracer.kernels.traversal import make_accel_tracers

    cfg = load_config("sponza1080")
    scene, camera = get_scene(cfg)
    assert scene.num_tris > 200_000  # "~260k tris" class (BASELINE.json:9)
    # Rows ~60% down the frame: the band with the lit column blobs (the
    # upper half of this camera's view is empty hall — a crop there would
    # golden-check nothing but sky/ambient).
    y0, hb = 640, 128
    rays = generate_rays_band(camera, cfg.height, cfg.width, y0, hb)
    wcfg = WhittedConfig(max_bounces=cfg.max_bounces,
                         smooth_shading=cfg.smooth_shading)
    # The default jnp tier is exact-but-O(Ncl) per tile (k_cap=None scans
    # all ~1930 clusters); a sized cap keeps this CPU golden tractable.
    # Candidate-cap overflow would print the work-list warning and show up
    # as image error against the oracle, so the cap is self-checking.
    accel = build_scene_accel(scene)
    trace_fn, occlude_fn = make_accel_tracers(scene, accel,
                                              k_cap=128)
    img = np.asarray(render_wavefront(scene, rays, wcfg, trace_fn, occlude_fn))
    ref = cpp_oracle.cpp_render(scene, camera, cfg.height, cfg.width,
                                max_bounces=cfg.max_bounces,
                                smooth_shading=cfg.smooth_shading)
    assert img.max() > 0.05
    # Each pixel carries up to 9 discrete visibility decisions here (3
    # bounces x (closest + 2 shadow rays)) vs the bunny golden's 2, so the
    # edge-tie flip budget scales: measured 1.55% flipped pixels even with
    # the cull fully uncapped (k=256 == k=128 to 0.05pp), while p98 error
    # is exactly 0 — agreement off edges is bit-tight.
    _golden_check(img, ref[y0:y0 + hb], frac_tol=0.025)
