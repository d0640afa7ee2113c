"""Ulysses-analog all-to-all ray re-sharding (SURVEY.md §5d, optional T11
variant): exchange roundtrip identity, spatial-coherence improvement, and
the resharded-bounce render == the plain band-sharded render."""
import jax
import jax.numpy as jnp
import numpy as np

from tracer.api import get_scene
from tracer.dist.mesh import make_render_mesh, DATA_AXIS
from tracer.utils.config import load_config


def test_reshard_roundtrip_identity():
    """restore(reshard(x)) == x for every column, with arbitrary keys."""
    from jax.sharding import PartitionSpec as P

    from tracer.dist.ulysses import reshard_by_key

    n = 8
    mesh = make_render_mesh(jax.devices(), data=n, geom=1)
    rng = np.random.default_rng(0)
    rows = n * 16 * n  # global rows; R = rows/n per device, divisible by n
    key = rng.integers(0, 1 << 30, rows).astype(np.uint32)
    a = rng.normal(size=rows).astype(np.float32)
    b = rng.integers(0, 1000, rows).astype(np.int32)

    def body(key, a, b):
        (a2, b2), restore = reshard_by_key(key, [a, b], DATA_AXIS)
        # Remote compute: any per-row function.
        ra, rb = restore([a2 * 2.0, b2 + 7])
        return ra, rb

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(DATA_AXIS),) * 3,
        out_specs=(P(DATA_AXIS),) * 2))
    ra, rb = fn(jnp.asarray(key), jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(ra), a * 2.0, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(rb), b + 7)


def test_reshard_improves_locality():
    """After the exchange each device's key spread shrinks (the point of
    the re-shard: device j holds every device's j-th morton quantile)."""
    from jax.sharding import PartitionSpec as P

    from tracer.dist.ulysses import reshard_by_key

    n = 8
    mesh = make_render_mesh(jax.devices(), data=n, geom=1)
    rng = np.random.default_rng(1)
    rows = n * 64
    key = rng.integers(0, 1 << 30, rows).astype(np.uint32)

    def body(key):
        spread0 = (jnp.max(key) - jnp.min(key)).astype(jnp.float32)
        (k2,), _ = reshard_by_key(key, [key.astype(jnp.int32)], DATA_AXIS)
        k2 = k2.astype(jnp.uint32)
        spread1 = (jnp.max(k2) - jnp.min(k2)).astype(jnp.float32)
        return spread0[None], spread1[None]

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(DATA_AXIS),),
        out_specs=(P(DATA_AXIS),) * 2))
    s0, s1 = fn(jnp.asarray(key))
    # Uniform random keys: per-device spread ~ full range before, ~1/n of
    # it after (quantile slices). Require a 2x improvement on average.
    assert float(np.mean(s1)) < 0.5 * float(np.mean(s0)), (s0, s1)


def test_resharded_bounce_render_matches_plain():
    """reshard_bounces=True is exact: identical light transport, only the
    placement of bounce work moves across devices."""
    from tracer.dist.ray_dp import make_sharded_accel_render_fn

    cfg = load_config("bunny-grad", height=64, width=64, max_bounces=3)
    assert cfg.use_bvh
    scene, cam = get_scene(load_config("cornell256", height=64, width=64))
    mesh = make_render_mesh(jax.devices(), data=8, geom=1)
    plain = make_sharded_accel_render_fn(scene, cfg, mesh)
    resh = make_sharded_accel_render_fn(scene, cfg, mesh,
                                        reshard_bounces=True)
    img_p = np.asarray(plain(scene, cam))
    img_r = np.asarray(resh(scene, cam))
    from tracer.utils.metrics import dist_check

    # Exactness claim -> the tightest gate: 0.1% flip budget AND p98 at
    # fp32-rounding scale (two-sided, VERDICT r4 weak #7).
    dist_check(img_r, img_p, frac_tol=1e-3, p98_tol=1e-6,
               rtol=1e-5, atol=1e-6)
