"""The sorted walk (kernels.walk): its Pallas kernel in interpret mode
against the plain XLA walk and the jnp scan reference, the walk choice by
platform, and the early-out bound."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.bvh.cluster import build_clusters
from tracer.bvh.cull import cull_clusters, cull_clusters_sorted2, pack_candidates
from tracer.core.camera import Camera, generate_rays
from tracer.core.types import T_FAR
from tracer.kernels import walk
from tracer.kernels.traversal import (
    T_MIN, any_hit_tiles_jnp, tile_rays, trace_tiles_jnp)
from tracer.scene.procedural import bunny_scene, random_tri_soup


def _bunny_rays():
    scene, cam = bunny_scene(subdiv=3)
    cam = Camera.make(**cam)
    rays = generate_rays(cam, 48, 40)  # 1920 rays: 30 tiles of 64
    return scene, rays.o, rays.d, cam.position


def _soup_rays():
    scene = random_tri_soup(400, seed=3)
    origin = jnp.asarray([0.0, 0.0, 3.0], jnp.float32)
    rng = np.random.default_rng(4)
    d = rng.normal(size=(1000, 3)).astype(np.float32)  # not a tile multiple
    d[:, 2] -= 2.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:37] = 0.0  # d == 0 padding rays mixed into real tiles
    o = np.broadcast_to(np.asarray(origin), d.shape)
    return scene, jnp.asarray(o), jnp.asarray(d), origin


SCENES = {"bunny": _bunny_rays, "soup": _soup_rays}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    scene, o, d, origin = SCENES[request.param]()
    accel = build_clusters(scene.verts, scene.tris, cluster_size=32)
    o_t, d_t, _ = tile_rays(o, d, 64)
    return request.param, accel, o_t, d_t, origin


def _sorted_words(accel, o_t, d_t, t_max):
    words, counts, excess, _ = cull_clusters_sorted2(
        accel, o_t, d_t, t_max, accel.num_clusters,
        accel.super_lo.shape[0])
    assert int(excess) == 0
    return words, counts


@pytest.mark.parametrize("shared", [False, True], ids=["per-ray", "shared"])
def test_closest_kernel_matches_reference(case, shared):
    name, accel, o_t, d_t, origin = case
    words, counts = _sorted_words(accel, o_t, d_t, T_FAR)
    org = origin if shared else None
    bt_k, gid_k = walk._closest_pallas(o_t, d_t, accel.tri_w, words, counts,
                                       org, T_MIN, True)
    bt_r, gid_r = walk._closest_reference(o_t, d_t, accel.tri_w, words,
                                          counts, org, T_MIN)
    np.testing.assert_array_equal(np.asarray(gid_k), np.asarray(gid_r))
    np.testing.assert_array_equal(np.asarray(bt_k), np.asarray(bt_r))
    hits = np.asarray(gid_k) >= 0
    assert 0.05 < hits.mean() < 1.0, f"{name}: degenerate fixture"

    # Against the jnp scan over ALL culled clusters (no sort, no early
    # exit): same hits, same t, same triangle up to exact fp32 ties.
    cand, cnt, exc = cull_clusters(accel, o_t, d_t, T_FAR,
                                   accel.num_clusters)
    assert int(exc) == 0
    t_j, tri_j, _, _ = trace_tiles_jnp(o_t, d_t, accel, cand, cnt)
    t_j, tri_j = np.asarray(t_j), np.asarray(tri_j)
    np.testing.assert_array_equal(hits, tri_j >= 0)
    np.testing.assert_allclose(np.asarray(bt_k)[hits], t_j[hits], rtol=1e-6)
    tri_k = np.asarray(accel.tri_ids).reshape(-1)[np.maximum(np.asarray(gid_k), 0)]
    diff = hits & (tri_k != tri_j)
    # A differing triangle is only allowed at a tie (shared edge).
    assert diff.sum() <= max(2, int(0.002 * hits.sum())), diff.sum()


@pytest.mark.parametrize("shared", [False, True], ids=["per-ray", "shared"])
def test_anyhit_kernel_matches_reference(case, shared):
    name, accel, o_t, d_t, origin = case
    rng = np.random.default_rng(0)
    t_max = jnp.asarray(rng.uniform(0.5, 4.0, o_t.shape[:2]).astype(np.float32))
    words, counts = _sorted_words(accel, o_t, d_t, t_max)
    org = origin if shared else None
    occ_k = walk.occlude_walk(o_t, d_t, t_max, accel, words, counts,
                              origin=org, interpret=True)
    live = jnp.any(d_t != 0.0, axis=-1)
    occ_r = walk._anyhit_reference(o_t, d_t, jnp.where(live, t_max, 0.0),
                                   accel.tri_w, words, counts, org, T_MIN)
    np.testing.assert_array_equal(np.asarray(occ_k), np.asarray(occ_r))
    cand, cnt, _ = cull_clusters(accel, o_t, d_t, t_max, accel.num_clusters)
    occ_j = any_hit_tiles_jnp(o_t, d_t, t_max, accel, cand, cnt)
    np.testing.assert_array_equal(np.asarray(occ_k), np.asarray(occ_j))
    assert 0.0 < float(np.asarray(occ_k).mean()) < 1.0


@pytest.mark.parametrize("kind", ["closest", "anyhit"])
def test_empty_and_dead_tiles(kind):
    """Tiles with no candidates (count 0) and tiles of d == 0 rays only
    return misses, next to a tile that does hit."""
    scene = random_tri_soup(200, seed=1)
    accel = build_clusters(scene.verts, scene.tris, cluster_size=32)
    o = np.zeros((3, 64, 3), np.float32)
    o[..., 2] = 3.0
    d = np.zeros((3, 64, 3), np.float32)
    d[0, :, 2] = -1.0                      # tile 0: into the soup
    d[1, :, 2] = 1.0                       # tile 1: away from everything
    o_t, d_t = jnp.asarray(o), jnp.asarray(d)  # tile 2: all d == 0
    tm = jnp.full((3, 64), 10.0, jnp.float32)
    words, counts = _sorted_words(accel, o_t, d_t, tm)
    assert int(counts[0]) > 0 and int(counts[1]) == 0 and int(counts[2]) == 0
    for interpret in (True, False):
        if kind == "closest":
            bt, gid = walk.trace_walk(o_t, d_t, accel, words, counts,
                                      interpret=interpret)
            gid = np.asarray(gid)
            assert (gid[0] >= 0).any()
            assert (gid[1:] == -1).all() and (np.asarray(bt)[1:] == T_FAR).all()
        else:
            occ = np.asarray(walk.occlude_walk(o_t, d_t, tm, accel, words,
                                               counts, interpret=interpret))
            assert occ[0].any() and not occ[1:].any()


def _two_quads():
    """Quad A at z = 1 and quad B at z = 0.5 in front of it, as seen from the
    origin along +z; cluster_size 2 puts each quad in its own cluster."""
    quad = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    verts = np.concatenate([quad + [0, 0, 1.0], quad + [0, 0, 0.5]])
    tris = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    accel = build_clusters(jnp.asarray(verts), jnp.asarray(tris), cluster_size=2)
    ids = np.asarray(accel.tri_ids)
    a = int(np.flatnonzero((ids == 0).any(axis=1))[0])
    b = int(np.flatnonzero((ids == 2).any(axis=1))[0])
    assert a != b and sorted(ids[a].tolist()) == [0, 1]
    rng = np.random.default_rng(2)
    xy = rng.uniform(-0.2, 0.2, (1, 64, 2)).astype(np.float32)
    d = np.concatenate([xy, np.ones((1, 64, 1), np.float32)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return accel, jnp.zeros((1, 64, 3)), jnp.asarray(d), a, b


@pytest.mark.parametrize("interpret", [True, False], ids=["kernel", "reference"])
@pytest.mark.parametrize("kind", ["closest", "anyhit"])
def test_early_out_stops_the_walk(kind, interpret):
    """A candidate whose entry distance exceeds the bound is never
    intersected. The fixture gives quad B (really at t = 0.5) a false entry
    distance of 5: visiting it would change the answer, so the answer
    proves the walk stopped."""
    accel, o_t, d_t, a, b = _two_quads()
    if kind == "closest":
        # A (entry 0.9, hit at t ~ 1) sets the bound ~1 < 5: stop before B.
        words = pack_candidates(jnp.asarray([[0.9, 5.0]]),
                                jnp.asarray([[a, b]], jnp.int32),
                                jnp.ones((1, 2), bool))
        bt, gid = walk.trace_walk(o_t, d_t, accel, words,
                                  jnp.asarray([2], jnp.int32),
                                  interpret=interpret)
        gid = np.asarray(gid)
        assert (gid // 2 == a).all(), gid
        assert np.all(np.asarray(bt) > 0.9)
    else:
        # Every ray's t_max is 2 < B's false entry 5: B is never visited.
        words = pack_candidates(jnp.asarray([[5.0]]),
                                jnp.asarray([[b]], jnp.int32),
                                jnp.ones((1, 1), bool))
        tm = jnp.full((1, 64), 2.0, jnp.float32)
        occ = walk.occlude_walk(o_t, d_t, tm, accel, words,
                                jnp.asarray([1], jnp.int32),
                                interpret=interpret)
        assert not np.asarray(occ).any()
        # With an honest entry distance B occludes every ray.
        words = pack_candidates(jnp.asarray([[0.4]]),
                                jnp.asarray([[b]], jnp.int32),
                                jnp.ones((1, 1), bool))
        occ = walk.occlude_walk(o_t, d_t, tm, accel, words,
                                jnp.asarray([1], jnp.int32),
                                interpret=interpret)
        assert np.asarray(occ).all()


@pytest.mark.parametrize("platform,want", [
    ("gpu", "triton"), ("cpu", "reference"),
    ("rocm", None), ("neuron", None), ("METAL", None)])
def test_walk_choice_by_platform(platform, want):
    """GPU -> the Triton kernel, CPU -> the plain walk, anything else
    raises; interpret mode only when the caller asks for it."""
    if want is None:
        with pytest.raises(NotImplementedError):
            walk.choose_walk(platform)
    else:
        assert walk.choose_walk(platform) == want
    assert walk.choose_walk(platform, interpret=True) == "interpret"


def test_cpu_walk_is_reference_not_interpret(monkeypatch):
    """On the CPU test platform the entry points take the plain walk unless
    interpret is asked for: the kernel path is never entered."""
    assert jax.default_backend() == "cpu"
    called = []
    monkeypatch.setattr(walk, "_closest_pallas",
                        lambda *a, **k: called.append(1))
    accel, o_t, d_t, a, b = _two_quads()
    words = pack_candidates(jnp.asarray([[0.9, 0.4]]),
                            jnp.asarray([[a, b]], jnp.int32),
                            jnp.ones((1, 2), bool))
    _, gid = walk.trace_walk(o_t, d_t, accel, words, jnp.asarray([2], jnp.int32))
    assert not called
    assert (np.asarray(gid) // 2 == b).all()


def test_render_tiled_reference_equals_kernel():
    """The whole tiled frame through the plain walk == through the kernel
    (interpret mode): primary, bounce and shadow passes."""
    from tracer.bvh import build_scene_accel
    from tracer.render.tiled import render_tiled
    from tracer.render.whitted import WhittedConfig

    scene, cam = bunny_scene(subdiv=2)
    cam = Camera.make(**cam)
    accel = build_scene_accel(scene)
    wcfg = WhittedConfig(max_bounces=2)
    img_r, aux_r = render_tiled(scene, accel, cam, 32, 32, wcfg,
                                with_aux=True, interpret=False)
    img_k, aux_k = render_tiled(scene, accel, cam, 32, 32, wcfg,
                                with_aux=True, interpret=True)
    assert int(aux_r["overflow"]) == int(aux_k["overflow"]) == 0
    np.testing.assert_array_equal(np.asarray(img_r), np.asarray(img_k))
    assert float(np.asarray(img_r).max()) > 0.01


@pytest.mark.parametrize("impl", ["triton", "reference"])
@pytest.mark.parametrize("kind", ["closest", "anyhit"])
def test_walk_types_outputs_under_shard_map(monkeypatch, kind, impl):
    """Inside a shard_map that keeps its varying-axes check, both walks
    return outputs typed as varying over the rays' mesh axis. The kernel is
    only traced here (it lowers on a GPU); the plain walk also runs and
    matches the unsharded answer."""
    from jax.sharding import PartitionSpec as P

    scene, o, d, _ = _bunny_rays()
    accel = build_clusters(scene.verts, scene.tris, cluster_size=32)
    o_t, d_t, _ = tile_rays(o, d, 64)
    o_t, d_t = o_t[:28], d_t[:28]  # 28 tiles: 7 per device
    words, counts = _sorted_words(accel, o_t, d_t, T_FAR)
    t_max = jnp.full(o_t.shape[:2], 3.0, jnp.float32)
    mesh = jax.make_mesh((4,), ("data",), devices=jax.devices()[:4])

    def run(o, d, w, c, tm):
        if kind == "closest":
            return walk.trace_walk(o, d, accel, w, c)
        return (walk.occlude_walk(o, d, tm, accel, w, c),)

    def body(*args):
        out = run(*args)
        for x in out:
            assert jax.typeof(x).vma == frozenset({"data"})
        return out

    args = (o_t, d_t, words, counts, t_max)
    want = run(*args)
    monkeypatch.setattr(walk, "choose_walk",
                        lambda platform, interpret=False: impl)
    sharded = jax.shard_map(body, mesh=mesh, in_specs=P("data"),
                            out_specs=P("data"))
    if impl == "triton":
        jax.make_jaxpr(sharded)(*args)
        return
    got = jax.jit(sharded)(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
