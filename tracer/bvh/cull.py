"""Tile-frustum vs cluster-AABB culling (conservative, branch-free).

The replacement for per-ray BVH descent at the top of the tree:
rays are grouped into coherent tiles; each tile is summarized by interval
bounds on origins and directions; a cluster survives culling iff SOME ray in
those intervals can hit its AABB within [0, t_max]. The test is interval
arithmetic on the slab test, hence conservative (never culls a cluster any
actual ray could hit — verified against brute force in tests).

For each axis k with origin interval [ol, oh], direction interval [dl, dh]
and slab [bl, bh], the feasible-t set is defined by
    ol + t*dl <= bh   and   oh + t*dh >= bl
each linear in t, giving interval bounds; the tile's feasible set is the
intersection over axes intersected with [0, t_max]; nonempty => candidate.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from tracer.core.types import T_FAR

_EPS = 1e-12


def _upper_lower(a, b, c, ge: bool):
    """Bounds on t from constraint a + t*b (<= or >=) c with interval-free
    scalars a, b, c (already broadcast). Returns (lo, hi, ok)."""
    pos = b > _EPS
    neg = b < -_EPS
    r = (c - a) / jnp.where(jnp.abs(b) > _EPS, b, 1.0)
    if ge:  # a + t*b >= c
        lo = jnp.where(pos, r, 0.0)
        hi = jnp.where(neg, r, T_FAR)
        ok = pos | neg | (a >= c)
    else:  # a + t*b <= c
        lo = jnp.where(neg, r, 0.0)
        hi = jnp.where(pos, r, T_FAR)
        ok = pos | neg | (a <= c)
    return lo, hi, ok


def frustum_aabb_feasible(o_lo, o_hi, d_lo, d_hi, box_lo, box_hi, t_max) -> jax.Array:
    """(..., 3) tile interval bounds vs (..., 3) AABBs -> (...) bool.

    All arguments broadcast; typical shapes (Ntiles, 1, 3) vs (1, Ncl, 3).
    """
    t_lo = jnp.zeros(jnp.broadcast_shapes(o_lo[..., 0].shape, box_lo[..., 0].shape))
    t_hi = jnp.broadcast_to(t_max, t_lo.shape)
    ok = jnp.ones(t_lo.shape, bool)
    for k in range(3):
        lo1, hi1, ok1 = _upper_lower(o_lo[..., k], d_lo[..., k], box_hi[..., k], ge=False)
        lo2, hi2, ok2 = _upper_lower(o_hi[..., k], d_hi[..., k], box_lo[..., k], ge=True)
        t_lo = jnp.maximum(t_lo, jnp.maximum(lo1, lo2))
        t_hi = jnp.minimum(t_hi, jnp.minimum(hi1, hi2))
        ok = ok & ok1 & ok2
    return ok & (t_lo <= t_hi)


def tile_bounds(o: jax.Array, d: jax.Array):
    """(Ntiles, TR, 3) ray SoA -> per-tile interval bounds (Ntiles, 3) x4.

    Rays with d == 0 (padding) are ignored via +-inf neutral elements guarded
    by a validity mask derived from |d| > 0.
    """
    valid = jnp.any(d != 0.0, axis=-1, keepdims=True)  # (Ntiles, TR, 1)
    big = jnp.float32(T_FAR)
    o_lo = jnp.min(jnp.where(valid, o, big), axis=1)
    o_hi = jnp.max(jnp.where(valid, o, -big), axis=1)
    d_lo = jnp.min(jnp.where(valid, d, big), axis=1)
    d_hi = jnp.max(jnp.where(valid, d, -big), axis=1)
    # Tiles with no valid rays: collapse to a STRUCTURALLY infeasible
    # frustum. o_lo = +T_FAR / o_hi = -T_FAR with d == 0 fails the
    # `o_hi + t*d_hi >= box_lo` constraint for every box with a finite lo
    # (and the <= constraint for every finite hi), so all-dead tiles can
    # never produce candidates — the previous [1,0] sentinel still passed
    # for boxes straddling [0, 1] and inflated bounce-pass sizing.
    any_valid = jnp.any(valid[..., 0], axis=1, keepdims=True)
    o_lo = jnp.where(any_valid, o_lo, big)
    o_hi = jnp.where(any_valid, o_hi, -big)
    d_lo = jnp.where(any_valid, d_lo, 0.0)
    d_hi = jnp.where(any_valid, d_hi, 0.0)
    return o_lo, o_hi, d_lo, d_hi


def frustum_aabb_entry(o_lo, o_hi, d_lo, d_hi, box_lo, box_hi, t_max):
    """Like frustum_aabb_feasible but also returns the conservative entry
    distance t_lo (a lower bound on the t at which ANY ray in the tile's
    interval hull can first touch the AABB). Used for front-to-back candidate
    ordering + early termination (kernels.walk)."""
    t_lo = jnp.zeros(jnp.broadcast_shapes(o_lo[..., 0].shape, box_lo[..., 0].shape))
    t_hi = jnp.broadcast_to(t_max, t_lo.shape)
    ok = jnp.ones(t_lo.shape, bool)
    for k in range(3):
        lo1, hi1, ok1 = _upper_lower(o_lo[..., k], d_lo[..., k], box_hi[..., k], ge=False)
        lo2, hi2, ok2 = _upper_lower(o_hi[..., k], d_hi[..., k], box_lo[..., k], ge=True)
        t_lo = jnp.maximum(t_lo, jnp.maximum(lo1, lo2))
        t_hi = jnp.minimum(t_hi, jnp.minimum(hi1, hi2))
        ok = ok & ok1 & ok2
    return ok & (t_lo <= t_hi), t_lo


# Packed candidate words for the sorted-cull path: top 15 bits = quantized
# entry distance (IEEE-754 bits of the positive float, truncated — monotone
# and a conservative floor), low 17 bits = cluster id. Sorting the words
# ascending per tile therefore yields exact front-to-back candidate order
# with the early-out key embedded. 0x7FFFFFFF = invalid sentinel.
CLUSTER_BITS = 17
_CL_MASK = (1 << CLUSTER_BITS) - 1
WORD_INVALID = jnp.int32(0x7FFFFFFF)


def pack_candidates(t_lo: jax.Array, cluster: jax.Array, valid: jax.Array) -> jax.Array:
    tb = jax.lax.bitcast_convert_type(
        jnp.maximum(t_lo, 0.0).astype(jnp.float32), jnp.int32)
    q = jax.lax.shift_left(jax.lax.shift_right_logical(tb, CLUSTER_BITS), CLUSTER_BITS)
    return jnp.where(valid, q | cluster, WORD_INVALID)


def cull_clusters_sorted(accel, o: jax.Array, d: jax.Array, t_max, k_cap: int):
    """Front-to-back sorted cull: tiles vs cluster AABBs.

    Returns (words (Ntiles, k_cap) int32 packed (t_lo_q | cluster) sorted
    ascending, counts (Ntiles,) int32 clipped to k_cap, excess () int32 —
    the TOTAL number of candidates dropped by the k_cap truncation across
    all tiles; nonzero means geometry was silently skipped and callers must
    surface it (VERDICT r2 item 9)).
    """
    n_cl = accel.num_clusters
    o_lo, o_hi, d_lo, d_hi = tile_bounds(o, d)
    if isinstance(t_max, jax.Array) and t_max.ndim > 0:
        t_max_tile = jnp.max(t_max, axis=1)[:, None]
    else:
        t_max_tile = jnp.asarray(t_max)[None, None] if jnp.ndim(t_max) == 0 else t_max

    ok, t_lo = frustum_aabb_entry(
        o_lo[:, None], o_hi[:, None], d_lo[:, None], d_hi[:, None],
        accel.cluster_lo[None], accel.cluster_hi[None], t_max_tile,
    )  # (Ntiles, Ncl)
    counts = jnp.sum(ok, axis=1).astype(jnp.int32)
    cluster_ids = jnp.arange(n_cl, dtype=jnp.int32)[None, :]
    words = pack_candidates(t_lo, cluster_ids, ok)
    words = jnp.sort(words, axis=1)
    k = min(k_cap, n_cl)
    excess = jnp.sum(jnp.maximum(counts - k, 0))
    words = words[:, :k]
    if k < k_cap:
        pad = jnp.full((words.shape[0], k_cap - k), WORD_INVALID, jnp.int32)
        words = jnp.concatenate([words, pad], axis=1)
    return words, jnp.minimum(counts, k_cap), excess


def _tile_tmax(t_max):
    if isinstance(t_max, jax.Array) and t_max.ndim > 0:
        return jnp.max(t_max, axis=1)[:, None]
    return jnp.asarray(t_max)[None, None] if jnp.ndim(t_max) == 0 else t_max


def cull_clusters_sorted2(accel, o: jax.Array, d: jax.Array, t_max,
                          k_cap: int, s_cap: int = 16):
    """Two-stage front-to-back cull: superclusters first, then only the
    survivors' clusters. Contract of cull_clusters_sorted plus a fourth
    return `need = (need_k, need_s)`: the max over tiles of the UNCLIPPED
    cluster/supercluster candidate counts — what k_cap/s_cap would have to
    be for this pass to be exact. The API's cap sizing reads these.

    Why: the single-stage cull's per-tile sort is (Ntiles, Ncl) wide.
    Stage 1 tests/sorts the ~Ncl/16 superclusters, keeps the nearest
    `s_cap` per tile, and stage 2 re-tests only their s_cap*SUPER_FACTOR
    clusters, so the sort shrinks in width. The supercluster AABB contains
    its clusters' AABBs and the interval feasibility test is monotone in
    the box, so a cluster passes the dense test iff it passes both stages —
    the two-stage result is IDENTICAL to cull_clusters_sorted whenever no
    tile has more than s_cap feasible superclusters; dropped superclusters
    are counted into `excess` (>=1 cluster each), preserving the
    'excess == 0 means exact' contract.

    Stage 2 fetches the surviving superclusters' cluster boxes with a row
    gather of an exact f32 table (on the H100 it measured faster than a
    bf16 one-hot product, PERF.md, and needs no outward rounding).
    """
    from tracer.bvh.cluster import SUPER_FACTOR

    n_cl = accel.num_clusters
    n_sc = accel.super_lo.shape[0]
    F = SUPER_FACTOR
    if n_sc <= 1 or n_cl <= k_cap:
        # No truncation is possible here (k == n_cl, or a single
        # supercluster whose SUPER_FACTOR clusters all fit): excess is
        # structurally 0 and the needs are moot.
        words, counts, excess = cull_clusters_sorted(accel, o, d, t_max, k_cap)
        return words, counts, excess, (jnp.int32(0), jnp.int32(0))
    o_lo, o_hi, d_lo, d_hi = tile_bounds(o, d)
    n_tiles = o_lo.shape[0]
    t_max_tile = jnp.broadcast_to(_tile_tmax(t_max), (n_tiles, 1))

    # Stage 1: superclusters (Ntiles, Nsc) — small test, small sort.
    ok_s, t_s = frustum_aabb_entry(
        o_lo[:, None], o_hi[:, None], d_lo[:, None], d_hi[:, None],
        accel.super_lo[None], accel.super_hi[None], t_max_tile)
    sup_counts = jnp.sum(ok_s, axis=1).astype(jnp.int32)
    sc_ids = jnp.arange(n_sc, dtype=jnp.int32)[None, :]
    words_s1 = jnp.sort(pack_candidates(t_s, sc_ids, ok_s), axis=1)

    # Per-supercluster table of its clusters' boxes, (Nsc, F*6). Padding
    # clusters (shorter last supercluster) get lo > hi finite sentinels:
    # infeasible by construction.
    big = jnp.float32(3e37)
    lo_t = jnp.concatenate(
        [accel.cluster_lo, jnp.full((n_sc * F - n_cl, 3), big)])
    hi_t = jnp.concatenate(
        [accel.cluster_hi, jnp.full((n_sc * F - n_cl, 3), -big)])
    table = jnp.concatenate([lo_t.reshape(n_sc, F, 3),
                             hi_t.reshape(n_sc, F, 3)], axis=-1)
    table = table.reshape(n_sc, F * 6)
    k = min(k_cap, n_cl)
    S = min(s_cap, n_sc)

    words_s = words_s1[:, :S]
    sid = jnp.minimum(words_s & _CL_MASK, n_sc - 1)
    slot_ok = (jnp.arange(S, dtype=jnp.int32)[None, :]
               < jnp.minimum(sup_counts, S)[:, None])
    # Each supercluster dropped past S hides >= 1 feasible cluster.
    sup_excess = jnp.sum(jnp.maximum(sup_counts - S, 0))
    fetched = table[sid].reshape(-1, S, F, 6)  # (Ntiles, S, F, 6)
    # Invalid slots: force lo > hi (a fetched box of a clamped id would
    # otherwise be feasible).
    box_lo = jnp.where(slot_ok[..., None, None], fetched[..., 0:3], big)
    box_hi = jnp.where(slot_ok[..., None, None], fetched[..., 3:6], -big)
    ok2, t2 = frustum_aabb_entry(
        o_lo[:, None, None], o_hi[:, None, None],
        d_lo[:, None, None], d_hi[:, None, None],
        box_lo, box_hi, t_max_tile[..., None])
    cl_ids = jnp.minimum(sid[..., None] * F
                         + jnp.arange(F, dtype=jnp.int32)[None, None, :],
                         n_cl - 1)
    ok2 = ok2.reshape(-1, S * F)
    words = pack_candidates(t2.reshape(-1, S * F),
                            cl_ids.reshape(-1, S * F), ok2)
    words = jnp.sort(words, axis=1)
    counts = jnp.sum(ok2, axis=1).astype(jnp.int32)
    words = words[:, :min(k, S * F)]
    if words.shape[1] < k_cap:
        pad = jnp.full((words.shape[0], k_cap - words.shape[1]),
                       WORD_INVALID, jnp.int32)
        words = jnp.concatenate([words, pad], axis=1)
    excess = jnp.sum(jnp.maximum(counts - k, 0)) + sup_excess
    # need_k is a lower bound when superclusters overflowed (the dropped
    # ones' clusters were never tested); the sizing loop iterates.
    need = (jnp.max(counts), jnp.max(sup_counts))
    return words, jnp.minimum(counts, k_cap), excess, need


def cull_clusters(accel, o: jax.Array, d: jax.Array, t_max, k_cap: int):
    """Hierarchical cull: tiles vs superclusters, then vs clusters.

    o, d: (Ntiles, TR, 3). t_max: scalar or (Ntiles, TR) per-ray upper bound.
    Returns (cand (Ntiles, k_cap) int32 candidate cluster ids — padded by
    repeating the last valid id for DMA elision —, counts (Ntiles,) int32,
    excess () int32 — the TOTAL number of candidates dropped by the k_cap
    truncation; nonzero means geometry was silently skipped and callers
    must surface it, same contract as cull_clusters_sorted).
    """
    n_cl = accel.num_clusters
    o_lo, o_hi, d_lo, d_hi = tile_bounds(o, d)
    if isinstance(t_max, jax.Array) and t_max.ndim > 0:
        t_max_tile = jnp.max(t_max, axis=1)[:, None]
    else:
        t_max_tile = jnp.asarray(t_max)[None, None] if jnp.ndim(t_max) == 0 else t_max

    # Supercluster level.
    sup = frustum_aabb_feasible(
        o_lo[:, None], o_hi[:, None], d_lo[:, None], d_hi[:, None],
        accel.super_lo[None], accel.super_hi[None], t_max_tile,
    )  # (Ntiles, Nsc)
    from tracer.bvh.cluster import SUPER_FACTOR

    sup_mask = jnp.repeat(sup, SUPER_FACTOR, axis=1)[:, :n_cl]

    # Cluster level (only meaningful where the supercluster survived).
    cl = frustum_aabb_feasible(
        o_lo[:, None], o_hi[:, None], d_lo[:, None], d_hi[:, None],
        accel.cluster_lo[None], accel.cluster_hi[None], t_max_tile,
    )
    mask = sup_mask & cl  # (Ntiles, Ncl)

    counts = jnp.sum(mask, axis=1).astype(jnp.int32)
    # Stable candidate ordering: argsort on (not-candidate, cluster-id).
    order = jnp.argsort(~mask, axis=1, stable=True).astype(jnp.int32)
    k = min(k_cap, n_cl)
    cand = order[:, :k]
    # Pad beyond count by repeating the last valid candidate (same-index DMA
    # on skipped kernel steps is elided by the pipeline).
    slot = jnp.arange(k, dtype=jnp.int32)[None, :]
    last_valid = jnp.maximum(counts - 1, 0)[:, None]
    cand = jnp.where(slot < jnp.maximum(counts, 1)[:, None], cand,
                     jnp.take_along_axis(cand, last_valid, axis=1))
    excess = jnp.sum(jnp.maximum(counts - k, 0))
    return cand, counts, excess
