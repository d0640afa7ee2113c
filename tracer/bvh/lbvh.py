"""Karras-style LBVH: fully on-device build + flattened SoA node array.

Reference parity: the OpenCL reference builds its BVH on the CPU at scene
load and flattens it to an int-indexed node array for the kernel to traverse
(SURVEY.md R3/R5; BASELINE capability "BVH-accelerated ray-triangle
intersection" and "flattened LBVH"). This redesign builds the tree
*on device inside jit* so geometry edits (the differentiable path) never
bounce through the host:

  1. triangle AABBs -> 30-bit morton codes of centroids (bvh.morton);
  2. `jnp.argsort` (lax.sort radix under XLA) orders the leaves;
  3. Karras 2012 internal-node topology — each of the N-1 internal nodes
     finds its key range / split with O(log N) fixed-trip-count searches,
     all N-1 nodes in parallel as dense vector ops (no recursion);
  4. bottom-up AABB fit as a fixed-depth gather loop (atomic-free).

This is the classic per-ray BVH tier: `trace_rays_lbvh` does batched
stack-based traversal (dense masked lanes under `lax.while_loop`). The
high-throughput path remains the cluster accel + sorted walk
(bvh.cluster, kernels.walk); the LBVH tier exists for parity,
for gather-friendly backends, and as an independent correctness oracle.

Node indexing convention: one unified array of 2N-1 nodes — internal nodes
occupy [0, N-1), leaves occupy [N-1, 2N-2], leaf k (k-th in morton order)
sits at index (N-1)+k and references original triangle `leaf_tri[k]`.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tracer.bvh.morton import morton3d, quantize_positions
from tracer.core.types import Ray, Hit, T_FAR
from tracer.core.intersect import moller_trumbore

STACK_DEPTH = 64  # >= max radix-tree depth for 30-bit codes + index tiebreak


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FlatBVH:
    """Flattened LBVH, SoA, on-device.

    node_lo/node_hi: (2N-1, 3) AABBs for all nodes (internal then leaves)
    left/right:      (N-1,) int32 child node indices (unified indexing)
    leaf_tri:        (N,) int32 original triangle id per morton-ordered leaf
    """

    node_lo: jax.Array
    node_hi: jax.Array
    left: jax.Array
    right: jax.Array
    leaf_tri: jax.Array

    @property
    def num_leaves(self) -> int:
        return self.leaf_tri.shape[0]

    @property
    def num_internal(self) -> int:
        return self.left.shape[0]


def _clz32(x: jax.Array) -> jax.Array:
    return jax.lax.clz(x.astype(jnp.uint32)).astype(jnp.int32)


def _make_delta(codes: jax.Array, n: int):
    """delta(i, j): common-prefix length of keys i and j; -1 if j out of range.

    Duplicate morton codes are disambiguated by index (standard Karras trick:
    effective key = code ++ index, 62 bits, all distinct)."""

    idx32 = jnp.arange(n, dtype=jnp.uint32)

    def delta(i: jax.Array, j: jax.Array) -> jax.Array:
        valid = (j >= 0) & (j < n)
        jj = jnp.clip(j, 0, n - 1)
        x = codes[i] ^ codes[jj]
        tie = 32 + _clz32(idx32[i] ^ idx32[jj])
        d = jnp.where(x == 0, tie, _clz32(x))
        return jnp.where(valid, d, -1)

    return delta


def _karras_topology(codes: jax.Array):
    """Sorted morton codes (N,) -> (left, right) child arrays for the N-1
    internal nodes, unified node indexing (leaf k -> (N-1)+k)."""
    n = codes.shape[0]
    ni = n - 1
    delta = _make_delta(codes, n)
    i = jnp.arange(ni, dtype=jnp.int32)

    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    delta_min = delta(i, i - d)

    # Upper bound on range length by doubling (fixed 32 trips covers N < 2^31).
    lmax = jnp.full((ni,), 2, jnp.int32)
    for _ in range(32):
        grow = delta(i, i + lmax * d) > delta_min
        lmax = jnp.where(grow, lmax * 2, lmax)

    # Binary search for the exact other end j = i + l*d.
    l = jnp.zeros((ni,), jnp.int32)
    t = lmax // 2
    for _ in range(32):
        take = (t >= 1) & (delta(i, i + (l + t) * d) > delta_min)
        l = jnp.where(take, l + t, l)
        t = t // 2
    j = i + l * d

    # Binary search for the split position gamma in [min(i,j), max(i,j)).
    delta_node = delta(i, j)
    s = jnp.zeros((ni,), jnp.int32)
    t = l
    done = l == 0
    for _ in range(34):
        t = jnp.where(done, t, (t + 1) // 2)
        take = ~done & (delta(i, i + (s + t) * d) > delta_node)
        s = jnp.where(take, s + t, s)
        done = done | (t <= 1)
    gamma = i + s * d + jnp.minimum(d, 0)

    lo_ij = jnp.minimum(i, j)
    hi_ij = jnp.maximum(i, j)
    left = jnp.where(lo_ij == gamma, gamma + ni, gamma)
    right = jnp.where(hi_ij == gamma + 1, gamma + 1 + ni, gamma + 1)
    return left.astype(jnp.int32), right.astype(jnp.int32)


def build_lbvh(verts: jax.Array, tris: jax.Array) -> FlatBVH:
    """On-device LBVH build (jittable). AABBs/topology are discrete
    (stop-gradient); vertex gradients flow through per-leaf triangle
    intersection instead (tracer.diff)."""
    n = tris.shape[0]
    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]
    tri_lo = jax.lax.stop_gradient(jnp.minimum(jnp.minimum(v0, v1), v2))
    tri_hi = jax.lax.stop_gradient(jnp.maximum(jnp.maximum(v0, v1), v2))
    centroid = 0.5 * (tri_lo + tri_hi)
    scene_lo = jnp.min(centroid, axis=0)
    scene_hi = jnp.max(centroid, axis=0)
    codes = morton3d(quantize_positions(centroid, scene_lo, scene_hi))
    order = jnp.argsort(codes).astype(jnp.int32)
    codes = codes[order]

    if n == 1:
        # Degenerate: a single leaf, no internal nodes.
        return FlatBVH(
            node_lo=tri_lo, node_hi=tri_hi,
            left=jnp.zeros((0,), jnp.int32), right=jnp.zeros((0,), jnp.int32),
            leaf_tri=order,
        )

    left, right = _karras_topology(codes)
    ni = n - 1

    # Bottom-up AABB fit: leaves are exact; internal AABBs converge in at
    # most tree-depth (<= 62 for 30-bit+index keys) gather rounds.
    leaf_lo = tri_lo[order]
    leaf_hi = tri_hi[order]
    node_lo = jnp.concatenate([jnp.full((ni, 3), jnp.inf, jnp.float32), leaf_lo])
    node_hi = jnp.concatenate([jnp.full((ni, 3), -jnp.inf, jnp.float32), leaf_hi])

    rounds = min(STACK_DEPTH, max(2 * int(n).bit_length() + 2, 8))

    def fit(_, lohi):
        lo, hi = lohi
        new_lo = jnp.minimum(lo[left], lo[right])
        new_hi = jnp.maximum(hi[left], hi[right])
        return (
            lo.at[:ni].set(new_lo),
            hi.at[:ni].set(new_hi),
        )

    node_lo, node_hi = jax.lax.fori_loop(0, rounds, fit, (node_lo, node_hi))
    return FlatBVH(node_lo=node_lo, node_hi=node_hi, left=left, right=right,
                   leaf_tri=order)


def _slab_test(o, inv_d, lo, hi, t_min, t_max):
    """Ray vs AABB slab test. o, inv_d: (..., 3); lo, hi broadcastable.
    Returns (hit, t_enter)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    enter = jnp.maximum(tn, t_min)
    exit_ = jnp.minimum(tf, t_max)
    return enter <= exit_, enter


def _traverse(o, dvec, t_min, t_max0, bvh: FlatBVH, verts, tris, any_hit: bool):
    """Shared batched stack traversal core. o, dvec: (R, 3) flat rays.

    Returns (t, tri, u, v, occluded). For any_hit mode only `occluded` is
    meaningful and lanes stop at the first confirmed hit."""
    r = o.shape[0]
    n = bvh.num_leaves
    ni = bvh.num_internal
    inv_d = 1.0 / jnp.where(jnp.abs(dvec) > 1e-20, dvec, 1e-20)

    if isinstance(t_max0, jax.Array) and t_max0.ndim > 0:
        t_max0 = t_max0.reshape(r)
    else:
        t_max0 = jnp.full((r,), t_max0, jnp.float32)

    root = jnp.int32(ni if ni == 0 else 0)  # single-leaf BVH: root is the leaf

    state = dict(
        node=jnp.full((r,), root, jnp.int32),
        stack=jnp.zeros((r, STACK_DEPTH), jnp.int32),
        sp=jnp.zeros((r,), jnp.int32),
        best_t=t_max0.astype(jnp.float32),
        best_tri=jnp.full((r,), -1, jnp.int32),
        best_u=jnp.zeros((r,), jnp.float32),
        best_v=jnp.zeros((r,), jnp.float32),
        active=jnp.any(dvec != 0.0, axis=-1),
        occ=jnp.zeros((r,), bool),
    )

    def cond(st):
        return jnp.any(st["active"])

    def body(st):
        node = st["node"]
        active = st["active"]
        is_leaf = node >= ni

        # --- Leaf lanes: single-triangle Moller-Trumbore. ---
        leaf_id = jnp.clip(node - ni, 0, n - 1)
        tid = bvh.leaf_tri[leaf_id]
        tv = tris[tid]
        t, u, v, hit = moller_trumbore(
            o, dvec, verts[tv[:, 0]], verts[tv[:, 1]], verts[tv[:, 2]],
            t_min=t_min, t_max=T_FAR,
        )
        # Strictly closer wins; equal-t ties go to the lower triangle id
        # (matches the brute-force argmin tie-break, so images agree).
        closer = (t < st["best_t"]) | (
            (t == st["best_t"]) & ((st["best_tri"] < 0) | (tid < st["best_tri"]))
        )
        hit = hit & is_leaf & active & closer
        best_t = jnp.where(hit, t, st["best_t"])
        best_tri = jnp.where(hit, tid, st["best_tri"])
        best_u = jnp.where(hit, u, st["best_u"])
        best_v = jnp.where(hit, v, st["best_v"])
        occ = st["occ"] | (hit if any_hit else jnp.zeros_like(hit))

        # --- Internal lanes: slab-test both children, near first. ---
        node_i = jnp.clip(node, 0, max(ni - 1, 0))
        lc = bvh.left[node_i] if ni else jnp.zeros_like(node)
        rc = bvh.right[node_i] if ni else jnp.zeros_like(node)
        hl, tl = _slab_test(o, inv_d, bvh.node_lo[lc], bvh.node_hi[lc], t_min, best_t)
        hr, tr_ = _slab_test(o, inv_d, bvh.node_lo[rc], bvh.node_hi[rc], t_min, best_t)
        swap = hr & (~hl | (tr_ < tl))
        near = jnp.where(swap, rc, lc)
        far = jnp.where(swap, lc, rc)
        nhit = hl | hr
        both = hl & hr

        # Push far child where both children hit.
        push = active & ~is_leaf & both
        sp = st["sp"]
        stack = st["stack"].at[jnp.arange(r), jnp.clip(sp, 0, STACK_DEPTH - 1)].set(
            jnp.where(push, far, st["stack"][jnp.arange(r), jnp.clip(sp, 0, STACK_DEPTH - 1)])
        )
        sp = jnp.where(push, sp + 1, sp)

        descend = active & ~is_leaf & nhit
        # Lanes that must pop: leaf lanes, or internal lanes with no child hit.
        need_pop = active & ~descend
        done_lane = occ if any_hit else jnp.zeros_like(active)
        can_pop = need_pop & (sp > 0) & ~done_lane
        sp_pop = jnp.where(can_pop, sp - 1, sp)
        popped = st["stack"][jnp.arange(r), jnp.clip(sp_pop, 0, STACK_DEPTH - 1)]

        new_node = jnp.where(descend, near, jnp.where(can_pop, popped, node))
        new_active = jnp.where(need_pop & ~can_pop, False, active)

        return dict(
            node=new_node, stack=stack, sp=sp_pop,
            best_t=best_t, best_tri=best_tri, best_u=best_u, best_v=best_v,
            active=new_active, occ=occ,
        )

    st = jax.lax.while_loop(cond, body, state)
    return st["best_t"], st["best_tri"], st["best_u"], st["best_v"], st["occ"]


def trace_rays_lbvh(ray: Ray, bvh: FlatBVH, verts, tris, t_min: float = 1e-4) -> Hit:
    """Closest-hit over the LBVH for an arbitrary-shape ray batch."""
    batch_shape = ray.batch_shape
    o = ray.o.reshape(-1, 3)
    d = ray.d.reshape(-1, 3)
    t, tri, u, v, _ = _traverse(o, d, t_min, T_FAR, bvh, verts, tris, any_hit=False)
    t = jnp.where(tri >= 0, t, T_FAR)
    uv = jnp.where((tri >= 0)[:, None], jnp.stack([u, v], axis=-1), 0.0)
    return Hit(
        t=t.reshape(batch_shape),
        tri=tri.reshape(batch_shape),
        uv=uv.reshape(batch_shape + (2,)),
    )


def any_hit_lbvh(ray: Ray, t_max, bvh: FlatBVH, verts, tris, t_min: float = 1e-4) -> jax.Array:
    """Occlusion test over the LBVH; t_max scalar or per-ray."""
    batch_shape = ray.batch_shape
    o = ray.o.reshape(-1, 3)
    d = ray.d.reshape(-1, 3)
    if isinstance(t_max, jax.Array) and t_max.ndim > 0:
        t_max = t_max.reshape(-1)
    _, _, _, _, occ = _traverse(o, d, t_min, t_max, bvh, verts, tris, any_hit=True)
    return occ.reshape(batch_shape)


def make_lbvh_tracers(scene, t_min: float = 1e-4):
    """(trace_fn, occlude_fn) over a freshly built LBVH — drop-in for the
    render_wavefront tracer interface (render.whitted)."""
    bvh = build_lbvh(scene.verts, scene.tris)

    def trace_fn(ray: Ray) -> Hit:
        return trace_rays_lbvh(ray, bvh, scene.verts, scene.tris, t_min)

    def occlude_fn(ray: Ray, t_max) -> jax.Array:
        return any_hit_lbvh(ray, t_max, bvh, scene.verts, scene.tris, t_min)

    return trace_fn, occlude_fn
