"""Cluster acceleration structure — the wavefront 'BVH leaf level'.

Reference parity: the reference builds a pointer-flattened BVH on the CPU and
traverses it per-ray with a divergent stack in the OpenCL kernel (SURVEY.md
R3/R5). Per-ray pointer chasing diverges across a wavefront of rays, so
this structure is different:

  * triangles are sorted by morton code of their AABB centroid (on-device,
    `jax.lax.sort`-backed argsort) and grouped into fixed-size clusters of
    C=128 — spatially coherent, contiguous in memory;
  * each cluster gets an AABB; a second level of supercluster AABBs (groups
    of 16) supports hierarchical culling;
  * per-cluster intersection data is precompiled into a (4, 3C) matrix so a
    whole ray-block x cluster test is two dense (TR,4)x(4,3C) products with a
    field-major layout (cols [0:C)=plane, [C:2C)=bary-u, [2C:3C)=bary-v),
    so each plane is a contiguous C-wide slice.

Traversal then is: cull cluster AABBs against coherent ray tiles (bvh.cull)
-> dense per-(tile, candidate-cluster) intersection (kernels.walk, and the
jnp tier in kernels.traversal).
The classic per-ray LBVH (Karras topology + stack traversal) also exists in
bvh.lbvh as the reference/mid-tier path.

The build is fully on-device and jittable; AABBs/ordering are integer/
discrete (stop-gradient), while the intersection matrices stay differentiable
w.r.t. vertex positions (tracer.diff).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tracer.bvh.morton import morton3d, quantize_positions
from tracer.core.intersect import triangle_affine_maps

CLUSTER_SIZE = 128
SUPER_FACTOR = 16


# Packed per-slot shading row layout (SHADE_COLS columns, fp32):
#   0:3  v0    3:6  e1     6:9  e2      (edges: MT uv/t recompute, flat normal)
#   9:12 n0   12:15 n1    15:18 n2      (vertex shading normals)
#  18:21 albedo   21:24 emission   24 mirror   25 valid(1/0)
#  26 specular (Phong ks)   27 shininess   28:32 pad
# Rows are in SORTED slot order (cluster*C + slot) so the traversal kernel's
# gid indexes the table directly with ONE wide gather — replacing the ~10
# narrow gathers (tris->verts->normals->materials) of the naive shading path,
# which dominated the frame at 1080p.
SHADE_COLS = 32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ClusterAccel:
    """Flattened two-level cluster acceleration structure (SoA, on-device).

    tri_w:       (Ncl, 4, 3C) per-cluster intersection matrices (field-major)
    tri_ids:     (Ncl, C) original triangle index per slot (-1 = padding)
    cluster_lo:  (Ncl, 3) cluster AABB minima
    cluster_hi:  (Ncl, 3)
    super_lo:    (Nsc, 3) supercluster AABB minima (groups of SUPER_FACTOR)
    super_hi:    (Nsc, 3)
    shade:       (Ncl*C, SHADE_COLS) packed shading rows (layout above)
    """

    tri_w: jax.Array
    tri_ids: jax.Array
    cluster_lo: jax.Array
    cluster_hi: jax.Array
    super_lo: jax.Array
    super_hi: jax.Array
    shade: jax.Array

    @property
    def num_clusters(self) -> int:
        return self.tri_w.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.tri_ids.shape[1]


def _pad_to(x: jax.Array, n: int, fill) -> jax.Array:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return jnp.concatenate(
        [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)], axis=0
    )


def build_clusters(verts: jax.Array, tris: jax.Array, cluster_size: int = CLUSTER_SIZE,
                   scene=None) -> ClusterAccel:
    """On-device cluster build: morton sort -> pad -> pack (jittable).

    Gradients w.r.t. verts flow through tri_w (via triangle_affine_maps) and
    through the packed shade table; the ordering and AABBs are discrete and
    stop-gradiented. `scene` (optional) supplies normals/materials for the
    shade rows; without it the rows carry geometry only.
    """
    C = cluster_size
    T = tris.shape[0]
    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]
    tri_lo = jnp.minimum(jnp.minimum(v0, v1), v2)
    tri_hi = jnp.maximum(jnp.maximum(v0, v1), v2)
    centroid = 0.5 * (tri_lo + tri_hi)
    centroid = jax.lax.stop_gradient(centroid)
    scene_lo = jnp.min(centroid, axis=0)
    scene_hi = jnp.max(centroid, axis=0)
    codes = morton3d(quantize_positions(centroid, scene_lo, scene_hi))
    order = jnp.argsort(codes).astype(jnp.int32)  # lax.sort under the hood

    n_cl = -(-T // C)
    n_pad = n_cl * C
    order_p = _pad_to(order, n_pad, 0)
    slot_valid = (jnp.arange(n_pad, dtype=jnp.int32) < T)

    maps = triangle_affine_maps(verts, tris)[order_p]  # (n_pad, 3, 4)
    # Zero maps for padding slots -> they can never report a hit.
    maps = jnp.where(slot_valid[:, None, None], maps, 0.0)
    tri_ids = jnp.where(slot_valid, order_p, -1).reshape(n_cl, C)

    # Field-major per-cluster matrices: (Ncl, C, 3, 4) -> rows stacked as
    # [n | au | av] along the column axis, then transposed to (4, 3C).
    mc = maps.reshape(n_cl, C, 3, 4)
    w = jnp.concatenate([mc[:, :, 0, :], mc[:, :, 1, :], mc[:, :, 2, :]], axis=1)
    tri_w = jnp.transpose(w, (0, 2, 1))  # (Ncl, 4, 3C)

    lo_p = jnp.where(slot_valid[:, None], tri_lo[order_p], jnp.inf).reshape(n_cl, C, 3)
    hi_p = jnp.where(slot_valid[:, None], tri_hi[order_p], -jnp.inf).reshape(n_cl, C, 3)
    cluster_lo = jax.lax.stop_gradient(jnp.min(lo_p, axis=1))
    cluster_hi = jax.lax.stop_gradient(jnp.max(hi_p, axis=1))

    n_sc = -(-n_cl // SUPER_FACTOR)
    sc_lo = _pad_to(cluster_lo, n_sc * SUPER_FACTOR, jnp.inf).reshape(n_sc, SUPER_FACTOR, 3)
    sc_hi = _pad_to(cluster_hi, n_sc * SUPER_FACTOR, -jnp.inf).reshape(n_sc, SUPER_FACTOR, 3)

    # Packed shade rows, sorted-slot order (see SHADE_COLS layout above).
    vm = jnp.where(slot_valid[:, None], 1.0, 0.0)
    tri_p = tris[order_p]  # (n_pad, 3)
    pv0 = verts[tri_p[:, 0]] * vm
    pe1 = (verts[tri_p[:, 1]] - verts[tri_p[:, 0]]) * vm
    pe2 = (verts[tri_p[:, 2]] - verts[tri_p[:, 0]]) * vm
    cols = [pv0, pe1, pe2]
    if scene is not None:
        n0 = scene.normals[tri_p[:, 0]] * vm
        n1 = scene.normals[tri_p[:, 1]] * vm
        n2 = scene.normals[tri_p[:, 2]] * vm
        mat = scene.mat_id[order_p]
        albedo = scene.materials.albedo[mat] * vm
        emission = scene.materials.emission[mat] * vm
        mirror = (scene.materials.mirror[mat])[:, None] * vm[:, 0:1]
        spec = (scene.materials.specular[mat])[:, None] * vm[:, 0:1]
        shin = (scene.materials.shininess[mat])[:, None] * vm[:, 0:1]
        cols += [n0, n1, n2, albedo, emission, mirror]
    else:
        spec = shin = jnp.zeros((n_pad, 1), verts.dtype)
        cols += [jnp.zeros((n_pad, 16), verts.dtype)]
    cols.append(vm[:, 0:1])  # valid flag (col 25)
    cols += [spec, shin]     # cols 26, 27
    shade = jnp.concatenate(cols, axis=1)
    shade = jnp.concatenate(
        [shade, jnp.zeros((n_pad, SHADE_COLS - shade.shape[1]), verts.dtype)], axis=1)

    return ClusterAccel(
        tri_w=tri_w,
        tri_ids=tri_ids,
        cluster_lo=cluster_lo,
        cluster_hi=cluster_hi,
        super_lo=jnp.min(sc_lo, axis=1),
        super_hi=jnp.max(sc_hi, axis=1),
        shade=shade,
    )


def build_scene_accel(scene, cluster_size: int = CLUSTER_SIZE) -> ClusterAccel:
    return build_clusters(scene.verts, scene.tris, cluster_size, scene=scene)
