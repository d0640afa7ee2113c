"""Scene representation: geometry + materials + lights, SoA pytrees.

Reference parity: the OpenCL reference's scene loader produces triangle
arrays, materials and lights uploaded as device buffers (SURVEY.md R7,
BASELINE capability "scene loading"). Here a Scene is a frozen pytree of
jnp arrays so the whole scene jit-traces, shards, and differentiates.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Lights:
    """Point lights: position (L,3), intensity (L,3) (RGB radiant power)."""

    position: jax.Array
    intensity: jax.Array

    @property
    def count(self) -> int:
        return self.position.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Materials:
    """Per-material SoA. Indexed by Scene.mat_id.

    albedo:    (M, 3) diffuse reflectance
    emission:  (M, 3) emitted radiance
    mirror:    (M,)   specular reflectivity in [0,1] (Whitted mirror bounce)
    specular:  (M,)   Phong specular coefficient ks (0 = pure Lambert)
    shininess: (M,)   Phong exponent (reference parity: SURVEY.md R4
                      reconstructs the reference shading as Lambert/Phong)
    """

    albedo: jax.Array
    emission: jax.Array
    mirror: jax.Array
    specular: jax.Array
    shininess: jax.Array

    @staticmethod
    def make(albedo, emission=None, mirror=None, specular=None,
             shininess=None) -> "Materials":
        albedo = jnp.asarray(albedo, jnp.float32)
        m = albedo.shape[0]
        return Materials(
            albedo=albedo,
            emission=jnp.zeros((m, 3), jnp.float32) if emission is None else jnp.asarray(emission, jnp.float32),
            mirror=jnp.zeros((m,), jnp.float32) if mirror is None else jnp.asarray(mirror, jnp.float32),
            specular=jnp.zeros((m,), jnp.float32) if specular is None else jnp.asarray(specular, jnp.float32),
            shininess=jnp.full((m,), 32.0, jnp.float32) if shininess is None else jnp.asarray(shininess, jnp.float32),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """verts (V,3) f32; tris (T,3) i32; mat_id (T,) i32; materials; lights.

    `normals` are per-vertex shading normals, (V,3); geometric normals are
    derived from winding when smooth shading is off.
    """

    verts: jax.Array
    tris: jax.Array
    mat_id: jax.Array
    materials: Materials
    lights: Lights
    normals: jax.Array

    @property
    def num_tris(self) -> int:
        return self.tris.shape[0]

    @staticmethod
    def make(verts, tris, mat_id, materials, lights, normals=None) -> "Scene":
        verts = jnp.asarray(verts, jnp.float32)
        tris = jnp.asarray(tris, jnp.int32)
        if normals is None:
            normals = compute_vertex_normals(np.asarray(verts), np.asarray(tris))
        return Scene(
            verts=verts,
            tris=tris,
            mat_id=jnp.asarray(mat_id, jnp.int32),
            materials=materials,
            lights=lights,
            normals=jnp.asarray(normals, jnp.float32),
        )


def compute_vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (host-side, at load time)."""
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted face normals
    out = np.zeros_like(verts)
    for k in range(3):
        np.add.at(out, tris[:, k], fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(norm, 1e-20)).astype(np.float32)


def compute_vertex_normals_jnp(verts: jax.Array, tris: jax.Array) -> jax.Array:
    """compute_vertex_normals as traceable, DIFFERENTIABLE jnp (same
    area-weighted formula; scatter-add via .at[].add). Used by the
    optimization paths so smooth-shading normals track moving vertices —
    with stale load-time normals, interior vertex motion is nearly
    invisible to the image loss and gradients vanish."""
    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]
    fn = jnp.cross(v1 - v0, v2 - v0)
    out = jnp.zeros_like(verts)
    for k in range(3):
        out = out.at[tris[:, k]].add(fn)
    norm = jnp.linalg.norm(out, axis=-1, keepdims=True)
    return out / jnp.maximum(norm, 1e-20)


def make_vertex_normal_fn(tris_np, n_verts: int):
    """Precompute a (V, D) face-incidence table from the STATIC topology
    and return a differentiable verts -> normals closure that assembles
    area-weighted vertex normals with one GATHER instead of a
    scatter-add, whose gradient is a scatter too. Padding slots index a zero face
    normal appended past the real faces."""
    tris_np = np.asarray(tris_np)
    n_faces = len(tris_np)
    # (vertex, face) incidence pairs, grouped by vertex via argsort — a
    # vertex can appear in the same corner column of many faces, so a
    # vectorized cursor update would collide; sorting sidesteps it.
    pair_v = tris_np.T.reshape(-1).astype(np.int64)
    pair_f = np.tile(np.arange(n_faces, dtype=np.int32), 3)
    order = np.argsort(pair_v, kind="stable")
    pair_v = pair_v[order]
    pair_f = pair_f[order]
    counts = np.bincount(pair_v, minlength=n_verts)
    D = max(1, int(counts.max()))
    inc = np.full((n_verts, D), n_faces, np.int32)  # pad -> zero row
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(pair_v)) - starts[pair_v]
    inc[pair_v, slot] = pair_f
    inc_dev = jnp.asarray(inc)
    tris_dev = jnp.asarray(tris_np.astype(np.int32))

    def normals_of(verts: jax.Array) -> jax.Array:
        v0 = verts[tris_dev[:, 0]]
        v1 = verts[tris_dev[:, 1]]
        v2 = verts[tris_dev[:, 2]]
        fn = jnp.cross(v1 - v0, v2 - v0)
        fn_pad = jnp.concatenate([fn, jnp.zeros((1, 3), fn.dtype)])
        acc = fn_pad[inc_dev].sum(axis=1)
        norm = jnp.linalg.norm(acc, axis=-1, keepdims=True)
        return acc / jnp.maximum(norm, 1e-20)

    return normals_of


def merge_meshes(parts):
    """Concatenate (verts, tris, mat_id) triples with index fix-up."""
    verts, tris, mats = [], [], []
    off = 0
    for v, t, m in parts:
        verts.append(v)
        tris.append(np.asarray(t) + off)
        mats.append(m)
        off += len(v)
    return (
        np.concatenate(verts, axis=0),
        np.concatenate(tris, axis=0),
        np.concatenate(mats, axis=0),
    )
