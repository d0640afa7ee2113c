"""Ulysses-analog all-to-all ray re-sharding (SURVEY.md §5d, the optional
T11 variant): between bounces, re-shard the global ray wavefront across the
'data' axis by spatial (morton) locality with `jax.lax.all_to_all`.

Reference parity: none — the OpenCL reference is single-GPU (SURVEY.md
§2.1). This is the ray-tracing analog of Ulysses-style sequence
parallelism: where Ulysses all-to-alls attention heads against sequence
shards, here the "sequence" is the bounce wavefront and the exchange
re-buckets rays so each device traces a spatially coherent block — bounce
reflections scatter a band-sharded wavefront all over the scene, which
fattens every tile frustum the cull sees; after the exchange each device
holds one contiguous morton range of the global wavefront.

Mechanics (inside shard_map, axis size n, R local rays):
  1. sort local rays by 30-bit morton key of the position the caller picks
     (one multi-operand `lax.sort` carries the payload with the keys, no
     argsort + gather);
  2. split the sorted block into n equal contiguous chunks and exchange
     chunk j with device j (`lax.all_to_all`): device j ends up holding
     every device's j-th morton quantile — a coherent slice of the GLOBAL
     key range;
  3. compute per-ray results remotely, then run the inverse exchange +
     unsort (`restore`) to bring results back to their owning pixels.

The exchange is fixed-size (R/n rays to every peer) so shapes stay static;
balance comes from quantiles of the per-device key distribution being
similar, which is the same approximation Ulysses makes with heads.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tracer.dist.mesh import DATA_AXIS


def _morton_key(p: jax.Array, lo, hi) -> jax.Array:
    from tracer.bvh.morton import morton3d, quantize_positions

    return morton3d(quantize_positions(p, lo, hi))


def reshard_by_key(key: jax.Array, columns: list[jax.Array],
                   axis_name: str = DATA_AXIS):
    """Inside shard_map: re-shard `columns` (each (R,) f32/i32) across the
    axis by sorted `key` ((R,) uint32). Returns (resharded_columns,
    restore_fn) where restore_fn maps per-row result columns back to the
    caller's original row order (and owning device)."""
    n = jax.lax.axis_size(axis_name)
    r = key.shape[0]
    if r % n:
        raise ValueError(f"local rows {r} not divisible by axis size {n}")
    idx = jnp.arange(r, dtype=jnp.int32)
    # uint32 keys sort correctly as int32 only for the low 2^31 range;
    # morton30 fits in 30 bits so the bitcast below is order-preserving.
    key_i = jax.lax.bitcast_convert_type(key, jnp.int32)
    sorted_all = jax.lax.sort((key_i, idx, *columns), num_keys=1)
    idx_s = sorted_all[1]
    cols_s = sorted_all[2:]

    def exchange(x):
        return jax.lax.all_to_all(
            x.reshape(n, r // n, *x.shape[1:]), axis_name, 0, 0,
        ).reshape(r, *x.shape[1:])

    out = [exchange(c) for c in cols_s]

    def restore(result_columns):
        """Map per-row results of the resharded block back: inverse
        all_to_all (the exchange is an involution on the chunk grid),
        then unsort by the carried original index."""
        back = [exchange(c) for c in result_columns]
        idx_key = idx_s  # original row id of each local sorted row
        restored = jax.lax.sort((idx_key, *back), num_keys=1)
        return list(restored[1:])

    return out, restore


def reshard_rays_by_position(o, d, aux_columns, lo, hi,
                             axis_name: str = DATA_AXIS):
    """Convenience wrapper: re-shard rays (o, d (R, 3)) plus flat aux
    columns by morton key of `o` (clip-quantized to [lo, hi]). Dead rays
    (d == 0) key to the max bucket so they cluster on the last device.
    Returns (o2, d2, aux2, restore_fn)."""
    key = _morton_key(o, lo, hi)
    dead = jnp.all(d == 0.0, axis=-1)
    key = jnp.where(dead, jnp.uint32((1 << 30) - 1), key)
    cols = ([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]]
            + list(aux_columns))
    out, restore = reshard_by_key(key, cols, axis_name)
    o2 = jnp.stack(out[0:3], axis=-1)
    d2 = jnp.stack(out[3:6], axis=-1)
    return o2, d2, out[6:], restore
