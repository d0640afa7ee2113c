from tracer.kernels.traversal import (
    make_accel_tracers,
    tile_rays,
    untile,
    trace_tiles_jnp,
    any_hit_tiles_jnp,
)

__all__ = [
    "make_accel_tracers",
    "tile_rays",
    "untile",
    "trace_tiles_jnp",
    "any_hit_tiles_jnp",
]
