"""Device mesh setup (SURVEY.md T9).

Reference parity: the reference is single-GPU with no distribution; all
multi-device capability is new scope. The mesh is 2D
('data', 'geom'): tiles/rays are sharded over 'data' (T10) and scene
geometry over 'geom' for the ring pass (T11). Multi-host bootstrap uses
jax.distributed.initialize (T9/E in SURVEY.md §3.2).
"""
from __future__ import annotations

import jax
import numpy as np

DATA_AXIS = "data"
GEOM_AXIS = "geom"


def make_render_mesh(devices=None, data: int | None = None, geom: int = 1) -> jax.sharding.Mesh:
    """Create the render mesh. Defaults: all devices on the data axis.

    data * geom must equal the device count used.
    """
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    n = devices.size
    if data is None:
        data = n // geom
    if data * geom != n:
        raise ValueError(f"data({data}) * geom({geom}) != devices({n})")
    return jax.sharding.Mesh(devices.reshape(data, geom), (DATA_AXIS, GEOM_AXIS))


def init_multihost(coordinator: str, num_processes: int, process_id: int) -> None:
    """Multi-host process-group bootstrap (one python process per host).

    XLA lowers the collectives to NCCL: over NVLink between the cards of
    a host (all to all, so the mesh shape follows the algorithm alone) and
    over the network between hosts (SURVEY.md T13, §5).
    """
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
