"""Two-process jax.distributed smoke test (SURVEY.md §4 'Multi-host logic
... smoke-tested with jax.distributed in two local processes'; VERDICT r2
item 7). Each process owns 4 virtual CPU devices; the 8-device global mesh
renders a row-sharded Cornell image and every process checks its local
shards against the single-device reference (loose 5% pixel budget: at
32x32 a handful of edge-tie pixels flip across compilations)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.environ["TRACER_ROOT"])
pid = int(sys.argv[1])
# NOTE: initialize BEFORE importing tracer (tracer.core.types creates a jnp
# scalar at import, which would initialize the XLA backend too early).
jax.distributed.initialize(os.environ["COORD"], 2, pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
from tracer.dist.mesh import make_render_mesh

import numpy as np
from tracer.api import get_scene
from tracer.dist.ray_dp import make_sharded_render_fn
from tracer.render.whitted import WhittedConfig, render_image
from tracer.utils.config import load_config

CFG = load_config("cornell256", height=32, width=32)
scene, cam = get_scene(CFG)
mesh = make_render_mesh(jax.devices(), data=8, geom=1)
run = make_sharded_render_fn(scene, CFG, mesh)
img = run(scene, cam)
img.block_until_ready()

wcfg = WhittedConfig(max_bounces=CFG.max_bounces,
                     smooth_shading=CFG.smooth_shading)
ref = np.asarray(render_image(scene, cam, CFG.height, CFG.width, wcfg))
for shard in img.addressable_shards:
    got = np.asarray(shard.data)
    want = ref[shard.index]
    mism = np.mean(~np.isclose(got, want, rtol=1e-4, atol=1e-4))
    assert mism < 0.05, f"proc {pid} shard {shard.index}: {mism:.2%} differ"
    # Two-sided gate (VERDICT r4 weak #7): tiny 32x32 shards may flip a
    # few silhouette pixels across compilations, but the bulk of the
    # field must agree at fp32-rounding scale, so a broad numeric
    # regression can't hide inside the 5%% budget.
    err = np.abs(got - want).max(axis=-1)
    p90 = np.percentile(err, 90)
    assert p90 < 1e-5, f"proc {pid} shard {shard.index}: p90 err {p90:.2e}"
print(f"MULTIHOST_PASS {pid}", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_render(tmp_path):
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, COORD=coord, TRACER_ROOT=root,
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen([sys.executable, "-c", _CHILD, str(pid)], env=env,
                         cwd=root, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
        for pid in (0, 1)
    ]
    outs = []
    for pid, p in enumerate(procs):
        out, _ = p.communicate(timeout=540)
        outs.append(out.decode())
        assert p.returncode == 0, f"proc {pid} failed:\n{outs[-1][-3000:]}"
    for pid in (0, 1):
        assert f"MULTIHOST_PASS {pid}" in outs[pid]
