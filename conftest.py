"""Repo-root pytest conftest.

Forces JAX onto a virtual 8-device CPU platform BEFORE jax is imported, so
the full test suite — including the shard_map distribution tests — runs
anywhere (SURVEY.md §4 "Distributed tests without a cluster"). Also puts the
repo root on sys.path so `import tracer` works without installation.

TRACER_TEST_GPU=1 leaves JAX on its default platform instead, for the
`gpu`-marked tests on a machine with a card:
    TRACER_TEST_GPU=1 python -m pytest -m gpu tests/gpu
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

if os.environ.get("TRACER_TEST_GPU") != "1":
    # Tests must not depend on — or hold — a real accelerator.
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")
