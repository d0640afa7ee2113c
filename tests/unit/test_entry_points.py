"""Cache placement of the entry points and chip_smoke.py's failure contract
on a machine without a GPU."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from tracer.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _gitignored_dirs():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        return {line.strip().rstrip("/") for line in f
                if line.strip() and not line.startswith("#")}


@pytest.mark.parametrize("env_set", [True, False], ids=["env-set", "env-unset"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.compile_cache_dir() == str(tmp_path)
        assert cache.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; no other directory is set in code.
        assert jax.config.jax_compilation_cache_dir == before
        return
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.compile_cache_dir()
    assert path == os.path.join(ROOT, ".cache", "jax")
    assert os.path.relpath(path, ROOT).split(os.sep)[0] in _gitignored_dirs()
    try:
        assert cache.enable_compile_cache() == path
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_set", [True, False], ids=["env-set", "env-unset"])
def test_caps_cache_placement(monkeypatch, tmp_path, env_set):
    if env_set:
        monkeypatch.setenv("TRACER_CAPS_CACHE", str(tmp_path / "caps.json"))
        assert cache.caps_cache_path() == str(tmp_path / "caps.json")
    else:
        monkeypatch.delenv("TRACER_CAPS_CACHE", raising=False)
        path = cache.caps_cache_path()
        # Beside the default compile cache, inside the checkout, ignored.
        assert path == os.path.join(ROOT, ".cache", "tracer_caps.json")
        assert os.path.relpath(path, ROOT).split(os.sep)[0] in _gitignored_dirs()


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, lines


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """On the CPU (and in a directory holding only the script) the smoke
    run exits nonzero and its last line says ok: false — never a result."""
    if where == "repo":
        rc, lines = _run_smoke(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    else:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        rc, lines = _run_smoke(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert rc != 0
    assert lines, "no output"
    last = json.loads(lines[-1])
    assert last["ok"] is False
    assert not any('"ok": true' in line for line in lines)
