"""Structured metrics + profiling hooks (SURVEY.md §5 'Tracing/profiling',
'Metrics/logging/observability').

Reference parity: the OpenCL reference's only observability is an FPS
counter in the window title (SURVEY.md §5); here every long-running loop
(fit, bench, animate) can emit one JSON line per step to a JSONL file —
host-0 only under multi-host SPMD — and any jitted region can be wrapped in
a jax.profiler trace (XProf/Perfetto) via `profile_trace`.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import jax
import numpy as np


def is_host0() -> bool:
    return jax.process_index() == 0


class MetricsLogger:
    """Append-only JSONL metrics writer; silent no-op off host 0.

    append=True keeps the existing file (resumed runs must not erase the
    earlier steps' history); the default truncates for one-file-per-run."""

    def __init__(self, path: str | None, host0_only: bool = True,
                 append: bool = False):
        self._path = path
        self._enabled = bool(path) and (not host0_only or is_host0())
        self._t0 = time.time()
        if self._enabled:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            if not append:
                # Truncate: one file per run.
                with open(path, "w"):
                    pass

    def log(self, **fields) -> None:
        if not self._enabled:
            return
        rec = {"t": round(time.time() - self._t0, 4), **fields}
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def profile_trace(enabled: bool, trace_dir: str | None = None):
    """jax.profiler.trace wrapper keyed on RenderConfig.profile.

    Writes an XProf trace (viewable in TensorBoard/Perfetto) to `trace_dir`
    (default $TRACER_PROFILE_DIR or <repo>/.cache/profile) when enabled.
    """
    if not enabled:
        yield None
        return
    from tracer.utils.cache import CACHE_DIR

    d = trace_dir or os.environ.get("TRACER_PROFILE_DIR",
                                    os.path.join(CACHE_DIR, "profile"))
    os.makedirs(d, exist_ok=True)
    with jax.profiler.trace(d):
        yield d
    print(f"[profile] jax.profiler trace written to {d}", flush=True)


def dist_check(img, ref, frac_tol=1e-2, p98_tol=1e-5, rtol=1e-4, atol=1e-4):
    """Two-sided image equality gate for a render path against its
    reference (distribution tiers, kernel vs plain walk): a flip budget
    alone would let a broad numeric regression hide inside it, so the
    non-edge field is also pinned by a percentile bound.

    img == ref up to (a) a small fraction of edge/tie pixels that may
    legitimately flip across different XLA compilations (fp32 nearest-hit
    ties at silhouettes), AND (b) a tight percentile bound proving the
    rest of the field agrees to fp32 rounding, not just to the loose
    flip tolerance."""
    img = np.asarray(img)
    ref = np.asarray(ref)
    if not np.isfinite(img).all():
        raise AssertionError("non-finite pixels")
    mismatch = np.mean(~np.isclose(img, ref, rtol=rtol, atol=atol))
    if not mismatch < frac_tol:
        raise AssertionError(f"{mismatch:.3%} pixels differ")
    err = np.abs(img - ref).max(axis=-1)
    p98 = np.percentile(err, 98)
    if not p98 < p98_tol:
        raise AssertionError(f"p98 err {p98:.2e} (>{p98_tol:.0e})")
