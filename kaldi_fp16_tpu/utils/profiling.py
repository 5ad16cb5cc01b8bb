"""Profiling: jax.profiler traces + wall-clock step timing.

The reference relied on external Nsight Systems plus ad-hoc wall-clock
timers (SURVEY.md §5 tracing); here tracing is first-class: `trace()`
produces an xprof-compatible trace directory, `StepTimer` aggregates
step-time percentiles, `profile_fn` reports per-call latency of a jitted
function after warm-up.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace viewable in xprof/tensorboard."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class StepTimer:
    """Wall-clock step statistics with compile-step exclusion."""
    skip_first: int = 1
    _times: List[float] = field(default_factory=list)
    _skipped: int = 0
    _t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._skipped < self.skip_first:
            self._skipped += 1
        else:
            self._times.append(dt)

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        a = np.asarray(self._times)
        return {
            "steps": len(a),
            "mean_ms": float(a.mean() * 1000),
            "p50_ms": float(np.percentile(a, 50) * 1000),
            "p95_ms": float(np.percentile(a, 95) * 1000),
            "max_ms": float(a.max() * 1000),
        }


def profile_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2) -> dict:
    """Time a jitted function: returns {mean_ms, p50_ms, min_ms}."""
    import jax
    out = fn(*args)                      # compile + bind `out` even at warmup=0
    for _ in range(max(0, warmup - 1)):
        out = fn(*args)
    jax.tree_util.tree_map(lambda x: getattr(x, "block_until_ready", lambda: x)(),
                           out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.tree_util.tree_map(
            lambda x: getattr(x, "block_until_ready", lambda: x)(), out)
        times.append(time.perf_counter() - t0)
    a = np.asarray(times)
    return {"mean_ms": float(a.mean() * 1000),
            "p50_ms": float(np.percentile(a, 50) * 1000),
            "min_ms": float(a.min() * 1000)}


# Published dense peaks of each supported device, keyed by the
# `device_kind` JAX reports.  Source: NVIDIA H100 Tensor Core GPU data
# sheet, SXM5 column, dense rates without sparsity, at the 700 W power
# limit (a card set to a lower limit cannot hold these clocks).
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,      # tensor cores, bf16/fp16
        "tf32_tflops": 495.0,      # tensor cores, TF32
        "fp32_tflops": 67.0,       # outside the tensor cores
        "hbm_gbs": 3350.0,         # 80 GB HBM3
    },
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks for `device_kind`; an unknown device is an error,
    never a default."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; add a "
            f"row to DEVICE_PEAKS with its source") from None
