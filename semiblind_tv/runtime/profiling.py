"""Tracing / profiling / observability utilities.

The reference's tracing is tic/toc wall-clock, cputime arrays, and a global
operator-call counter (SURVEY §5: run_Gaussian_demo.m:198-201,
SALSA/callcounter.m:8-16).  JAX equivalents:

  * `trace(dir)`      — jax.profiler trace context (view in TensorBoard /
                        Perfetto); wraps jax.profiler.trace.
  * `StepTimer`       — wall-clock timing with block_until_ready, running
                        mean/percentiles; the honest device-time measure.
  * `CallCounter`     — wraps an operator callable and counts applications
                        (the reference's callcounter + `global calls`);
                        host-side by design — inside jit use the analytic
                        op_counts the solvers already report.
  * `MetricsLogger`   — JSON-lines structured metrics writer.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import jax
import numpy as np

__all__ = ["trace", "StepTimer", "CallCounter", "MetricsLogger"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region: with profiling.trace('/tmp/trace'): run_step()."""
    with jax.profiler.trace(log_dir):
        yield


class StepTimer:
    """Wall-clock step timing with device synchronisation."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def time(self, result_holder=None):
        t0 = time.perf_counter()
        yield
        if result_holder is not None:
            jax.block_until_ready(result_holder)
        self.times.append(time.perf_counter() - t0)

    def timed(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        self.times.append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return dict(
            count=len(a),
            mean_s=float(a.mean()),
            p50_s=float(np.percentile(a, 50)),
            p95_s=float(np.percentile(a, 95)),
            total_s=float(a.sum()),
        )


class CallCounter:
    """Operator-apply counter (reference SALSA/callcounter.m semantics)."""

    def __init__(self, fn, name: str = "A", registry: Optional[Dict[str, int]] = None):
        self.fn = fn
        self.name = name
        self.registry = registry if registry is not None else {}
        self.registry.setdefault(name, 0)

    def __call__(self, *args, **kwargs):
        self.registry[self.name] += 1
        return self.fn(*args, **kwargs)

    @property
    def calls(self) -> int:
        return self.registry[self.name]


class MetricsLogger:
    """Append-only JSON-lines metrics stream, optionally teed to TensorBoard.

    With `tensorboard_dir` set, every float-valued metric is also written as
    a TensorBoard scalar (runtime/tensorboard.py — dependency-free tfevents
    encoder), so SAPG/solver traces can be watched live in TensorBoard next
    to jax.profiler traces."""

    def __init__(self, path: str, tensorboard_dir: Optional[str] = None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a")
        self._tb = None
        if tensorboard_dir is not None:
            from semiblind_tv.runtime.tensorboard import TensorBoardWriter

            self._tb = TensorBoardWriter(tensorboard_dir)

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": step}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
            if self._tb is not None and isinstance(rec[k], float):
                self._tb.add_scalar(k, rec[k], step)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
