"""Profiling / observability utilities."""
import json

import jax.numpy as jnp
import numpy as np

from semiblind_tv.runtime.profiling import CallCounter, MetricsLogger, StepTimer


def test_step_timer():
    t = StepTimer()
    for _ in range(3):
        t.timed(lambda: jnp.sum(jnp.ones((64, 64))))
    s = t.summary()
    assert s["count"] == 3
    assert s["total_s"] > 0


def test_call_counter():
    reg = {}
    A = CallCounter(lambda v: v * 2, "A", reg)
    AT = CallCounter(lambda v: v / 2, "AT", reg)
    for _ in range(4):
        A(1.0)
    AT(2.0)
    assert reg == {"A": 4, "AT": 1}
    assert A.calls == 4


def test_metrics_logger(tmp_path):
    p = str(tmp_path / "metrics.jsonl")
    log = MetricsLogger(p)
    log.log(1, mse=np.float32(3.5), theta=0.01)
    log.log(2, mse=3.2)
    log.close()
    lines = [json.loads(l) for l in open(p)]
    assert lines[0] == {"step": 1, "mse": 3.5, "theta": 0.01}
    assert lines[1]["step"] == 2
