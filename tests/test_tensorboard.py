"""Dependency-free tfevents writer vs the real TensorBoard event reader."""
import glob
import os

import pytest

from semiblind_tv.runtime.profiling import MetricsLogger
from semiblind_tv.runtime.tensorboard import TensorBoardWriter, _crc32c


def test_crc32c_known_vectors():
    # RFC 3720 / published CRC-32C test vectors
    assert _crc32c(b"") == 0x00000000
    assert _crc32c(b"123456789") == 0xE3069283
    assert _crc32c(b"\x00" * 32) == 0x8A9136AA
    assert _crc32c(b"\xff" * 32) == 0x62A8AB43


def _value_of(v):
    """Scalar from a Summary.Value, pre- or post-data_compat migration."""
    if v.HasField("tensor"):
        return v.tensor.float_val[0]
    return v.simple_value


def test_roundtrip_with_tensorboard_reader(tmp_path):
    tb = pytest.importorskip("tensorboard")  # noqa: F841 — reader is the oracle
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    logdir = str(tmp_path / "tb")
    with TensorBoardWriter(logdir) as w:
        w.add_scalar("loss", 1.5, step=1)
        w.add_scalar("loss", 0.75, step=2)
        w.add_scalar("theta/EB", 0.03125, step=2)

    (path,) = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    events = list(EventFileLoader(path).Load())
    assert events[0].file_version == "brain.Event:2"
    # the loader migrates simple_value → scalar tensor (data_compat)
    scalars = [
        (e.step, v.tag, _value_of(v))
        for e in events
        for v in e.summary.value
    ]
    assert scalars == [
        (1, "loss", 1.5),
        (2, "loss", 0.75),
        (2, "theta/EB", 0.03125),
    ]
    assert all(e.wall_time > 0 for e in events)


def test_metrics_logger_tees_to_tensorboard(tmp_path):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    logdir = str(tmp_path / "tb")
    ml = MetricsLogger(str(tmp_path / "metrics.jsonl"), tensorboard_dir=logdir)
    ml.log(5, mse_db=27.5, label="not-a-scalar")
    ml.log(6, mse_db=26.0)
    ml.close()

    (path,) = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    scalars = [
        (e.step, v.tag, _value_of(v))
        for e in EventFileLoader(path).Load()
        for v in e.summary.value
    ]
    assert scalars == [(5, "mse_db", 27.5), (6, "mse_db", 26.0)]
    # the JSONL stream still records everything, including non-floats
    lines = open(tmp_path / "metrics.jsonl").read().strip().splitlines()
    assert len(lines) == 2 and "not-a-scalar" in lines[0]
