"""The port's TensorBoard writer and scalar logs against mars_tpu.utils:
the crc32c check value, event-file bytes for the same scalars and wall
time, and ``scalars.csv`` fresh and appended."""
import os

import numpy as np
import pytest

from mars_tpu.utils import evaluation as jeval, logging as jlog, tboard as jtb
from mars_tpu_torch.utils import evaluation as teval, logging as tlog, tboard as ttb

WALL = 1_760_000_000.25


@pytest.mark.parametrize("data,want", [(b"123456789", 0xE3069283), (b"", 0x0),
                                       (bytes(32), 0x8A9136AA)])
def test_crc32c_check_values(data, want):
    """RFC 3720 B.4 / the CRC catalogue's check values."""
    assert ttb.crc32c(data) == jtb.crc32c(data) == want


def _events(mod, logdir, monkeypatch):
    monkeypatch.setattr(mod.time, "time", lambda: WALL)
    monkeypatch.setattr(mod.socket, "gethostname", lambda: "host")
    w = mod.SummaryWriter(str(logdir))
    w.add_scalar("test_mIoU", 41.5, 0)
    w.add_scalar("time_elapsed_batch", 0.1234567, 1, wall_time=WALL + 3.5)
    w.add_scalars(2, **{"test_mIoU": 55.0, "test_FB-IoU": 70.125})
    w.add_scalar("negative_step", -1.0, -7)
    w.flush()
    w.close()
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name), "rb") as f:
        return name, f.read()


def test_event_file_bytes_equal_jax(tmp_path, monkeypatch):
    jname, jbytes = _events(jtb, tmp_path / "jax", monkeypatch)
    tname, tbytes = _events(ttb, tmp_path / "port", monkeypatch)
    assert tname == jname and tbytes == jbytes
    payloads = ttb.read_records(str(tmp_path / "port" / tname))
    assert len(payloads) == 1 + 5 and b"brain.Event:2" in payloads[0]


def test_read_records_refuses_a_flipped_byte(tmp_path, monkeypatch):
    name, data = _events(ttb, tmp_path, monkeypatch)
    bad = bytearray(data)
    bad[40] ^= 1
    path = tmp_path / name
    path.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="crc"):
        ttb.read_records(str(path))


def _metrics(log, evaluation, logging, append, episodes):
    meter = evaluation.AverageMeter("synthetic", range(4))
    m = logging.MetricsLogger(str(log), meter, append=append)
    rng = np.random.RandomState(episodes[0])
    for idx in episodes:
        pred, gt = rng.rand(2, 12, 12) > 0.5
        inter, union = evaluation.classify_prediction(pred, gt)
        meter.update(inter, union, idx % 4)
        if idx % 2:
            meter.update_bad_preds(inter, union, idx % 4)
        m.log_metrics(idx)
        m.log_time_batch(0.01 * idx, idx)
    m.log_metrics_bad_preds(episodes[-1])
    m.end(1.5, episodes[-1])


def test_scalars_csv_equal_fresh_and_appended(tmp_path):
    for side, ev, lg in (("jax", jeval, jlog), ("port", teval, tlog)):
        log = tmp_path / side
        log.mkdir()
        _metrics(log, ev, lg, False, [0, 1, 2])
        _metrics(log, ev, lg, True, [3, 4])  # a --resume continuation
    got = (tmp_path / "port" / "scalars.csv").read_text()
    assert got == (tmp_path / "jax" / "scalars.csv").read_text()
    assert got.count("\n") == 5 * 3
    for side, ev, lg in (("jax", jeval, jlog), ("port", teval, tlog)):
        _metrics(tmp_path / side, ev, lg, False, [5])  # a fresh run truncates
    got = (tmp_path / "port" / "scalars.csv").read_text()
    assert got == (tmp_path / "jax" / "scalars.csv").read_text() and got.count("\n") == 3


def test_initialize_writes_log_and_argument_dump(tmp_path):
    import argparse

    args = argparse.Namespace(b=2, a="x")
    logger = tlog.initialize(str(tmp_path), "", args)
    logger.info("hello")
    tlog.close(logger)
    text = (tmp_path / "log.txt").read_text()
    assert text.index("| a: x") < text.index("| b: 2") < text.index("hello")
    logger = tlog.initialize(str(tmp_path), "exp")
    tlog.close(logger)
    assert os.path.exists(tmp_path / "exp" / "log.txt")
