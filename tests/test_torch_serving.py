"""The port's serving runtime (``serving``) against ``mars_tpu.serving``
and ``Mars.predict``, and its timing and tracing utilities
(``utils.profiling``)."""
import json
import os
import threading

import numpy as np
import pytest
import torch

import torch_tiny
from torch_tiny import one_torch_thread  # noqa: F401  (autouse fixture)
from mars_tpu import serving as jserving
from mars_tpu_torch import serving
from mars_tpu_torch.data.base import to_device_episode
from mars_tpu_torch.utils import profiling


@pytest.mark.parametrize("n,h,w,size,bucket", [
    (5, 30, 40, 16, 3),    # down, rows dropped
    (2, 8, 12, 16, 4),     # up, padded
    (3, 56, 56, 56, 3),    # same size, full
    (1, 17, 9, 24, 2),     # up in one axis, down in none
])
def test_host_bucket_equals_jax(n, h, w, size, bucket):
    rng = np.random.RandomState(n * h + w)
    props = rng.randint(-1, 3, (n, h, w)).astype(np.float32)
    got, want = (mod._host_bucket_proposals(props, size, bucket) for mod in (serving, jserving))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    assert got[0].dtype == np.uint8 and got[2] == max(0, n - bucket)
    with pytest.raises(ValueError, match=r"\(N, H, W\)"):
        serving._host_bucket_proposals(props[0], size, bucket)


@pytest.fixture(scope="module")
def server():
    model = torch_tiny.port_mars(torch_tiny.jax_trees(0))
    return serving.MarsServer(model, input_size=torch_tiny.SIZE, proposal_bucket=4), model


def test_predict_and_queue_equal_mars_predict(server):
    """Synchronous, then six queued requests from a producer thread, one of
    them malformed (2-D proposals): its ValueError is delivered, the loop
    goes on, and every other mask equals ``Mars.predict`` on the episode."""
    srv, model = server
    ds = torch_tiny.dataset(6)

    def props(rec):
        return np.stack([rec.query_mask, np.zeros_like(rec.query_mask),
                         np.eye(*rec.query_mask.shape)]).astype(np.float32)

    def want(i):
        rec = ds[i]
        stack, valid, _ = serving._host_bucket_proposals(props(rec), torch_tiny.SIZE, 4)
        ep = to_device_episode(rec, torch_tiny.SIZE, 1, "cpu")
        from mars_tpu_torch.core.episode import Proposals

        return model.predict(ep, Proposals(torch.from_numpy(stack).float(),
                                           torch.from_numpy(valid)), class_name="square").numpy()

    res = srv.predict(serving.PredictRequest(ds[0], props(ds[0]), class_name="square"))
    assert res.mask.shape == (torch_tiny.SIZE, torch_tiny.SIZE) and res.timings["total"] > 0
    np.testing.assert_array_equal(res.mask, want(0))
    assert srv.warmup(ds[1], props(ds[1])) > 0

    results, done = [], threading.Event()

    def on_result(r):
        results.append(r)
        if len(results) == 6:
            done.set()

    srv.start(on_result)

    def produce():
        for i in range(6):
            p = props(ds[i])[0] if i == 2 else props(ds[i])
            srv.submit(serving.PredictRequest(ds[i], p, class_name="square", request_id=i))

    producer = threading.Thread(target=produce)
    producer.start()
    producer.join(timeout=60)
    assert done.wait(timeout=120)
    srv.stop()
    assert not producer.is_alive() and [r.request_id for r in results] == list(range(6))
    assert isinstance(results[2].error, ValueError) and results[2].mask is None
    for r in results:
        if r.request_id != 2:
            assert r.error is None
            np.testing.assert_array_equal(r.mask, want(r.request_id))


def test_worker_delivers_errors_and_keeps_draining():
    srv = serving.MarsServer(object(), input_size=16, proposal_bucket=2)
    results = []
    srv.start(results.append)

    def fake_predict(req):
        if req.request_id == 1:
            raise RuntimeError("boom")
        return serving.PredictResult(request_id=req.request_id, mask=np.zeros((2, 2)))

    srv.predict = fake_predict
    for i in (1, 2):
        srv.submit(serving.PredictRequest(None, np.zeros((1, 4, 4)), request_id=i))
    srv.stop()
    assert [r.request_id for r in results] == [1, 2]
    assert isinstance(results[0].error, RuntimeError) and results[1].error is None


def test_double_start_raises():
    srv = serving.MarsServer(object(), input_size=16)
    srv.start(lambda r: None)
    with pytest.raises(RuntimeError, match="already started"):
        srv.start(lambda r: None)
    srv.stop()
    srv.start(lambda r: None)  # a stopped server starts again
    srv.stop()


def test_stage_timers_and_force_sync():
    timers = profiling.StageTimers()
    for _ in range(3):
        with timers.span("rank", sync_result={"m": torch.ones(2)}):
            pass
    with timers.span("text"):
        pass
    assert timers.counts == {"rank": 3, "text": 1}
    s = timers.summary()
    assert set(s) == {"rank", "text"} and all(v >= 0 for v in s.values())
    assert timers.report().startswith("rank=") and "text=" in timers.report()
    profiling.force_sync([torch.zeros(1)])
    profiling.force_sync(None)


def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv(profiling.PROFILE_DIR_ENV, raising=False)
    with profiling.trace() as prof:
        assert prof is None
    with profiling.trace(str(tmp_path / "a")) as prof:
        torch.ones(8) @ torch.ones(8)
    assert prof is not None
    (name,) = os.listdir(tmp_path / "a")
    with open(tmp_path / "a" / name) as f:
        assert "traceEvents" in json.load(f)
    monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path / "b"))
    with profiling.trace():
        pass
    assert len(os.listdir(tmp_path / "b")) == 1
