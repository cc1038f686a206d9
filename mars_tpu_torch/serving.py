"""Episode serving: a long-lived predictor with a request queue (port of
``mars_tpu/serving.py``).

  - the towers load once; every request runs ``Mars.predict`` at one input
    size and one proposal bucket;
  - a request carries a raw episode record and a proposal stack at any
    resolution: the stack is nearest-resized to the input size and padded
    or truncated to the bucket on the host, in uint8, then copied to the
    card once from pinned memory (``device.to_device``);
  - ``start`` runs a worker thread that drains a bounded queue, so a
    producer (a dataset reader, an RPC front end) prepares the next
    request while the card works; an error is delivered with its request
    and the loop keeps draining.

Usage::

    server = MarsServer(model, input_size=518, proposal_bucket=128)
    server.warmup(record, proposals)
    server.start(on_result)          # on_result(PredictResult) per request
    server.submit(PredictRequest(record, proposals, class_name="dog", request_id=7))
    server.stop()                    # drains the queue, joins the worker
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from mars_tpu_torch import device as device_lib
from mars_tpu_torch.core.episode import Proposals
from mars_tpu_torch.data.base import EpisodeRecord, to_device_episode
from mars_tpu_torch.pipeline import mars as mars_lib


@dataclass
class PredictRequest:
    record: EpisodeRecord
    proposals: np.ndarray  # (N, H, W) {0,1} at any resolution
    class_name: Optional[str] = None
    class_description: str = ""
    request_id: int = 0


@dataclass
class PredictResult:
    request_id: int
    mask: Optional[np.ndarray]  # (input_size, input_size) {0,1}; None on error
    timings: dict = field(default_factory=dict)
    error: Optional[Exception] = None
    dropped_proposals: int = 0  # rows beyond the bucket (kept in given order)


def _host_bucket_proposals(proposals: np.ndarray, size: int, bucket: int):
    """Nearest-resize a (N, H, W) mask stack to (N, size, size) and pad or
    truncate it to the bucket, in host uint8.  Returns (stack (bucket,
    size, size) uint8, valid (bucket,) bool, rows dropped).  The resize
    takes source index floor(i · H / size), as the JAX package's does."""
    p = np.asarray(proposals)
    if p.ndim != 3:
        raise ValueError(f"proposals must be (N, H, W), got {p.shape}")
    n, h, w = p.shape
    p = (p > 0).astype(np.uint8)
    if (h, w) != (size, size):
        yi = (np.arange(size) * h // size).astype(np.int64)
        xi = (np.arange(size) * w // size).astype(np.int64)
        p = p[:, yi][:, :, xi]
    dropped = max(0, n - bucket)
    if dropped:
        p = p[:bucket]
    out = np.zeros((bucket, size, size), np.uint8)
    out[: p.shape[0]] = p
    valid = np.zeros((bucket,), bool)
    valid[: p.shape[0]] = True
    return out, valid, dropped


class MarsServer:
    """A synchronous predictor and an optional queue-draining worker.

    ``Mars`` writes its ``timings`` on every call, so every prediction, the
    synchronous ``predict`` and the worker's, holds one lock."""

    def __init__(self, model: mars_lib.Mars, input_size: int = 518, max_shots: int = 1,
                 proposal_bucket: int = 128, max_queued: int = 64):
        self.model = model
        self.input_size = input_size
        self.max_shots = max_shots
        self.proposal_bucket = proposal_bucket
        self._requests: "queue.Queue[Optional[PredictRequest]]" = queue.Queue(
            maxsize=max_queued)
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ---------------- synchronous path ----------------

    def predict(self, req: PredictRequest) -> PredictResult:
        """One episode.  The mask is at (input_size, input_size), the
        pipeline's working resolution."""
        dev = self.model.device
        stack, valid, dropped = _host_bucket_proposals(req.proposals, self.input_size,
                                                       self.proposal_bucket)
        ep = to_device_episode(req.record, self.input_size, self.max_shots, dev)
        props = Proposals(masks=device_lib.to_device(torch.from_numpy(stack), dev).float(),
                          valid=device_lib.to_device(torch.from_numpy(valid), dev),
                          n_live=int(valid.sum()))
        with self._lock:
            mask = self.model.predict(ep, props, class_name=req.class_name,
                                      class_description=req.class_description)
            timings = dict(self.model.timings)
        return PredictResult(request_id=req.request_id, mask=mask.cpu().numpy(),
                             timings=timings, dropped_proposals=dropped)

    def warmup(self, record: EpisodeRecord, proposals: np.ndarray,
               class_name: Optional[str] = "object") -> float:
        """One request run to build the kernels and warm the caches;
        returns its wall time.  ``class_name=None`` on a retriever-mode
        server runs the text path too."""
        t0 = time.perf_counter()
        self.predict(PredictRequest(record, proposals, class_name=class_name))
        return time.perf_counter() - t0

    # ---------------- queued path ----------------

    def start(self, on_result: Callable[[PredictResult], None]) -> None:
        if self._worker is not None:
            raise RuntimeError("MarsServer already started")

        def loop():
            while True:
                req = self._requests.get()
                if req is None:
                    return
                try:
                    res = self.predict(req)
                except Exception as e:  # deliver per request, keep draining
                    res = PredictResult(request_id=req.request_id, mask=None, error=e)
                on_result(res)

        self._worker = threading.Thread(target=loop, daemon=True)
        self._worker.start()

    def submit(self, req: PredictRequest, timeout: Optional[float] = None) -> None:
        """Enqueues; blocks (backpressure) while ``max_queued`` requests wait."""
        self._requests.put(req, timeout=timeout)

    def stop(self) -> None:
        """Lets the worker finish what is queued, then joins it."""
        if self._worker is not None:
            self._requests.put(None)
            self._worker.join()
            self._worker = None
