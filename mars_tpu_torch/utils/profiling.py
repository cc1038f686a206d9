"""Timing and tracing (port of ``mars_tpu/utils/profiling.py``).

  - ``StageTimers``: named wall-clock spans; a span given a tensor waits
    for the device that holds it before it stops the clock (``force_sync``).
  - ``trace``: a ``torch.profiler`` trace (CPU and, on the card, CUDA
    activity) written as a Chrome trace under ``MARS_TPU_PROFILE_DIR`` or
    the given directory; a no-op when neither is set.

The pipeline's own stage spans (``mars.*`` in ``pipeline.mars``,
``matcher.*`` in ``pipeline.matcher``) are ``record_function`` ranges that
such a trace shows and that cost nothing without one.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

PROFILE_DIR_ENV = "MARS_TPU_PROFILE_DIR"


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def force_sync(x) -> None:
    """Waits until the work that produced ``x`` (a tensor, or a dict, list
    or tuple holding tensors) has finished: an event recorded on the
    current stream of the first tensor's card, then waited on.  A CPU
    tensor is already done."""
    t = next(_tensors(x), None)
    if t is not None and t.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
        event.synchronize()


class StageTimers:
    """Sums and counts of named spans; ``summary`` gives each one's mean in
    seconds, ``report`` the means in milliseconds on one line."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, sync_result=None):
        t0 = time.perf_counter()
        yield
        if sync_result is not None:
            force_sync(sync_result)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def report(self) -> str:
        return "  ".join(f"{k}={v * 1000:.1f}ms" for k, v in sorted(self.summary().items()))


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block, written to
    ``<log_dir>/trace_<pid>_<ns>.json`` (``log_dir`` or
    ``MARS_TPU_PROFILE_DIR``); yields the profiler, or None when neither
    names a directory."""
    log_dir = log_dir or os.environ.get(PROFILE_DIR_ENV)
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
