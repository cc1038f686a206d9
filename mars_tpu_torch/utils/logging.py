"""File and console logging, the scalar streams (the port's own copy of
``mars_tpu/utils/logging.py``; reference mars/utils/logger.py:172-209).

``initialize`` writes ``log.txt`` beside the console and dumps the sorted
argument namespace; ``MetricsLogger`` streams the running meter to a
TensorBoard event file (``utils.tboard``) and to ``scalars.csv``.
"""
from __future__ import annotations

import logging
import os
import sys
import time

from mars_tpu_torch.utils import tboard


def initialize(log_root: str, exp_name: str = None, args=None) -> logging.Logger:
    """exp_name: subdirectory under log_root; "" uses log_root itself;
    None appends a timestamp (reference Logger.initialize:172-209)."""
    ts = time.strftime("%Y%m%d-%H%M%S")
    logpath = log_root if exp_name == "" else os.path.join(log_root, exp_name or ts)
    os.makedirs(logpath, exist_ok=True)
    logger = logging.getLogger("mars_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()
    fh = logging.FileHandler(os.path.join(logpath, "log.txt"))
    fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    ch = logging.StreamHandler(sys.stdout)
    ch.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(fh)
    logger.addHandler(ch)
    if args is not None:
        logger.info(":======== mars_tpu_torch =========")
        for k, v in sorted(vars(args).items()):
            logger.info(f"| {k}: {v}")
        logger.info(":=================================")
    logger.logpath = logpath  # type: ignore[attr-defined]
    return logger


def close(logger: logging.Logger) -> None:
    """Closes the handlers ``initialize`` opened (``log.txt`` included)."""
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


class ScalarWriter:
    """``scalars.csv``: one ``step,tag,value`` line a scalar.  A fresh run
    truncates; ``append=True`` (a ``--resume`` continuation) keeps the
    interrupted run's rows and continues the stream."""

    def __init__(self, logpath: str, append: bool = False):
        self.path = os.path.join(logpath, "scalars.csv")
        self._f = open(self.path, "a" if append else "w")

    def write(self, step: int, **scalars):
        for k, v in scalars.items():
            self._f.write(f"{step},{k},{float(v)}\n")
        self._f.flush()

    def close(self):
        self._f.close()


class MetricsLogger:
    """The reference's TensorBoard/Comet stream (mars/utils/logger.py:197,
    234-294), read from the meter the evaluation loop updates
    (``utils.evaluation.AverageMeter``): the event file under
    ``<logpath>/tbd/runs`` and ``scalars.csv``."""

    def __init__(self, logpath: str, meter, split: str = "test", append: bool = False):
        self.meter = meter
        self.split = split
        self.tbd = tboard.SummaryWriter(os.path.join(logpath, "tbd", "runs"))
        self.csv = ScalarWriter(logpath, append=append)

    def log_metrics(self, step: int):
        """Running mIoU and FB-IoU (reference CometLogger.log_metrics:259-264)."""
        iou, fb_iou, _ = self.meter.compute_iou()
        scalars = {f"{self.split}_mIoU": iou, f"{self.split}_FB-IoU": fb_iou}
        self.tbd.add_scalars(step, **scalars)
        self.csv.write(step, **scalars)

    def log_time_batch(self, seconds: float, step: int):
        """reference :278-280."""
        self.tbd.add_scalar("time_elapsed_batch", seconds, step)
        self.csv.write(step, time_elapsed_batch=seconds)

    def log_metrics_bad_preds(self, step: int):
        """The known-bad subset (reference :266-276)."""
        if not self.meter.bad_class_ids:
            return
        miou, _, per_class = self.meter.compute_iou_bad_preds()
        self.tbd.add_scalars(step, bad_preds_mIoU=miou)
        for cid, iou in zip(self.meter.bad_class_ids, per_class):
            self.tbd.add_scalar(f"class{cid}_mIoU", float(iou), step)

    def end(self, total_seconds: float, step: int):
        """reference :288-294, and the final per-class table."""
        _, _, per_class = self.meter.compute_iou()
        for cid, iou in zip(self.meter.class_ids, per_class):
            self.tbd.add_scalar(f"{self.split}_cat_{cid}_IoU", float(iou), step)
        self.tbd.add_scalar("total_time_elapsed", total_seconds, step)
        self.close()

    def close(self):
        self.tbd.close()
        self.csv.close()
