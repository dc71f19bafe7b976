"""Logging: a text logger, the JSON-lines metrics log and TensorBoard.

Counterpart of densematchingbenchmark_tpu/utils/logging.py:19-104. As
there, only rank 0 of a process group writes files: the text log, the
metrics log and TensorBoard (tensorboardX's writer, under <work_dir>/tb,
made only when that package imports; without it the JSON metrics log is
the whole record); another rank's text logger prints errors only.
"""

import json
import logging
import os
import sys
import time

import numpy as np


def get_logger(work_dir=None, name="dmb_torch", rank=0):
    """The text logger: stdout, and <work_dir>/<time>_log.txt of the latest
    ``work_dir`` given (a later run in the same process logs to its own).
    On a rank other than 0: stdout, errors only, and no file."""
    logger = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    if not logger.handlers:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    logger.setLevel(logging.INFO if rank == 0 else logging.ERROR)
    if work_dir and rank == 0:
        path = os.path.abspath(work_dir)
        files = [h for h in logger.handlers
                 if isinstance(h, logging.FileHandler)]
        if not any(os.path.dirname(h.baseFilename) == path for h in files):
            for h in files:
                logger.removeHandler(h)
                h.close()
            os.makedirs(path, exist_ok=True)
            stamp = time.strftime("%Y%m%d_%H%M%S")
            fh = logging.FileHandler(os.path.join(path, f"{stamp}_log.txt"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class MetricsLogger:
    """Appends one JSON object per call to <work_dir>/metrics.log.json,
    and the same scalars to TensorBoard when tensorboardX imports. On a
    rank other than 0 it writes nothing."""

    def __init__(self, work_dir, tensorboard=True, rank=0):
        self.rank = rank
        self.json_path = self.tb = None
        if rank != 0:
            return
        os.makedirs(work_dir, exist_ok=True)
        self.json_path = os.path.join(work_dir, "metrics.log.json")
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self.tb = SummaryWriter(os.path.join(work_dir, "tb"))

    def log(self, step, metrics, prefix=""):
        if self.rank != 0:
            return
        record = {"step": int(step),
                  **{prefix + k: float(v) for k, v in metrics.items()}}
        with open(self.json_path, "a") as fp:
            fp.write(json.dumps(record) + "\n")
        if self.tb is not None:
            for k, v in record.items():
                if k != "step":
                    self.tb.add_scalar(k, v, int(step))

    def log_media(self, step, media, *, value_range=None):
        """Media by tag prefix, to TensorBoard (nothing without it):
        'image/<tag>' an HWC image (uint8, or float 0-255 or 0-1),
        'histogram/<tag>' raw values, 'figure/<tag>' a matplotlib figure,
        anything else a scalar. ``value_range``: optional {tag: 'unit' |
        '255'} for float images, over the peak <= 1 rule."""
        if self.tb is None:
            return
        for tag, rec in media.items():
            prefix, _, suffix = tag.partition("/")
            if prefix == "image":
                img = np.asarray(rec)
                if img.ndim == 2:
                    img = img[..., None].repeat(3, -1)
                if img.dtype != np.uint8:
                    rng = (value_range or {}).get(tag)
                    if rng is None:
                        rng = "unit" if img.max() <= 1.0 + 1e-6 else "255"
                    img = np.clip(img * (255.0 if rng == "unit" else 1.0),
                                  0, 255).astype(np.uint8)
                self.tb.add_image(suffix, img, int(step), dataformats="HWC")
            elif prefix == "histogram":
                self.tb.add_histogram(suffix, np.asarray(rec).ravel(),
                                      int(step))
            elif prefix == "figure":
                self.tb.add_figure(suffix, rec, int(step))
            else:
                self.tb.add_scalar(tag, float(rec), int(step))

    def close(self):
        if self.tb is not None:
            self.tb.close()
