"""Logging: a text logger and the JSON-lines metrics log.

Counterpart of densematchingbenchmark_tpu/utils/logging.py:19-64 on one
process (the JAX package's rank argument arrives with data-parallel
training, ROADMAP.md queue 1 item 5). The tensorboard writer and media
routing arrive with the visualization hook (queue 1 item 3).
"""

import json
import logging
import os
import sys
import time


def get_logger(work_dir=None, name="dmb_torch"):
    """The text logger: stdout, and <work_dir>/<time>_log.txt of the latest
    ``work_dir`` given (a later run in the same process logs to its own)."""
    logger = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if work_dir:
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
    """Appends one JSON object per call to <work_dir>/metrics.log.json."""

    def __init__(self, work_dir):
        os.makedirs(work_dir, exist_ok=True)
        self.json_path = os.path.join(work_dir, "metrics.log.json")

    def log(self, step, metrics, prefix=""):
        record = {"step": int(step),
                  **{prefix + k: float(v) for k, v in metrics.items()}}
        with open(self.json_path, "a") as fp:
            fp.write(json.dumps(record) + "\n")
