"""Checkpoint and resume with torch.save / torch.load.

Counterpart of densematchingbenchmark_tpu/utils/checkpoint.py (orbax
there): the whole train state (module parameters and BN statistics,
optimizer state, step, generator state) plus JSON-able metadata, one file
per step under <work_dir>/checkpoints/. The metadata's (epoch,
batch_in_epoch) pair gives exact mid-epoch resume: the trainer skips ahead
through the deterministic sampler and replays the same remaining batches.
"""

import os
import re

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, work_dir, max_to_keep=5):
        self.path = os.path.abspath(os.path.join(work_dir, "checkpoints"))
        os.makedirs(self.path, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self):
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.path))
                      if m)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _file(self, step):
        return os.path.join(self.path, f"{step}.pt")

    def save(self, step, state_dict, metadata=None):
        """Write ``state_dict`` (tensors are saved from any device) and
        ``metadata`` at ``step``, replacing a checkpoint of that step;
        keep the newest ``max_to_keep``."""
        tmp = self._file(step) + ".tmp"
        torch.save({"state": state_dict, "metadata": metadata}, tmp)
        os.replace(tmp, self._file(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._file(old))

    def restore(self, step=None, map_location="cpu"):
        """(state_dict, metadata) at ``step`` (default the latest), or
        (None, None) when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        payload = torch.load(self._file(step), map_location=map_location,
                             weights_only=True)
        return payload["state"], payload["metadata"]
