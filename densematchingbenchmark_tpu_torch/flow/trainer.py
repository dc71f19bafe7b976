"""Training and evaluation of the flow models.

Counterpart of densematchingbenchmark_tpu/flow/trainer.py on one device.
JAX's ``train_flow`` is the stereo trainer's loop here
(trainer/loop.train_matcher on a flow config: the
loader, optimizer and schedule, the exact (epoch, batch_in_epoch) resume,
the logs, the profiler window) with the flow task's pieces from
``flow_task``: ``make_flow_train_step``; after each epoch the eval set, if
any, scored (EPE and n-px of the best flow, logged under 'eval/'), and the
vis hook writing the colour wheels of the estimated and ground-truth
flows.
"""

import os
import os.path as osp

import numpy as np
import torch

from ..data.io import save_png
from ..data.loader import collate
from ..evaluation.eval_loop import _prefetch_samples, to_device
from ..evaluation.format import combine_shard_metrics
from ..trainer.train_step import make_flow_train_step
from .metrics import calc_flow_error
from .vis import flow_to_color

_KEYS = ("leftImage", "rightImage", "flow")


def make_flow_eval_step(module, sparse=False):
    """step(batch) -> the metric dict (0-d tensors on the device) of the
    best flow against batch['flow'], in eval mode under inference mode."""

    def step(batch):
        with torch.inference_mode():
            out = module(batch["leftImage"], batch["rightImage"])
            return calc_flow_error(out["flows"][0], batch["flow"],
                                   sparse=sparse)

    return step


def evaluate_flow(module, dataset, sparse=False, num_shards=1, shard_id=0,
                  step=None):
    """Batch-1 evaluation of this shard's samples (stride ``num_shards``
    from ``shard_id``), loaded ahead by worker threads; the metrics are
    summed on the device and read once at the end. Returns (averaged
    metric dict, sample count)."""
    device = next(module.parameters()).device
    was_training = module.training
    module.eval()
    if step is None:
        step = make_flow_eval_step(module, sparse)
    sums, count = None, 0
    try:
        for sample in _prefetch_samples(
                dataset, range(shard_id, len(dataset), num_shards)):
            batch = to_device({k: v for k, v in collate([sample]).items()
                               if k in _KEYS}, device)
            result = step(batch)
            vec = torch.stack([result[k] for k in sorted(result)])
            sums = vec if sums is None else sums + vec
            count += 1
    finally:
        module.train(was_training)
    if sums is None:
        return {}, 0
    values = (sums / count).tolist()
    return dict(zip(sorted(result), values)), count


class FlowVisHook:
    """Callable hook (module, epoch): the colour wheels of the estimated
    best flow ('flow_0') and of the ground truth ('flow_gt') of the first
    ``max_samples`` samples, to <work_dir>/vis/sample_<i>/<key>_<epoch>.png
    and to TensorBoard through ``metrics_log.log_media``."""

    def __init__(self, dataset, work_dir, metrics_log=None, max_samples=2):
        self.dataset = dataset
        self.work_dir = work_dir
        self.metrics_log = metrics_log
        self.max_samples = max_samples

    def __call__(self, module, epoch):
        device = next(module.parameters()).device
        was_training = module.training
        module.eval()
        media = {}
        try:
            for i in range(min(len(self.dataset), self.max_samples)):
                batch = collate([self.dataset[i]])
                x = to_device({k: batch[k] for k in ("leftImage",
                                                     "rightImage")}, device)
                with torch.inference_mode():
                    out = module(x["leftImage"], x["rightImage"])
                est = out["flows"][0][0].float().cpu().numpy()
                imgs = {"flow_0": flow_to_color(est)}
                if batch.get("flow") is not None:
                    imgs["flow_gt"] = flow_to_color(np.nan_to_num(
                        batch["flow"][0]))
                sample_dir = osp.join(self.work_dir, "vis",
                                      f"sample_{i:03d}")
                os.makedirs(sample_dir, exist_ok=True)
                for key, img in imgs.items():
                    img8 = np.clip(img, 0, 255).astype(np.uint8)
                    save_png(osp.join(sample_dir, f"{key}_{epoch}.png"),
                             img8)
                    media[f"image/vis/sample_{i:03d}/{key}"] = img8
        finally:
            module.train(was_training)
        if self.metrics_log is not None and media:
            self.metrics_log.log_media(epoch, media)


def flow_task(cfg, work_dir, metrics_log, eval_dataset, vis_dataset):
    """The flow pieces of ``trainer.loop.train_matcher``: (batch keys,
    train step, eval callable module -> (metric dict, its log text) or
    None, vis hook or None)."""
    step = make_flow_train_step(
        tuple(cfg["model"]["losses"]["flow_l1_loss"]["weights"]))
    run_eval = None
    if eval_dataset is not None:
        sparse = cfg["model"].get("eval", {}).get("sparse", False)

        def run_eval(module):
            results, n = combine_shard_metrics(*evaluate_flow(
                module, eval_dataset, sparse))
            return results, f"flow eval ({n} samples): " + ", ".join(
                f"{k}={v:.3f}" for k, v in sorted(results.items()))
    vis_hook = (FlowVisHook(vis_dataset, work_dir, metrics_log)
                if vis_dataset is not None and
                cfg.get("vis", {}).get("enabled", True) else None)
    return _KEYS, step, run_eval, vis_hook
