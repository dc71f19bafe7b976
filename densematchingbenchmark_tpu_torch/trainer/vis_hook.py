"""Per-epoch visualization hook of the training loop.

Counterpart of densematchingbenchmark_tpu/trainer/vis_hook.py:21-111:
after each training epoch, eval-mode inference on a small vis dataset,
whose colour disparity, error, group and (with a cmn) confidence panels go
to <work_dir>/vis/sample_<i>/<panel>_<epoch>.png through the port's PNG
encoder, and the same images with the confidence histograms to
TensorBoard through ``MetricsLogger.log_media``.
"""

import os
import os.path as osp

import numpy as np
import torch

from ..data.io import save_png
from ..data.loader import collate
from ..evaluation.eval_loop import to_device
from ..visualization.show_result import ShowResultTool

# panels routed to TensorBoard as well as written
_MEDIA = ("disp_0", "disp_0_err", "group", "conf_0", "conf_0_hist")


class VisHook:
    """Callable hook: (module, epoch) -> None.

    Args:
      dataset: the vis dataset (eval transform applied; small).
      work_dir: the PNGs go to <work_dir>/vis/.
      metrics_log: utils.logging.MetricsLogger, or None.
      mean, std: to undo the left image's normalisation for the panel.
      max_disp: the colour ramp's scale.
      max_samples: samples drawn per epoch, at most.
      write: False on a model rank that runs the forwards beside the one
        that writes (a model whose cost volume is split over its ranks).
    """

    def __init__(self, dataset, work_dir, metrics_log=None,
                 mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0), max_disp=192,
                 max_samples=4, write=True):
        self.dataset = dataset
        self.work_dir = work_dir
        self.metrics_log = metrics_log
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.max_disp = max_disp
        self.max_samples = max_samples
        self.write = write

    def __call__(self, module, epoch):
        tool = ShowResultTool(self.max_disp)
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
                if not self.write:
                    continue
                result = {
                    "disps": [d.float().cpu().numpy() for d in out["disps"]],
                    "leftImage": batch["leftImage"][0] * self.std
                    + self.mean}
                if batch.get("leftDisp") is not None:
                    result["leftDisp"] = batch["leftDisp"]
                if "confs" in out:
                    result["confs"] = [c.float().cpu().numpy()
                                       for c in out["confs"]]
                sample_dir = osp.join(self.work_dir, "vis",
                                      f"sample_{i:03d}")
                os.makedirs(sample_dir, exist_ok=True)
                for key, img in tool(result).items():
                    img8 = np.clip(img, 0, 255).astype(np.uint8)
                    if img8.ndim == 2:
                        img8 = np.stack([img8] * 3, -1)
                    save_png(osp.join(sample_dir, f"{key}_{epoch}.png"),
                             img8)
                    if key in _MEDIA:
                        media[f"image/vis/sample_{i:03d}/{key}"] = img8
                for j, conf in enumerate(result.get("confs", [])):
                    media[f"histogram/vis/sample_{i:03d}/conf_{j}"] = \
                        np.clip(conf, 0.0, 1.0)
        finally:
            module.train(was_training)
        if self.metrics_log is not None and media:
            self.metrics_log.log_media(epoch, media)


def build_vis_dataset(cfg, eval_dataset=None):
    """The vis dataset of a config: data.vis.annfile's if set, else the
    eval dataset, else (a Synthetic config) two fresh synthetic samples at
    the train shape; None when there is none of these."""
    from ..data import SyntheticStereoDataset, build_dataset, transforms

    data_cfg = cfg["data"]
    mean, std = data_cfg["mean"], data_cfg["std"]
    vis_cfg = data_cfg.get("vis", {})
    if vis_cfg.get("annfile"):
        return build_dataset(
            data_cfg, "vis",
            transform=transforms.make_eval_transform(
                vis_cfg.get("input_shape", data_cfg["eval"]["input_shape"]),
                mean, std))
    if eval_dataset is not None:
        return eval_dataset
    if data_cfg.get("type") == "Synthetic":
        shape = data_cfg["train"]["input_shape"]
        return SyntheticStereoDataset(
            length=2, height=shape[0], width=shape[1],
            max_disp=min(cfg["model"]["max_disp"], 64),
            transform=transforms.make_eval_transform(shape, mean, std))
    return None
