"""The JAX package's CPU convergence criterion for PSMNet, met by the port's
``train_matcher`` on the CPU (the plain versions of the kernels).

tests/test_convergence_gauntlet.py holds each family to it at a tiny size:
24 train steps on one batch must take the loss below 0.7x its first value
and lower the batch's EPE. This file holds the port to the same criterion
for PSMNet (max_disp 32, lr 2e-3, no warmup, one batch of 2 at 64x96).
"""

import numpy as np
import torch

from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.data import (SyntheticStereoDataset,
                                                   transforms)
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.trainer import train_matcher
from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

MEAN, STD = (128.0,) * 3, (64.0,) * 3


def test_train_matcher_overfits_one_batch(tmp_path):
    # measured: the loss falls to about 0.2x
    cfg = get_config("PSMNet/scene_flow_f32", **{
        "model.max_disp": 32,
        "model.cost_processor.cost_computation.max_disp": 8,
        "model.cost_processor.cost_aggregator.max_disp": 32,
        "model.disp_predictor.max_disp": 32,
        "model.losses.l1_loss.max_disp": 32,
        "data.batch_size_per_device": 2, "optimizer.lr": 2e-3,
        "lr_schedule.warmup_iters": 0, "total_epochs": 24,
        "checkpoint.interval": 0})
    # the crop is the whole image, so every epoch is the same batch
    ds = SyntheticStereoDataset(length=2, height=64, width=96, max_disp=12,
                                transform=transforms.make_train_transform(
                                    (64, 96), MEAN, STD))
    batch = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(2)]))
             for k in ("leftImage", "rightImage", "leftDisp")}
    gt = batch["leftDisp"]
    valid = (gt > 0) & (gt < 32)

    def epe(module):
        with torch.no_grad():
            disp = module.eval()(batch["leftImage"],
                                 batch["rightImage"])["disps"][0]
        return float((disp - gt).abs()[valid].mean())

    epe_init = epe(build_model(cfg, torch.Generator().manual_seed(0)))
    state = train_matcher(cfg, str(tmp_path), train_dataset=ds,
                          max_steps=24, log_interval=1, device="cpu")
    losses = [r["train/loss"] for r in read_metrics(str(tmp_path))]
    assert len(losses) == 24
    assert losses[-1] < 0.7 * losses[0], losses
    assert epe(state.module) < epe_init
