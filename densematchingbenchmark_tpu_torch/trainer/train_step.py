"""The training step.

Counterpart of densematchingbenchmark_tpu/trainer/train_step.py:23-60:
forward in train mode (batch-statistics BN, the running statistics
updated), the loss dict and its total (with a cmn, the focal loss takes
its variances and the confidence NLL loss its confidence costs), the
gradients, the clip and the optimizer update. Metrics are 'loss', every
loss entry ('l1_loss_lvl<i>', 'stereo_focal_loss_lvl<i>',
'conf_loss_lvl<i>') and 'grad_norm', the global norm of the raw
(unclipped) gradients, as 0-d tensors on the device: reading them is the
caller's choice of sync point.
The forward does not run under ``StereoModel.forward``'s inference mode.
"""

import torch

from ..losses.builder import total_loss
from .optim import global_norm


def make_train_step(loss_evaluator):
    """Returns step(state, batch) -> (state, metrics).

    batch: dict of tensors on the model's device, 'leftImage' /
    'rightImage' [B, H, W, 3] and 'leftDisp' [B, H, W, 1].
    """

    def step(state, batch):
        module, opt = state.module, state.optimizer
        module.train()
        out = module(batch["leftImage"], batch["rightImage"])
        loss_dict = loss_evaluator(out["disps"], out["costs"],
                                   batch["leftDisp"],
                                   variance=out.get("variances"))
        if "conf_costs" in out:
            loss_dict.update(loss_evaluator.cmn_loss(out["conf_costs"],
                                                     batch["leftDisp"]))
        loss = total_loss(loss_dict)
        grads = torch.autograd.grad(loss, opt.params, allow_unused=True,
                                    materialize_grads=True)
        grad_norm = global_norm(grads)
        opt.step(grads, grad_norm)
        state.step += 1
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in loss_dict.items()},
                   "grad_norm": grad_norm}
        return state, metrics

    return step
