"""The training step.

Counterpart of densematchingbenchmark_tpu/trainer/train_step.py:23-60:
forward in train mode (batch-statistics BN, the running statistics
updated; the state's generator handed to the model, which draws
DeepPruner's PatchMatch noise from it as JAX's step draws it from its
'patch_match' rng, :38), the loss dict and its total (with a cmn, the
focal loss takes its variances and the confidence NLL loss its
confidence costs; DeepPruner's quantile loss its predicted range), the
gradients, the clip and the optimizer update. Metrics are 'loss', every
loss entry ('l1_loss_lvl<i>', 'stereo_focal_loss_lvl<i>',
'conf_loss_lvl<i>', 'quantile_loss') and 'grad_norm', the global norm of
the raw
(unclipped) gradients, as 0-d tensors on the device: reading them is the
caller's choice of sync point.
The forward does not run under ``StereoModel.forward``'s inference mode.
``make_flow_train_step`` is the flow task's (JAX :74-102): the multi-scale
flow loss (flow/losses.flow_l1_loss) over the model's 'flows'. Both end in
``apply_losses``: the gradient, clip, update and metrics.
"""

import torch

from ..losses.builder import total_loss
from .optim import global_norm


def apply_losses(state, loss_dict):
    """The gradients of ``loss_dict``'s total, the clip and the update;
    returns (state, metrics)."""
    opt = state.optimizer
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


def make_train_step(loss_evaluator):
    """Returns step(state, batch) -> (state, metrics).

    batch: dict of tensors on the model's device, 'leftImage' /
    'rightImage' [B, H, W, 3] and 'leftDisp' [B, H, W, 1].
    """

    def step(state, batch):
        module = state.module
        module.train()
        out = module(batch["leftImage"], batch["rightImage"],
                     generator=state.generator)
        loss_dict = loss_evaluator(out["disps"], out["costs"],
                                   batch["leftDisp"],
                                   variance=out.get("variances"),
                                   min_disparity=out.get("min_disparity"),
                                   max_disparity=out.get("max_disparity"))
        if "conf_costs" in out:
            loss_dict.update(loss_evaluator.cmn_loss(out["conf_costs"],
                                                     batch["leftDisp"]))
        return apply_losses(state, loss_dict)

    return step


def make_flow_train_step(weights):
    """Returns step(state, batch) -> (state, metrics) of a flow model.

    batch: dict of tensors on the model's device, 'leftImage' /
    'rightImage' [B, H, W, 3] (frames t and t + 1) and 'flow'
    [B, H, W, 2]; ``weights``: the loss weight of each flow, best first.
    Metrics: 'loss', 'flow_loss_lvl<i>' and 'grad_norm'.
    """
    from ..flow.losses import flow_l1_loss

    def step(state, batch):
        state.module.train()
        out = state.module(batch["leftImage"], batch["rightImage"])
        return apply_losses(state, flow_l1_loss(out["flows"], batch["flow"],
                                                weights))

    return step
