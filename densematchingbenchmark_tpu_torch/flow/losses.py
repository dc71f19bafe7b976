"""Multi-scale optical-flow training loss.

Counterpart of densematchingbenchmark_tpu/flow/losses.py: per level a
weighted robust-L1 (Charbonnier) endpoint error against the ground truth
average-pooled to the prediction's resolution, its values divided by the
pooling factor; NaN ground truth is masked out (a pooled pixel with any
NaN below it too).
"""

import torch

from ..parallel.collectives import global_count


def _rescale_gt_flow(gt_flow, out_h, out_w):
    """Average-pool [B, H, W, 2] ground truth to (out_h, out_w), the flow
    values divided by the factor along their axis."""
    b, h, w, _ = gt_flow.shape
    if (h, w) == (out_h, out_w):
        return gt_flow
    if h % out_h or w % out_w:
        raise ValueError(f"ground truth {h}x{w} does not pool to "
                         f"{out_h}x{out_w}")
    sh, sw = h // out_h, w // out_w
    pooled = gt_flow.reshape(b, out_h, sh, out_w, sw, 2).mean(dim=(2, 4))
    return torch.stack([pooled[..., 0] * (1.0 / sw),
                        pooled[..., 1] * (1.0 / sh)], dim=-1)


def flow_l1_loss(flows, gt_flow, weights, eps=1e-8):
    """Weighted multi-scale endpoint loss.

    Args:
      flows: list of [B, h_i, w_i, 2] predictions, best first.
      gt_flow: [B, H, W, 2] dense ground truth; NaN is masked out.
      weights: one weight per prediction.

    Returns:
      {"flow_loss_lvl{i}": 0-d tensor}.
    """
    if len(weights) != len(flows):
        raise ValueError(f"{len(weights)} loss weights for {len(flows)} "
                         "flows")
    nan = torch.isnan(gt_flow).any(dim=-1, keepdim=True)
    clean = torch.nan_to_num(gt_flow)
    losses = {}
    for i, (flow, wt) in enumerate(zip(flows, weights)):
        _, h, w, _ = flow.shape
        gt = _rescale_gt_flow(clean, h, w)
        valid = (~nan).float()
        if valid.shape[1] != h:
            b, sh, sw = valid.shape[0], valid.shape[1] // h, \
                valid.shape[2] // w
            valid = valid.reshape(b, h, sh, w, sw, 1).amin(dim=(2, 4))
        err = torch.sqrt(((flow - gt) ** 2).sum(-1, keepdim=True) + eps)
        denom = global_count(valid.sum()).clamp_min(1.0)
        losses[f"flow_loss_lvl{i}"] = wt * (err * valid).sum() / denom
    return losses
