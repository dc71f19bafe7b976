"""Config-driven combined loss evaluator.

Counterpart of densematchingbenchmark_tpu/losses/builder.py:16-85. The
loss section of a model config maps a loss name to its kwargs; each named
loss contributes a weighted dict of per-level scalars, merged into one
loss dict, and the training loss is the sum of every entry whose key holds
'loss'. The port has the ``l1_loss``, ``gerf_loss`` and ``focal_loss``
branches, DeepPruner's ``quantile_loss`` on its predicted range, and the
confidence NLL loss of the cmn (``cmn_loss``).
"""

from .disp_losses import (conf_nll_loss, gerf_loss, quantile_loss,
                          smooth_l1_loss)
from .focal import stereo_focal_loss


class CombinedLossEvaluator:
    """Callable: (disps, costs, gt, variance=None, min_disparity=None,
    max_disparity=None) -> {name_lvl<i>: scalar, 'quantile_loss': scalar}.

    ``cmn_losses_cfg`` (AcfNet adaptive) configures the confidence NLL loss
    on the cmn's pre-sigmoid confidence costs, applied by ``cmn_loss``.
    """

    def __init__(self, losses_cfg, sparse=False, cmn_losses_cfg=None):
        self.cfg = dict(losses_cfg)
        self.sparse = sparse
        self.cmn_cfg = dict(cmn_losses_cfg) if cmn_losses_cfg else None

    def cmn_loss(self, conf_costs, gt_disp):
        if not self.cmn_cfg or "nll_loss" not in self.cmn_cfg:
            return {}
        cfg = dict(self.cmn_cfg["nll_loss"])
        weight = cfg.pop("weight", 1.0)
        part = conf_nll_loss(conf_costs, gt_disp, max_disp=cfg["max_disp"],
                             start_disp=cfg.get("start_disp", 0),
                             weights=cfg.get("weights"), sparse=self.sparse)
        return {k: weight * v for k, v in part.items()}

    def __call__(self, disps, costs, gt_disp, variance=None,
                 min_disparity=None, max_disparity=None):
        loss_dict = {}
        for name, cfg in self.cfg.items():
            cfg = dict(cfg)
            weight = cfg.pop("weight", 1.0)
            if name == "quantile_loss":
                loss_dict["quantile_loss"] = quantile_loss(
                    min_disparity, max_disparity, gt_disp,
                    max_disp=cfg["max_disp"],
                    start_disp=cfg.get("start_disp", 0), weight=weight,
                    theta=cfg.get("theta", 0.05))
                continue
            if name == "l1_loss":
                part = smooth_l1_loss(
                    disps, gt_disp, max_disp=cfg["max_disp"],
                    start_disp=cfg.get("start_disp", 0),
                    weights=cfg.get("weights"), sparse=self.sparse)
            elif name == "gerf_loss":
                part = gerf_loss(
                    disps, gt_disp, max_disp=cfg["max_disp"],
                    start_disp=cfg.get("start_disp", 0),
                    weights=cfg.get("weights"), sparse=self.sparse)
            elif name == "focal_loss":
                var = (variance if variance is not None
                       else cfg.get("variance", 1.0))
                part = stereo_focal_loss(
                    costs, gt_disp, max_disp=cfg["max_disp"], variance=var,
                    start_disp=cfg.get("start_disp", 0),
                    dilation=cfg.get("dilation", 1),
                    weights=cfg.get("weights"),
                    focal_coefficient=cfg.get("coefficient", 0.0),
                    sparse=self.sparse)
            else:
                raise ValueError(f"unknown loss '{name}'")
            loss_dict.update({k: weight * v for k, v in part.items()})
        return loss_dict


def make_loss_evaluator(losses_cfg, sparse=False, cmn_losses_cfg=None):
    return CombinedLossEvaluator(losses_cfg, sparse, cmn_losses_cfg)


def total_loss(loss_dict):
    """Sum every entry whose key contains 'loss' (reference parse_losses)."""
    return sum(v for k, v in loss_dict.items() if "loss" in k)
