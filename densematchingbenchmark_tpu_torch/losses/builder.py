"""Config-driven combined loss evaluator.

Counterpart of densematchingbenchmark_tpu/losses/builder.py:16-85. The
loss section of a model config maps a loss name to its kwargs; each named
loss contributes a weighted dict of per-level scalars, merged into one
loss dict, and the training loss is the sum of every entry whose key holds
'loss'. The port has the ``l1_loss`` branch; the others raise
NotImplementedError naming their ROADMAP.md item.
"""

from .disp_losses import smooth_l1_loss

# loss name -> the ROADMAP.md queue 1 item that ports it
_NOT_PORTED = {"gerf_loss": "7 (StereoNet)", "focal_loss": "6 (AcfNet)",
               "quantile_loss": "9 (DeepPruner)"}


class CombinedLossEvaluator:
    """Callable: (disps, costs, gt) -> {name_lvl<i>: scalar}."""

    def __init__(self, losses_cfg, sparse=False):
        self.cfg = dict(losses_cfg)
        self.sparse = sparse

    def __call__(self, disps, costs, gt_disp):
        loss_dict = {}
        for name, cfg in self.cfg.items():
            cfg = dict(cfg)
            weight = cfg.pop("weight", 1.0)
            if name in _NOT_PORTED:
                raise NotImplementedError(
                    f"{name} is not ported yet (ROADMAP.md queue 1 item "
                    f"{_NOT_PORTED[name]})")
            if name != "l1_loss":
                raise ValueError(f"unknown loss '{name}'")
            part = smooth_l1_loss(
                disps, gt_disp, max_disp=cfg["max_disp"],
                start_disp=cfg.get("start_disp", 0),
                weights=cfg.get("weights"), sparse=self.sparse)
            loss_dict.update({k: weight * v for k, v in part.items()})
        return loss_dict


def make_loss_evaluator(losses_cfg, sparse=False):
    return CombinedLossEvaluator(losses_cfg, sparse)


def total_loss(loss_dict):
    """Sum every entry whose key contains 'loss' (reference parse_losses)."""
    return sum(v for k, v in loss_dict.items() if "loss" in k)
