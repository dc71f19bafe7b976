"""Disparity predictor configs (parameter-free).

Counterpart of densematchingbenchmark_tpu/models/predictors.py. 'FASTER'
and 'DEFAULT' share one implementation, the soft-argmin; 'LOCAL' is the
windowed soft-argmin around the argmax (``local_soft_argmin``).
"""

import dataclasses

from ..ops.soft_argmin import local_soft_argmin, soft_argmin


@dataclasses.dataclass(frozen=True)
class DispPredictor:
    type: str = "FASTER"          # DEFAULT | FASTER | LOCAL
    max_disp: int = 192
    start_disp: int = 0
    dilation: int = 1
    alpha: float = 1.0
    normalize: bool = True
    radius: int = 2               # LOCAL only
    radius_dilation: int = 1      # LOCAL only

    def __post_init__(self):
        if self.type not in ("DEFAULT", "FASTER", "LOCAL"):
            raise ValueError(f"unknown predictor type {self.type}")

    def __call__(self, cost_volume, disp_sample=None):
        if self.type == "LOCAL":
            return local_soft_argmin(
                cost_volume, max_disp=self.max_disp, radius=self.radius,
                start_disp=self.start_disp, dilation=self.dilation,
                radius_dilation=self.radius_dilation, alpha=self.alpha)
        return soft_argmin(cost_volume, disp_sample=disp_sample,
                           max_disp=self.max_disp,
                           start_disp=self.start_disp,
                           dilation=self.dilation, alpha=self.alpha,
                           normalize=self.normalize)


def build_disp_predictor(cfg):
    known = {f.name for f in dataclasses.fields(DispPredictor)}
    return DispPredictor(**{k: v for k, v in cfg.items() if k in known})
