"""Cost processor: raw volume construction + aggregation.

Counterpart of densematchingbenchmark_tpu/models/cost_processors.py: the
concatenation volume (PSMNet, AcfNet, GCNet), the difference volume
(StereoNet, with its ``normalize`` and ``p``) and the 1-D correlation
volume (``Correlation`` in any of them: one channel), on the fixed sample
range.
"""

import functools

from torch import nn

from ..ops.cost_volume import cat_volume, correlation1d_volume, dif_volume


def _correlation(ref_fms, tgt_fms, *args):
    """The correlation volume with a trailing channel of 1, [B, D, H, W,
    1]: the aggregators take a channel axis."""
    return correlation1d_volume(ref_fms, tgt_fms, *args)[..., None]


# volume type -> (its function, its channels on features of c channels)
VOLUMES = {"concatenation": (cat_volume, lambda c: 2 * c),
           "difference": (dif_volume, lambda c: c),
           "correlation": (_correlation, lambda c: 1)}


def _volume(volume_type):
    if volume_type not in VOLUMES:
        raise ValueError(f"unknown volume type {volume_type}")
    return VOLUMES[volume_type]


def volume_planes(volume_type, feature_planes):
    """The channels of the raw volume of ``volume_type`` on features of
    ``feature_planes`` channels: what the aggregator's first unit takes
    (Flax infers it at init; the port fixes it at build time)."""
    return _volume(volume_type)[1](feature_planes)


class CostProcessor(nn.Module):
    """(volume builder -> aggregator) pipeline. max_disp / start_disp /
    dilation are in feature-scale units (e.g. 192 // 4). The volume keeps
    the features' dtype, the compute dtype (JAX casts it to that)."""

    def __init__(self, aggregator, volume_type="concatenation", max_disp=48,
                 start_disp=0, dilation=1, normalize=False, p=1.0):
        super().__init__()
        self.volume = _volume(volume_type)[0]
        if volume_type == "difference":
            self.volume = functools.partial(dif_volume, normalize=normalize,
                                            p=p)
        self.aggregator = aggregator
        self.max_disp, self.start_disp = max_disp, start_disp
        self.dilation = dilation

    def forward(self, ref_fms, tgt_fms):
        raw = self.volume(ref_fms, tgt_fms, self.max_disp, self.start_disp,
                          self.dilation)
        costs = self.aggregator(raw)
        return costs if isinstance(costs, (list, tuple)) else [costs]
