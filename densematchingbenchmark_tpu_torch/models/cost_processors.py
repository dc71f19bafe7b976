"""Cost processor: raw volume construction + aggregation.

Counterpart of densematchingbenchmark_tpu/models/cost_processors.py: the
concatenation volume (PSMNet, AcfNet) and the difference volume
(StereoNet, with its ``normalize`` and ``p``), on the fixed sample range.
The correlation volume arrives with the families that use it (ROADMAP.md
queue 1 items 10 and 12).
"""

import functools

from torch import nn

from ..ops.cost_volume import cat_volume, dif_volume


class CostProcessor(nn.Module):
    """(volume builder -> aggregator) pipeline. max_disp / start_disp /
    dilation are in feature-scale units (e.g. 192 // 4). The volume keeps
    the features' dtype, the compute dtype (JAX casts it to that)."""

    def __init__(self, aggregator, volume_type="concatenation", max_disp=48,
                 start_disp=0, dilation=1, normalize=False, p=1.0):
        super().__init__()
        if volume_type == "concatenation":
            self.volume = cat_volume
        elif volume_type == "difference":
            self.volume = functools.partial(dif_volume, normalize=normalize,
                                            p=p)
        else:
            raise NotImplementedError(
                f"{volume_type} cost volume is not ported yet (ROADMAP.md "
                "queue 1: AnyNet / remaining pieces)")
        self.aggregator = aggregator
        self.max_disp, self.start_disp = max_disp, start_disp
        self.dilation = dilation

    def forward(self, ref_fms, tgt_fms):
        raw = self.volume(ref_fms, tgt_fms, self.max_disp, self.start_disp,
                          self.dilation)
        costs = self.aggregator(raw)
        return costs if isinstance(costs, (list, tuple)) else [costs]
