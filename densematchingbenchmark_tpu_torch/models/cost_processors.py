"""Cost processor: raw volume construction + aggregation.

Counterpart of densematchingbenchmark_tpu/models/cost_processors.py. Only
the concatenation volume is ported so far; 'difference' and 'correlation'
arrive with the families that use them (ROADMAP.md queue 1).
"""

from torch import nn

from ..ops.cost_volume import cat_volume


class CostProcessor(nn.Module):
    """(volume builder -> aggregator) pipeline. max_disp / start_disp /
    dilation are in feature-scale units (e.g. 192 // 4)."""

    def __init__(self, aggregator, volume_type="concatenation", max_disp=48,
                 start_disp=0, dilation=1):
        super().__init__()
        if volume_type != "concatenation":
            raise NotImplementedError(
                f"{volume_type} cost volume is not ported yet (ROADMAP.md "
                "queue 1: StereoNet / GCNet / AnyNet / remaining pieces)")
        self.aggregator = aggregator
        self.max_disp, self.start_disp = max_disp, start_disp
        self.dilation = dilation

    def forward(self, ref_fms, tgt_fms):
        raw = cat_volume(ref_fms, tgt_fms, self.max_disp, self.start_disp,
                         self.dilation)
        costs = self.aggregator(raw)
        return costs if isinstance(costs, (list, tuple)) else [costs]
