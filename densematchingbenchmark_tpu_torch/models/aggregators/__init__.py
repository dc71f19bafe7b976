from .acfnet import AcfAggregator
from .psmnet import PSMAggregator
from .stereonet import StereoNetAggregator

__all__ = ["AcfAggregator", "PSMAggregator", "StereoNetAggregator"]
