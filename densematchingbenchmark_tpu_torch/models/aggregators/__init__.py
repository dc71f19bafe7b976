from .acfnet import AcfAggregator
from .psmnet import PSMAggregator

__all__ = ["AcfAggregator", "PSMAggregator"]
