from .psmnet import PSMAggregator

__all__ = ["PSMAggregator"]
