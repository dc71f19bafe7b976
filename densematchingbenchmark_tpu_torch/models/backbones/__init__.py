from .psmnet import PSMNetBackbone

__all__ = ["PSMNetBackbone"]
