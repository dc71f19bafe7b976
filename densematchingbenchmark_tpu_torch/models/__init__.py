"""Models of the port (counterparts of densematchingbenchmark_tpu/models/)."""

from .builder import build_model
from .generalized import GeneralizedStereoModel
from .layers import BasicBlock, ConvUnit, Hourglass3D

__all__ = ["build_model", "GeneralizedStereoModel", "BasicBlock", "ConvUnit",
           "Hourglass3D"]
