from .stereonet import EdgeAwareRefinement, StereoNetRefinement

__all__ = ["EdgeAwareRefinement", "StereoNetRefinement"]
