"""Evaluation helpers of the port (counterparts of
densematchingbenchmark_tpu/evaluation/)."""

from .metrics import remove_padding

__all__ = ["remove_padding"]
