"""Data pipeline of the port: transforms, the synthetic dataset, sampling
and loading (counterparts of densematchingbenchmark_tpu/data/)."""

from . import transforms
from .datasets import SyntheticStereoDataset, build_dataset
from .loader import DataLoader, collate
from .sampler import EpochSampler

__all__ = ["transforms", "SyntheticStereoDataset", "build_dataset",
           "DataLoader", "collate", "EpochSampler"]
