"""Data pipeline of the port: file IO, datasets, transforms, sampling and
loading (counterparts of densematchingbenchmark_tpu/data/)."""

from . import io, transforms
from .datasets import (Kitti2012Dataset, Kitti2015Dataset, SceneFlowDataset,
                       StereoDataset, SyntheticStereoDataset, build_dataset)
from .loader import DataLoader, collate
from .sampler import EpochSampler, GroupedEpochSampler, aspect_group_flags

__all__ = ["io", "transforms", "StereoDataset", "SceneFlowDataset",
           "Kitti2012Dataset", "Kitti2015Dataset", "SyntheticStereoDataset",
           "build_dataset", "DataLoader", "collate", "EpochSampler",
           "GroupedEpochSampler", "aspect_group_flags"]
