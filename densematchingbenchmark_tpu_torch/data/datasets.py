"""Stereo datasets: SceneFlow, KITTI-2012/2015 and a synthetic fixture.

Counterpart of densematchingbenchmark_tpu/data/datasets.py:22-178. The file
datasets read the reference's annotation format: a JSON list of dicts with
'left_image_path' / 'right_image_path' and optional 'left_disp_map_path' /
'right_disp_map_path' (and 'height' / 'width', which aspect grouping
reads), relative to a data root. ``SyntheticStereoDataset``'s samples are
bit-exact with the JAX package's (the same numpy generator and
arithmetic). Samples are channels-last numpy dicts.
"""

import json
import os.path as osp

import numpy as np

from .io import load_disp, load_image


class StereoDataset:
    """JSON-annotated stereo dataset."""

    name = "Stereo"

    def __init__(self, ann_file, root, transform=None, use_right_disp=False):
        self.root = root
        self.ann_file = ann_file
        with open(ann_file) as fp:
            self.data_list = json.load(fp)
        self.transform = transform
        self.use_right_disp = use_right_disp

    def __len__(self):
        return len(self.data_list)

    def _path(self, rel):
        return osp.join(self.root, rel)

    def load(self, idx):
        item = self.data_list[idx]
        sample = {
            "leftImage": load_image(self._path(item["left_image_path"])),
            "rightImage": load_image(self._path(item["right_image_path"])),
        }
        sample["original_size"] = sample["leftImage"].shape[:2]
        if item.get("left_disp_map_path"):
            sample["leftDisp"] = load_disp(
                self._path(item["left_disp_map_path"]))[..., None]
        if self.use_right_disp and item.get("right_disp_map_path"):
            sample["rightDisp"] = load_disp(
                self._path(item["right_disp_map_path"]))[..., None]
        return sample

    def __getitem__(self, idx, rng=None):
        sample = self.load(idx)
        if self.transform is not None:
            sample = self.transform(sample, rng)
        return sample


class SceneFlowDataset(StereoDataset):
    name = "SceneFlow"


class Kitti2012Dataset(StereoDataset):
    name = "KITTI-2012"


class Kitti2015Dataset(StereoDataset):
    name = "KITTI-2015"


class SyntheticStereoDataset:
    """Procedural stereo pairs with exact GT: the left view is the right
    one shifted by a piecewise-constant integer disparity field,
    left[y, x] = right[y, x - d(y, x)], rendered from a blurred random
    texture."""

    name = "Synthetic"

    def __init__(self, length=16, height=128, width=256, max_disp=32,
                 transform=None, seed=0, with_right_disp=False):
        self.length = length
        self.h, self.w, self.max_disp = height, width, max_disp
        self.transform = transform
        self.seed = seed
        self.with_right_disp = with_right_disp

    def __len__(self):
        return self.length

    def load(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        h, w = self.h, self.w
        # smooth random texture (right view)
        right = rng.random((h, w + self.max_disp, 3)).astype(np.float32)
        for _ in range(2):  # cheap blur for matchable gradients
            right = (right + np.roll(right, 1, 1) + np.roll(right, -1, 1) +
                     np.roll(right, 1, 0) + np.roll(right, -1, 0)) / 5.0
        right *= 255.0
        # piecewise-constant integer disparity in [1, max_disp)
        n_bands = 4
        edges = np.sort(rng.integers(1, w - 1, n_bands - 1))
        disp_vals = rng.integers(1, self.max_disp, n_bands)
        disp = np.zeros((h, w), np.float32)
        start = 0
        for e, v in zip(list(edges) + [w], disp_vals):
            disp[:, start:e] = float(v)
            start = e
        xs = np.arange(w)
        src = (xs[None, :] - disp + self.max_disp).astype(np.int64)
        left = right[np.arange(h)[:, None], src]
        sample = {
            "leftImage": left,
            "rightImage": right[:, self.max_disp:self.max_disp + w],
            "leftDisp": disp[..., None],
            "original_size": (h, w),
        }
        if self.with_right_disp:
            # rightDisp[y, x - d] = d for the left-view field (band-edge
            # pixels inherit a neighbouring band's value)
            rdisp = np.zeros((h, w), np.float32)
            np.put_along_axis(
                rdisp, np.clip(xs[None, :] - disp, 0, w - 1).astype(np.int64),
                disp, axis=1)
            sample["rightDisp"] = rdisp[..., None]
        return sample

    def __getitem__(self, idx, rng=None):
        sample = self.load(idx)
        if self.transform is not None:
            sample = self.transform(sample, rng)
        return sample


DATASETS = {
    "SceneFlow": SceneFlowDataset,
    "KITTI-2012": Kitti2012Dataset,
    "KITTI-2015": Kitti2015Dataset,
    "Synthetic": SyntheticStereoDataset,
}


def build_dataset(data_cfg, split, transform=None):
    """data_cfg: cfg['data']; split: 'train' | 'eval' | 'test'. A file
    dataset reads data_cfg[split]['annfile'] under data_cfg['data_root']
    (FlyingChairs without one raises KeyError, as JAX's)."""
    kind = data_cfg["type"]
    split_cfg = data_cfg.get(split, {})
    if kind in ("FlyingChairs", "SyntheticFlow"):
        # the flow datasets live in the flow package (JAX :158-168)
        from ..flow.datasets import FlyingChairsDataset, SyntheticFlowDataset
        if kind == "SyntheticFlow":
            return SyntheticFlowDataset(
                transform=transform,
                **{k: v for k, v in split_cfg.items()
                   if k in ("length", "height", "width", "max_flow", "seed")})
        return FlyingChairsDataset(ann_file=split_cfg["annfile"],
                                   root=data_cfg["data_root"],
                                   transform=transform)
    cls = DATASETS[kind]
    if cls is SyntheticStereoDataset:
        return cls(transform=transform,
                   **{k: v for k, v in split_cfg.items()
                      if k in ("length", "height", "width", "max_disp",
                               "seed")})
    if not split_cfg.get("annfile"):
        raise KeyError(f"data.{split}.annfile: the {kind} dataset reads its "
                       "samples from a JSON annotation file, and none is set")
    return cls(ann_file=split_cfg["annfile"], root=data_cfg["data_root"],
               transform=transform,
               use_right_disp=split_cfg.get("use_right_disp", False))
