"""Stereo datasets: the synthetic fixture with exact ground truth.

Counterpart of densematchingbenchmark_tpu/data/datasets.py:77-178. No
dataset ships with the repository, so the port's training runs on
``SyntheticStereoDataset``, whose samples are bit-exact with the JAX
package's (the same numpy generator and arithmetic). The JSON-annotated
file datasets (SceneFlow, KITTI) raise NotImplementedError until the
evaluation slice (ROADMAP.md queue 1 item 4).
"""

import numpy as np


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


def build_dataset(data_cfg, split, transform=None):
    """data_cfg: cfg['data']; split: 'train' | 'eval' | 'test'."""
    if data_cfg["type"] != "Synthetic":
        raise NotImplementedError(
            f"{data_cfg['type']} file datasets are not ported yet (ROADMAP.md "
            "queue 1 item 4); pass a SyntheticStereoDataset")
    split_cfg = data_cfg.get(split, {})
    return SyntheticStereoDataset(
        transform=transform,
        **{k: v for k, v in split_cfg.items()
           if k in ("length", "height", "width", "max_disp", "seed")})
