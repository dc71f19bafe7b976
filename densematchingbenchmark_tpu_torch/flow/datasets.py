"""Flow datasets: FlyingChairs (JSON or YAML annotations) and a
procedural one with exact flow.

Counterpart of densematchingbenchmark_tpu/flow/datasets.py: FlyingChairs
items name 'left_image_path' / 'right_image_path' (frames t and t + 1) and
'flow_map_path' (or the reference's 'flow_path') relative to a data root.
Its frames are PPM files, which data/io.load_image reads with the port's
own decoder.
"""

import json
import os.path as osp

import numpy as np

from ..data.io import load_image
from .io import load_flo


class FlyingChairsDataset:
    name = "FlyingChairs"

    def __init__(self, ann_file, root, transform=None):
        self.root = root
        if ann_file.endswith((".yaml", ".yml")):
            import yaml
            with open(ann_file) as fp:
                self.data_list = yaml.safe_load(fp)
        else:
            with open(ann_file) as fp:
                self.data_list = json.load(fp)
        self.transform = transform

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, idx, rng=None):
        item = self.data_list[idx]
        sample = {
            "leftImage": load_image(osp.join(self.root,
                                             item["left_image_path"])),
            "rightImage": load_image(osp.join(self.root,
                                              item["right_image_path"])),
        }
        sample["original_size"] = sample["leftImage"].shape[:2]
        # the reference's annotations spell it 'flow_path'; both are read
        flow_path = item.get("flow_map_path") or item.get("flow_path")
        if flow_path:
            sample["flow"] = load_flo(osp.join(self.root, flow_path))
        if self.transform is not None:
            sample = self.transform(sample, rng)
        return sample


class SyntheticFlowDataset:
    """Procedural image pairs with exact ground-truth flow (the flow
    counterpart of data.datasets.SyntheticStereoDataset).

    The second frame is a random smooth texture; the first frame is built
    from it by an exact backward warp with a piecewise-constant integer
    flow field (constant per vertical band), so
    leftImage[y, x] = rightImage[y + v(y,x), x + u(y,x)] holds exactly.
    """

    name = "SyntheticFlow"

    def __init__(self, length=16, height=128, width=256, max_flow=8,
                 transform=None, seed=0):
        self.length = length
        self.h, self.w, self.max_flow = height, width, max_flow
        self.transform = transform
        self.seed = seed

    def __len__(self):
        return self.length

    def load(self, idx):
        rng = np.random.default_rng(self.seed * 99991 + idx)
        h, w, m = self.h, self.w, self.max_flow
        tgt = rng.random((h + 2 * m, w + 2 * m, 3)).astype(np.float32)
        for _ in range(2):
            tgt = (tgt + np.roll(tgt, 1, 1) + np.roll(tgt, -1, 1) +
                   np.roll(tgt, 1, 0) + np.roll(tgt, -1, 0)) / 5.0
        tgt *= 255.0
        n_bands = 4
        edges = np.sort(rng.integers(1, w - 1, n_bands - 1))
        us = rng.integers(-m, m + 1, n_bands)
        vs = rng.integers(-m, m + 1, n_bands)
        flow = np.zeros((h, w, 2), np.float32)
        start = 0
        for e, u, v in zip(list(edges) + [w], us, vs):
            flow[:, start:e, 0] = float(u)
            flow[:, start:e, 1] = float(v)
            start = e
        ys = np.arange(h)[:, None] + flow[..., 1].astype(np.int64) + m
        xs = np.arange(w)[None, :] + flow[..., 0].astype(np.int64) + m
        ref = tgt[ys, xs]
        return {
            "leftImage": ref,
            "rightImage": tgt[m:m + h, m:m + w],
            "flow": flow,
            "original_size": (h, w),
        }

    def __getitem__(self, idx, rng=None):
        sample = self.load(idx)
        if self.transform is not None:
            sample = self.transform(sample, rng)
        return sample
