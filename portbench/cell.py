"""A run's context: the cell's configuration and traffic, the seed, the
device, the run's scratch directory and its tracer; the model built
through the port's entry point with the benchmark's seeded weights, and
the seeded scenes."""

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import scenes
from .weights import load_into, seeded_state


@dataclasses.dataclass
class Context:
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    tmpdir: str
    tracer: object
    phases: dict = dataclasses.field(default_factory=dict)
    last: float = dataclasses.field(default_factory=time.perf_counter)

    def mark(self, name):
        """Close set-up phase ``name``: its seconds since the last mark."""
        now = time.perf_counter()
        self.phases[name] = now - self.last
        self.last = now

    @property
    def port_config(self):
        return self.config["port_configs"][self.traffic["dataset"]]

    def init_model(self):
        """(the port's StereoModel from ``apis.init_model``, the weights
        the benchmark drew and loaded into it)."""
        from densematchingbenchmark_tpu_torch.apis import init_model
        model = init_model(self.port_config, device=self.device,
                           seed=self.seed,
                           **self.config.get("port_overrides", {}))
        weights = seeded_state(model.module, self.seed, self.device)
        load_into(model.module, weights)
        return model, weights

    def scenes(self, n, each=None, workers=8):
        """Scenes 0 .. n - 1 of this seed, drawn in a thread pool; with
        ``each``, ``each(i, scene)`` is called on every one there too."""
        t = self.traffic
        h, w = t["frame"]
        lo, hi = t["disparity"]

        def one(i):
            s = scenes.scene((self.seed, i), h, w, lo, hi,
                             t.get("gt_density", 0.3),
                             t.get("horizon", 0.35))
            if each is not None:
                each(i, s)
            return s

        with ThreadPoolExecutor(workers) as pool:
            return list(pool.map(one, range(n)))

    def rng(self, *tag):
        """A numpy generator of this seed for the purpose ``tag``."""
        return np.random.default_rng((self.seed, *tag))
