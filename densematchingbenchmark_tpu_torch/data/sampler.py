"""Deterministic epoch-seeded sampling.

Counterpart of densematchingbenchmark_tpu/data/sampler.py:15-42 on one
host, shuffled: permute with a generator seeded from (seed, epoch), then
pad the index list by wrapping to a multiple of the global batch. Sharding
across hosts waits for data parallelism (ROADMAP.md queue 1 item 5); the
aspect-grouped sampler arrives with the file datasets.
"""

import numpy as np


class EpochSampler:
    def __init__(self, dataset_len, global_batch, seed=0):
        self.n = dataset_len
        self.global_batch = global_batch
        self.seed = seed

    def epoch_indices(self, epoch):
        """[steps, global_batch] index array."""
        rng = np.random.default_rng(self.seed * 1000003 + epoch)
        idx = rng.permutation(self.n)
        total = self.steps_per_epoch() * self.global_batch
        if total > self.n:  # wrap-around padding (reference behavior)
            idx = np.concatenate([idx, idx[:total - self.n]])
        return idx.reshape(-1, self.global_batch)

    def steps_per_epoch(self):
        return int(np.ceil(self.n / self.global_batch))
