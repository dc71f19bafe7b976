"""Deterministic epoch-seeded sampling, plain and aspect-grouped, sharded
over processes.

Counterpart of densematchingbenchmark_tpu/data/sampler.py:15-112,
shuffled: permute with a generator seeded from (seed, epoch), pad the
index list by wrapping to a multiple of the global batch, and give shard
``shard_id`` of ``num_shards`` its contiguous slice of every global batch.
Every shard of a step is equally large, and the shards of a step together
are the one-process run's batch of that step.
"""

import logging

import numpy as np


class EpochSampler:
    def __init__(self, dataset_len, global_batch, seed=0, num_shards=1,
                 shard_id=0):
        if global_batch % num_shards or not 0 <= shard_id < num_shards:
            raise ValueError(f"shard {shard_id} of {num_shards} of a "
                             f"global batch of {global_batch}")
        self.n = dataset_len
        self.global_batch = global_batch
        self.seed = seed
        self.per_shard = global_batch // num_shards
        self.shard_id = shard_id

    def _shard(self, batches):
        lo = self.shard_id * self.per_shard
        return batches[:, lo:lo + self.per_shard]

    def epoch_indices(self, epoch):
        """[steps, global_batch / num_shards] index array of this shard."""
        rng = np.random.default_rng(self.seed * 1000003 + epoch)
        idx = rng.permutation(self.n)
        total = self.steps_per_epoch() * self.global_batch
        if total > self.n:  # wrap-around padding (reference behavior)
            idx = np.concatenate([idx, idx[:total - self.n]])
        return self._shard(idx.reshape(-1, self.global_batch))

    def steps_per_epoch(self):
        return int(np.ceil(self.n / self.global_batch))


class GroupedEpochSampler(EpochSampler):
    """Every batch is drawn from one aspect group (``flags``, e.g.
    ``aspect_group_flags``), so a mixed-size dataset never pads a batch
    across shapes. Per epoch: shuffle within each group, wrap-pad each group
    to a multiple of the global batch, chunk it into batches, then shuffle
    the order of the batches."""

    def __init__(self, dataset_len, global_batch, flags, seed=0,
                 num_shards=1, shard_id=0):
        super().__init__(dataset_len, global_batch, seed, num_shards,
                         shard_id)
        flags = np.asarray(flags, np.int64)
        if flags.shape != (dataset_len,):
            raise ValueError(f"flags of shape {flags.shape} for "
                             f"{dataset_len} samples")
        self.flags = flags
        self._steps = sum(int(np.ceil(c / global_batch))
                          for c in np.bincount(flags) if c > 0)

    def epoch_indices(self, epoch):
        rng = np.random.default_rng(self.seed * 1000003 + epoch)
        batches = []
        for g in np.unique(self.flags):
            idx = rng.permutation(np.where(self.flags == g)[0])
            total = int(np.ceil(len(idx) / self.global_batch)) \
                * self.global_batch
            if total > len(idx):
                idx = np.concatenate([idx, idx[:total - len(idx)]])
            batches.append(idx.reshape(-1, self.global_batch))
        batches = np.concatenate(batches, axis=0)
        return self._shard(batches[rng.permutation(len(batches))])

    def steps_per_epoch(self):
        return self._steps


def aspect_group_flags(dataset):
    """flag[i] = 1 if width > height else 0. Reads the sizes from the
    annotation list when every entry has 'height' and 'width'; otherwise
    groups every sample by sample 0's original_size (and warns)."""
    items = getattr(dataset, "data_list", None)
    n = len(dataset)
    if items and all("height" in it and "width" in it for it in items):
        return np.asarray(
            [1 if it["width"] > it["height"] else 0 for it in items],
            np.int64)
    h, w = dataset.__getitem__(0, rng=np.random.default_rng(0))[
        "original_size"]
    if n > 1:
        logging.getLogger("dmb_torch").warning(
            "aspect_group_flags: annotations carry no per-item height/width; "
            "grouping all %d samples by sample 0's aspect (%dx%d). A "
            "mixed-size dataset will NOT be aspect-grouped: add "
            "height/width to the annotation entries.", n, h, w)
    return np.full(n, 1 if w > h else 0, np.int64)
