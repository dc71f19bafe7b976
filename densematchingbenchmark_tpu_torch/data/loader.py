"""Batched data loading with background prefetch.

Counterpart of densematchingbenchmark_tpu/data/loader.py:22-89: worker
threads load and transform samples, batches are collated as stacked
float32 numpy arrays (each from one aspect group, given ``group_flags``),
and a small queue keeps the next batches ready while the device trains.
Each sample's transform generator is ``default_rng((seed, epoch, index))``,
so any batch is reproducible on its own and a resumed epoch replays the
same batches; a shard (``num_shards``, ``shard_id``: one per process)
loads its slice of every global batch, each sample as the one-process run
loads it. A sample that fails to load raises in the consumer instead
of leaving it waiting.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .sampler import EpochSampler, GroupedEpochSampler

_BATCH_KEYS = ("leftImage", "rightImage", "leftDisp", "rightDisp", "flow")


def collate(samples):
    batch = {}
    for k in _BATCH_KEYS:
        if samples[0].get(k) is not None:
            batch[k] = np.stack([s[k] for s in samples]).astype(np.float32)
    batch["original_size"] = samples[0]["original_size"]
    return batch


class DataLoader:
    def __init__(self, dataset, global_batch, seed=0, num_workers=4,
                 prefetch=2, group_flags=None, num_shards=1, shard_id=0):
        self.dataset = dataset
        shards = dict(num_shards=num_shards, shard_id=shard_id)
        self.sampler = (
            EpochSampler(len(dataset), global_batch, seed, **shards)
            if group_flags is None else
            GroupedEpochSampler(len(dataset), global_batch, group_flags,
                                seed, **shards))
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch

    def steps_per_epoch(self):
        return self.sampler.steps_per_epoch()

    def _load_one(self, epoch, idx):
        rng = np.random.default_rng((self.seed, epoch, int(idx)))
        return self.dataset.__getitem__(int(idx), rng=rng)

    def epoch(self, epoch, start=0):
        """Yield collated batches of one epoch, skipping the first
        ``start`` without loading them (exact mid-epoch resume: the index
        schedule is a function of (seed, epoch) alone)."""
        indices = self.sampler.epoch_indices(epoch)[start:]
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for step_idx in indices:
                        if stop.is_set():
                            return
                        q.put(collate(list(pool.map(
                            lambda i: self._load_one(epoch, i), step_idx))))
                q.put(None)
            except Exception as e:      # raised in the consumer, not lost
                q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            while thread.is_alive():    # unblock a producer waiting on put
                try:
                    q.get_nowait()
                except queue.Empty:
                    thread.join(0.01)
