"""The evaluation loop: batched forward and metrics on the device, one
fetch at the end.

Counterpart of densematchingbenchmark_tpu/evaluation/eval_loop.py:22-181:
- samples are loaded ahead by worker threads, in order; a sample that fails
  to load fails the evaluation;
- batches are bucketed by padded sample shape, so a dataset of mixed sizes
  never mixes shapes in a batch;
- metrics are per-sample vectors (``calc_error(per_sample=True)``), so a
  batched evaluation averages exactly as a batch-1 loop does;
- the dataset is sharded by stride (``num_shards``, ``shard_id``); the
  caller combines the shards (``format.combine_shard_metrics``).

Per batch the host copies the collated arrays into pinned memory and on to
the device with ``non_blocking=True`` (a copy from pageable memory would
wait for all the work queued before it), runs the forward and the metrics
under ``torch.inference_mode()`` and keeps the metric tensors on the
device; nothing in a batch waits for the device. The host reads every
batch's metrics in one fetch after the last batch.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data.loader import collate
from .metrics import calc_error, calc_error_with_occlusion


def _prefetch_samples(dataset, indices, workers=4, depth=8):
    """Ordered sample iterator with a bounded look-ahead window, so that
    decoding and transforming samples overlaps the device's work."""
    q = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item):
        # never park forever on a full queue: the consumer may have left
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        with ThreadPoolExecutor(workers) as pool:
            pending = []
            try:
                for i in indices:
                    pending.append(pool.submit(dataset.__getitem__, i))
                    if len(pending) >= depth:
                        if not put(("ok", pending.pop(0).result())):
                            return
                for f in pending:
                    if not put(("ok", f.result())):
                        return
            except Exception as exc:   # raised in the consumer, not lost
                put(("err", exc))
                return
            finally:
                for f in pending:
                    f.cancel()
            put(None)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            kind, payload = item
            if kind == "err":
                # averaging over a truncated sample set would give
                # plausible but wrong metrics
                raise payload
            yield payload
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def make_eval_metrics_step(model, lb, ub, eval_disparity_ids=(0,),
                           eval_occlusion=False, occ_compat_warp=False):
    """step(batch) -> {disp_id: {metric: [B] tensor}} for one batch of
    tensors on ``model``'s device; the forward runs under inference mode
    with the module in its current mode (``evaluate`` sets eval)."""

    def step(batch):
        with torch.inference_mode():
            out = model(batch["leftImage"], batch["rightImage"])
            result = {}
            for did in eval_disparity_ids:
                if did >= len(out["disps"]):
                    continue
                est = out["disps"][did]
                m = calc_error(est, batch["leftDisp"], lb=lb, ub=ub,
                               per_sample=True)
                if eval_occlusion and "rightDisp" in batch:
                    m.update(calc_error_with_occlusion(
                        est, batch["leftDisp"], batch["rightDisp"], lb, ub,
                        per_sample=True, compat_grid_sample=occ_compat_warp))
                result[did] = m
        return result

    return step


def to_device(batch, device):
    """Collated numpy arrays -> tensors on ``device``; to a GPU through
    pinned memory, without waiting for the device."""
    out = {}
    for k, v in batch.items():
        if k == "original_size":
            continue
        t = torch.from_numpy(v)
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def eval_batches(model, dataset, eval_cfg, eval_disparity_ids=(0,),
                 batch_size=None, num_shards=1, shard_id=0, step=None):
    """Dispatch the evaluation of (a shard of) ``dataset`` batch by batch
    and fetch nothing. Returns ([(device result, samples)], samples)."""
    if step is None:
        step = make_eval_metrics_step(
            model, eval_cfg.get("lower_bound", 0),
            eval_cfg.get("upper_bound", 192), eval_disparity_ids,
            eval_cfg.get("eval_occlusion", False),
            eval_cfg.get("occ_compat_warp", False))
    if batch_size is None:
        batch_size = int(eval_cfg.get("batch_size", 1))
    device = next(model.parameters()).device
    pending, count = [], 0

    def run_batch(samples):
        nonlocal count
        pending.append((step(to_device(collate(samples), device)),
                        len(samples)))
        count += len(samples)

    buckets = {}
    indices = range(shard_id, len(dataset), num_shards)
    for s in _prefetch_samples(dataset, indices):
        key = (s["leftImage"].shape, s.get("leftDisp") is not None,
               s.get("rightDisp") is not None)
        buckets.setdefault(key, []).append(s)
        if len(buckets[key]) >= batch_size:
            run_batch(buckets.pop(key))
    for samples in buckets.values():
        run_batch(samples)
    return pending, count


def average_metrics(pending, count):
    """Fetch every batch's metric vectors in one copy to the host and
    average them over the samples: {f'disp_{id}/{metric}': float}."""
    leaves = [v for result, _ in pending for m in result.values()
              for v in m.values()]
    if not leaves:
        return {}
    host = torch.cat([v.reshape(-1) for v in leaves]).cpu().numpy()
    sums, pos = {}, 0
    for result, n in pending:
        for did, m in result.items():
            for k in m:
                key = f"disp_{did}/{k}"
                sums[key] = sums.get(key, 0.0) + float(np.sum(host[pos:pos
                                                                   + n]))
                pos += n
    return {k: v / max(count, 1) for k, v in sums.items()}


def evaluate(model, dataset, eval_cfg, eval_disparity_ids=(0,),
             batch_size=None, num_shards=1, shard_id=0, step=None):
    """Evaluate ``model`` (a module on its device) over (a shard of)
    ``dataset``; returns ({f'disp_{id}/{metric}': mean over samples},
    samples).

    ``batch_size`` defaults to eval_cfg['batch_size'] (else 1); each padded
    shape fills its own bucket, flushed when full and once more at its
    natural size at the end. Pass a prebuilt ``step``
    (make_eval_metrics_step) when calling repeatedly. The module runs in
    eval mode and is left in the mode it came in.
    """
    was_training = model.training
    model.eval()
    try:
        pending, count = eval_batches(model, dataset, eval_cfg,
                                      eval_disparity_ids, batch_size,
                                      num_shards, shard_id, step)
    finally:
        model.train(was_training)
    return average_metrics(pending, count), count
