"""End-to-end training loop: train_matcher.

Counterpart of densematchingbenchmark_tpu/trainer/loop.py:27-239 on one
device: the loader prefetches host batches (aspect-grouped with
``data.group_sampling``), every step is one ``make_train_step`` call,
metrics go to the text log and to <work_dir>/metrics.log.json, and a
checkpoint at the end of every epoch (or at ``max_steps``) records the
exact (epoch, batch_in_epoch) position, so ``resume=True`` replays the same
remaining batches. After each epoch's checkpoint the eval set, if any, is
evaluated and its metrics logged under 'eval/'. The visualization hook, the
profiler window and data parallelism arrive with ROADMAP.md queue 1 items 3
and 5.
"""

import json
import os
import time

import torch

from ..apis import resolve_device
from ..data import DataLoader, aspect_group_flags, build_dataset, transforms
from ..evaluation.eval_loop import evaluate
from ..evaluation.format import combine_shard_metrics, metrics_table
from ..losses import make_loss_evaluator
from ..models import build_model
from ..utils.checkpoint import CheckpointManager
from ..utils.logging import MetricsLogger, get_logger
from .optim import build_optimizer
from .state import TrainState
from .train_step import make_train_step


def train_matcher(cfg, work_dir, train_dataset=None, eval_dataset=None,
                  resume=False, log_interval=10, max_steps=None, device=None):
    """Train a model per config on one device; returns the TrainState.

    Runs on ``cuda`` unless ``device`` says otherwise; with no GPU and no
    device given it raises. The logged metrics of a step are 'loss', each
    'l1_loss_lvl<i>', 'grad_norm', 'throughput' (samples/s), 'lr',
    'step_ms' (host clock around the step, ended by reading its metrics)
    and, on a GPU, 'peak_mem_gib' (torch.cuda.max_memory_allocated).
    ``eval_dataset`` defaults to the file dataset of data.eval.annfile,
    when that is set; its metrics are logged after every epoch as
    'eval/disp_<id>/<metric>'.
    """
    device = resolve_device(device)
    if device.type == "cuda":
        # float32 configs compute in float32, as init_model sets
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    logger = get_logger(work_dir)
    metrics_log = MetricsLogger(work_dir)

    data_cfg = cfg["data"]
    mean, std = data_cfg["mean"], data_cfg["std"]
    if train_dataset is None:
        train_dataset = build_dataset(
            data_cfg, "train",
            transform=transforms.make_train_transform(
                data_cfg["train"]["input_shape"], mean, std))
    if eval_dataset is None and data_cfg.get("type") != "Synthetic" and \
            data_cfg.get("eval", {}).get("annfile"):
        eval_dataset = build_dataset(
            data_cfg, "eval",
            transform=transforms.make_eval_transform(
                data_cfg["eval"]["input_shape"], mean, std))
    global_batch = data_cfg.get("batch_size_per_device", 1)
    seed = cfg.get("seed", 0)
    loader = DataLoader(train_dataset, global_batch, seed=seed,
                        group_flags=(aspect_group_flags(train_dataset)
                                     if data_cfg.get("group_sampling")
                                     else None))
    steps_per_epoch = loader.steps_per_epoch()

    module = build_model(cfg, torch.Generator().manual_seed(seed))
    module.to(device)
    optimizer, schedule = build_optimizer(cfg, module, steps_per_epoch)
    evaluator = make_loss_evaluator(cfg["model"]["losses"],
                                    sparse=data_cfg.get("sparse", False))
    state = TrainState.create(module, optimizer, seed + 1)
    n_params = sum(p.numel() for p in module.parameters())
    logger.info(f"model params: {n_params / 1e6:.3f}M, device: {device}, "
                f"global batch: {global_batch}, steps/epoch: "
                f"{steps_per_epoch}")

    ckpt = CheckpointManager(work_dir)
    start_epoch = start_batch = 0
    if resume:
        saved, meta = ckpt.restore()
        if saved is not None:
            state.load_state_dict(saved)
            start_epoch = (meta or {}).get("epoch", 0)
            start_batch = (meta or {}).get("batch_in_epoch", 0)
            logger.info(f"resumed from step {state.step} (epoch "
                        f"{start_epoch}, batch {start_batch})")
    step_fn = make_train_step(evaluator)
    eval_cfg = cfg["model"].get("eval", {})
    eval_ids = tuple(cfg.get("eval_disparity_id", (0,)))

    def device_batches(epoch, start):
        for batch in loader.epoch(epoch, start=start):
            yield {k: torch.from_numpy(batch[k]).to(device, non_blocking=True)
                   for k in ("leftImage", "rightImage", "leftDisp")}

    total_epochs = cfg.get("total_epochs", 10)
    done = False
    for epoch in range(start_epoch, total_epochs):
        t0 = time.perf_counter()
        offset = start_batch if epoch == start_epoch else 0
        batch_in_epoch = offset
        for batch in device_batches(epoch, offset):
            batch_in_epoch += 1
            t1 = time.perf_counter()
            step_num = state.step + 1
            state, metrics = step_fn(state, batch)
            if step_num % log_interval == 0 or step_num == 1:
                metrics = {k: float(v) for k, v in metrics.items()}
                t2 = time.perf_counter()
                t_data, t_step = t1 - t0, t2 - t1
                fps = global_batch / max(t_step, 1e-9)
                metrics.update(throughput=fps, lr=schedule(step_num),
                               step_ms=t_step * 1e3)
                mem_str = ""
                if device.type == "cuda":
                    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
                    metrics["peak_mem_gib"] = peak
                    mem_str = f" mem {peak:.1f}GiB"
                logger.info(
                    f"epoch {epoch + 1}/{total_epochs} step {step_num} "
                    f"lr {metrics['lr']:.2e} loss {metrics['loss']:.4f} "
                    f"grad_norm {metrics['grad_norm']:.3f} "
                    f"data {t_data * 1e3:.0f}ms step {t_step * 1e3:.0f}ms "
                    f"({fps:.1f} samples/s){mem_str}")
                metrics_log.log(step_num, metrics, prefix="train/")
            t0 = time.perf_counter()
            if max_steps is not None and step_num >= max_steps:
                done = True
                break

        if cfg.get("checkpoint", {}).get("interval"):
            # a completed epoch records the next epoch at batch 0; a stop
            # inside one records where it stopped
            completed = batch_in_epoch >= steps_per_epoch
            ckpt.save(state.step, state.state_dict(),
                      metadata=({"epoch": epoch + 1, "batch_in_epoch": 0}
                                if completed else
                                {"epoch": epoch,
                                 "batch_in_epoch": batch_in_epoch}))
        if eval_dataset is not None:
            results, n = combine_shard_metrics(*evaluate(
                module, eval_dataset, eval_cfg, eval_ids))
            logger.info(f"epoch {epoch + 1} eval ({n} samples):\n"
                        + metrics_table(results))
            metrics_log.log(state.step, results, prefix="eval/")
        if done:
            break
    return state


def read_metrics(work_dir):
    """The records of <work_dir>/metrics.log.json, in order."""
    with open(os.path.join(work_dir, "metrics.log.json")) as fp:
        return [json.loads(line) for line in fp if line.strip()]
