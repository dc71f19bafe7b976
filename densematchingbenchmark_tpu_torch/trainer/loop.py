"""End-to-end training loop: train_matcher.

Counterpart of densematchingbenchmark_tpu/trainer/loop.py:27-239 on one
device: the loader prefetches host batches (aspect-grouped with
``data.group_sampling``), every step is one ``make_train_step`` call,
metrics go to the text log and to <work_dir>/metrics.log.json, and a
checkpoint at the end of every epoch (or at ``max_steps``) records the
exact (epoch, batch_in_epoch) position, so ``resume=True`` replays the same
remaining batches. After each epoch's checkpoint the eval set, if any, is
evaluated and its metrics logged under 'eval/', and the visualization hook
(trainer/vis_hook.py, unless ``vis.enabled`` is False) writes its panels.
``profile_steps`` traces a window of steps with torch.profiler. A flow
config (``task`` "flow") runs the same loop with the flow task's batch
keys, train step, evaluation and vis hook (flow/trainer.flow_task).

In a process group (parallel.init_distributed) each rank trains on its
device, as one cell of a (data, model) grid (``mesh``,
parallel/mesh.make_mesh; by default every rank on the data axis): the
global batch is ``batch_size_per_device`` times the grid's data size, the
loader gives each data index its slice of every global batch (the model
ranks of one data index load the same samples), the model starts from
rank 0's weights (``broadcast_module``), and the step computes the global
batch's BN statistics, losses and gradient (JAX loop.py:37-39, 59-75,
113, 145, 218-219). With ``use_volume_sharding`` the model's cost volume
is split along D over the model axis (models/builder.py). Rank 0 alone
writes the logs and the checkpoints, and of the vis panels' forwards,
which the model ranks of data index 0 run together; each data index
evaluates its stride shard of the eval set and the shards are combined,
each counted once.
"""

import functools
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
from ..parallel import collectives
from ..parallel.mesh import make_mesh
from ..utils.checkpoint import CheckpointManager
from ..utils.collect_env import collect_env_info, device_memory_stats
from ..utils.logging import MetricsLogger, get_logger
from .optim import build_optimizer
from .state import TrainState
from .train_step import make_train_step
from .vis_hook import VisHook, build_vis_dataset


def stereo_task(cfg, work_dir, metrics_log, eval_dataset, vis_dataset, *,
                mesh):
    """The stereo pieces of ``train_matcher``: (batch keys, train step,
    eval callable module -> (metric dict, its log text) or None, vis hook
    or None). The vis set is ``vis_dataset``, else build_vis_dataset's.
    On a grid of processes (``mesh``) the eval runs this data index's
    stride shard and combines the shards, those of model index 0 alone
    counted; the ranks of data index 0 have a vis hook, and rank 0's alone
    writes."""
    data_cfg = cfg["data"]
    evaluator = make_loss_evaluator(
        cfg["model"]["losses"], sparse=data_cfg.get("sparse", False),
        cmn_losses_cfg=cfg["model"].get("cmn", {}).get("losses"))
    run_eval = None
    if eval_dataset is not None:
        eval_cfg = cfg["model"].get("eval", {})
        eval_ids = tuple(cfg.get("eval_disparity_id", (0,)))

        def run_eval(module):
            metrics, count = evaluate(
                module, eval_dataset, eval_cfg, eval_ids,
                num_shards=mesh.n_data, shard_id=mesh.data_index)
            # the model ranks of a data index evaluated the same samples
            results, n = combine_shard_metrics(
                metrics, count if mesh.model_index == 0 else 0)
            return results, f"eval ({n} samples):\n" + metrics_table(results)
    vis_hook = None
    if cfg.get("vis", {}).get("enabled", True) and mesh.data_index == 0:
        vis_dataset = vis_dataset or build_vis_dataset(cfg, eval_dataset)
        if vis_dataset is not None:
            vis_hook = VisHook(
                vis_dataset, work_dir, metrics_log, data_cfg["mean"],
                data_cfg["std"], max_disp=cfg["model"].get("max_disp", 192),
                max_samples=cfg.get("vis", {}).get("max_samples", 4),
                write=collectives.rank() == 0)
    return (("leftImage", "rightImage", "leftDisp"),
            make_train_step(evaluator), run_eval, vis_hook)


def train_matcher(cfg, work_dir, train_dataset=None, eval_dataset=None,
                  vis_dataset=None, resume=False, log_interval=10,
                  max_steps=None, device=None, profile_steps=None, mesh=None,
                  use_volume_sharding=False):
    """Train a model per config on one device, or on each rank's in a
    process group; returns the TrainState.

    ``mesh``: the (data, model) grid of the group (make_mesh, which every
    rank calls first), by default every rank on the data axis;
    ``use_volume_sharding``: split the cost volume along D over its model
    axis (JAX's argument: AnyNet, DeepPruner and flow models run whole on
    every model rank either way).

    Runs on ``cuda`` (in a group the rank's device) unless ``device`` says
    otherwise; with no GPU and no device given it raises. The logged
    metrics of a step are 'loss', each loss entry ('l1_loss_lvl<i>', and
    for AcfNet 'stereo_focal_loss_lvl<i>' and 'conf_loss_lvl<i>'),
    'grad_norm',
    'throughput' (samples/s), 'lr', 'step_ms' (host clock around the step,
    ended by reading its metrics) and, on a GPU, 'peak_mem_gib' (the
    device's peak allocated of utils.collect_env.device_memory_stats; the
    text log adds its reserved memory). The environment (utils.collect_env.collect_env_info: the
    card's name and power limit first) is logged at the start.
    ``eval_dataset`` defaults to the file dataset of data.eval.annfile,
    when that is set; its metrics are logged after every epoch as
    'eval/disp_<id>/<metric>'. A flow config
    logs 'flow_loss_lvl<i>' and 'eval/<metric>' (epe, 1px, 2px, 3px, 5px),
    needs ``train_dataset`` and builds no default eval set.

    profile_steps: optional (start, stop) global step numbers; a
    torch.profiler trace of those steps (the host's and, on a GPU, the
    device's activity) is written to <work_dir>/profile as a Chrome trace.
    """
    device = resolve_device(device)
    if device.type == "cuda":
        # float32 configs compute in float32, as init_model sets
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = collectives.rank(), collectives.world_size()
    logger = get_logger(work_dir, rank=rank)
    metrics_log = MetricsLogger(work_dir, rank=rank)
    logger.info("environment:\n" + collect_env_info())

    data_cfg = cfg["data"]
    mean, std = data_cfg["mean"], data_cfg["std"]
    flow = cfg.get("task") == "flow"
    if flow and train_dataset is None:
        raise ValueError("a flow config needs a train_dataset (FlyingChairs "
                         "or synthetic)")
    if train_dataset is None:
        train_dataset = build_dataset(
            data_cfg, "train",
            transform=transforms.make_train_transform(
                data_cfg["train"]["input_shape"], mean, std))
    if eval_dataset is None and not flow and \
            data_cfg.get("type") != "Synthetic" and \
            data_cfg.get("eval", {}).get("annfile"):
        eval_dataset = build_dataset(
            data_cfg, "eval",
            transform=transforms.make_eval_transform(
                data_cfg["eval"]["input_shape"], mean, std))
    mesh = mesh or make_mesh()
    global_batch = data_cfg.get("batch_size_per_device", 1) * mesh.n_data
    seed = cfg.get("seed", 0)
    loader = DataLoader(train_dataset, global_batch, seed=seed,
                        group_flags=(aspect_group_flags(train_dataset)
                                     if data_cfg.get("group_sampling")
                                     else None),
                        num_shards=mesh.n_data, shard_id=mesh.data_index)
    steps_per_epoch = loader.steps_per_epoch()

    module = build_model(cfg, torch.Generator().manual_seed(seed),
                         mesh=mesh if use_volume_sharding else None)
    module.to(device)
    optimizer, schedule = build_optimizer(cfg, module, steps_per_epoch)
    if flow:
        from ..flow.trainer import flow_task as make_task
    else:
        make_task = functools.partial(stereo_task, mesh=mesh)
    keys, step_fn, run_eval, vis_hook = make_task(
        cfg, work_dir, metrics_log, eval_dataset, vis_dataset)
    state = TrainState.create(module, optimizer, seed + 1)
    n_params = sum(p.numel() for p in module.parameters())
    logger.info(f"model params: {n_params / 1e6:.3f}M, device: {device}, "
                f"processes: {world}, mesh: {mesh.shape}, volume sharding: "
                f"{bool(use_volume_sharding)}, global batch: {global_batch}, "
                f"steps/epoch: {steps_per_epoch}")

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
    # every rank starts from rank 0's parameters and BN statistics
    collectives.broadcast_module(module)
    prof_start, prof_stop = profile_steps or (None, None)
    prof_dir = os.path.join(work_dir, "profile")
    profiler = None

    def stop_profiler(last_step):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        profiler.stop()
        os.makedirs(prof_dir, exist_ok=True)
        path = os.path.join(prof_dir,
                            f"steps_{prof_start}_{last_step}.pt.trace.json")
        profiler.export_chrome_trace(path)
        logger.info(f"profiler trace of steps {prof_start}..{last_step} -> "
                    f"{path}")

    def device_batches(epoch, start):
        for batch in loader.epoch(epoch, start=start):
            yield {k: torch.from_numpy(batch[k]).to(device, non_blocking=True)
                   for k in keys}

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
            if step_num == prof_start and profiler is None:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            state, metrics = step_fn(state, batch)
            if profiler is not None and step_num >= prof_stop:
                stop_profiler(step_num)
                profiler = prof_start = None
            if step_num % log_interval == 0 or step_num == 1:
                metrics = {k: float(v) for k, v in metrics.items()}
                t2 = time.perf_counter()
                t_data, t_step = t1 - t0, t2 - t1
                fps = global_batch / max(t_step, 1e-9)
                metrics.update(throughput=fps, lr=schedule(step_num),
                               step_ms=t_step * 1e3)
                mem_str = ""
                if device.type == "cuda":
                    index = (torch.cuda.current_device()
                             if device.index is None else device.index)
                    mem = device_memory_stats()[f"cuda:{index}"]
                    peak = mem["peak_allocated"] / 2 ** 30
                    metrics["peak_mem_gib"] = peak
                    mem_str = (f" mem {peak:.1f}GiB (reserved "
                               f"{mem['reserved'] / 2 ** 30:.1f}GiB)")
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
        if run_eval is not None:
            results, text = run_eval(module)
            logger.info(f"epoch {epoch + 1} {text}")
            metrics_log.log(state.step, results, prefix="eval/")
        if vis_hook is not None:
            vis_hook(module, epoch + 1)
            logger.info(f"epoch {epoch + 1} visualization -> "
                        f"{os.path.join(work_dir, 'vis')}")
        if done:
            break
    if profiler is not None:     # the window ran past the last step
        stop_profiler(state.step)
    metrics_log.close()
    return state


def read_metrics(work_dir):
    """The records of <work_dir>/metrics.log.json, in order."""
    with open(os.path.join(work_dir, "metrics.log.json")) as fp:
        return [json.loads(line) for line in fp if line.strip()]
