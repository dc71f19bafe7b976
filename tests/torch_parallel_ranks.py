"""The ranks of the port's data-parallel CPU tests, run as a script so
that a rank imports torch and the port only (no JAX):

    python tests/torch_parallel_ranks.py steps OUT_DIR RANK WORLD PORT BATCH [FAMILY ...]

takes one train step of tiny models (all of FAMILIES by default) at a
global batch of BATCH as one rank of a gloo group on PORT, or with WORLD
1 (and any PORT) as the one-process reference, and writes
OUT_DIR/rank<RANK>.pt, {family: {metrics, grads, params, buffers},
'collectives': counts} (tests/test_torch_parallel_train.py,
tests/test_torch_train_step.py);

    python tests/torch_parallel_ranks.py checks OUT_DIR RANK 2 PORT ROOT ANN1 ANN3

runs the group checks of tests/test_torch_parallel.py on ports PORT,
PORT + 1 and PORT + 2 (tools/test.main over the KITTI-layout files of
ANN3 and of ANN1, whose one sample leaves rank 1's shard empty; then
``global_sum``, a BatchNorm in training, the PatchMatch noise, the
collectives) and writes OUT_DIR/checks<RANK>.pt;

    python tests/torch_parallel_ranks.py card OUT_DIR RANK WORLD PORT DTYPE

trains a small PSMNet (``card_train``) on cuda:0 through train_matcher,
as one rank of a gloo group (every rank on the one card) or alone with
WORLD 1, and writes OUT_DIR/card<WORLD>_<RANK>.pt (tests/test_torch_cuda.py).

Every family's weights are the seeded tree with every BatchNorm's
parameters and statistics and every conv bias drawn at random (as
tests/acfnet_parity.randomize), its data a global batch drawn from a
seed; a rank takes its contiguous slice of it. The ground
truth of the batch's two halves has different valid counts: the second
half's disparities (flows) are mostly invalid, so a mean of the ranks'
local masked means would differ from the global masked mean.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.losses import make_loss_evaluator
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.parallel import init_distributed
from densematchingbenchmark_tpu_torch.parallel import collectives
from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                      build_optimizer,
                                                      make_train_step)
from densematchingbenchmark_tpu_torch.trainer.train_step import (
    make_flow_train_step)
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.abspath(__file__)
GLOBAL_BATCH = 4
M = 16
PSM_TINY = {"model.max_disp": M,
            "model.cost_processor.cost_computation.max_disp": M // 4,
            "model.cost_processor.cost_aggregator.max_disp": M,
            "model.disp_predictor.max_disp": M,
            "model.losses.l1_loss.max_disp": M,
            "optimizer.lr": 1e-3}
ACF_TINY = dict(PSM_TINY, **{"model.losses.focal_loss.max_disp": M,
                             "model.eval.upper_bound": M,
                             "model.cmn.in_planes": M,
                             "model.cmn.losses.nll_loss.max_disp": M})
DP_TINY = {"model.max_disp": 64, "model.disp_sampler.iterations": 1,
           "model.losses.l1_loss.max_disp": 64,
           "model.losses.quantile_loss.max_disp": 64}
PWC_TINY = {"model.chans": (8, 16, 16), "model.radius": 2,
            "model.hidden": 16,
            "model.losses.flow_l1_loss.weights": (1.0, 1.0, 0.5, 0.25)}
# family: (config, overrides, frame (H, W), disparity range of the GT)
FAMILIES = {
    "psmnet": ("PSMNet/scene_flow_f32", PSM_TINY, (32, 64), M),
    "acfnet": ("AcfNet/scene_flow_adaptive_f32", ACF_TINY, (32, 64), M),
    "deeppruner": ("DeepPruner/scene_flow_4x_f32", DP_TINY, (32, 64), 64),
    "pwcflow": ("PWCFlow/flying_chairs_f32", PWC_TINY, (32, 64), None),
}


def _free(port):
    with socket.socket() as s:
        try:
            s.bind(("localhost", port))
        except OSError:
            return False
    return True


def free_port(n=1):
    """A port p with p .. p + n - 1 free on localhost."""
    while True:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        if port + n < 65536 and all(_free(port + i) for i in range(1, n)):
            return port


def start_ranks(argvs, envs=None):
    """One ``python argv`` process each, from the repository's root, with
    it on the path, one OpenMP thread and its env of ``envs`` added."""
    path = os.environ.get("PYTHONPATH", "")
    base = {**os.environ, "OMP_NUM_THREADS": "1",
            "PYTHONPATH": ROOT + (os.pathsep + path if path else "")}
    return [subprocess.Popen([sys.executable, *argv], cwd=ROOT,
                             env={**base, **(env or {})},
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for argv, env in zip(argvs, envs or [None] * len(argvs))]


def finish_ranks(procs, timeout=300):
    """Wait for ``procs``; any left at ``timeout`` are killed, and a
    process that failed raises with its output's end."""
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{p.args} exited {p.returncode}:\n"
                                 + out[-3000:])
    return outs


def randomize(variables, rng):
    """Numpy copy of a Flax tree with every BatchNorm's scale / bias /
    mean / var and every conv bias drawn at random: BN scale in [0.7,
    1.1], var in [0.9, 1.4], bias and mean ~ 0.1 N(0, 1)."""
    def walk(tree, parent):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
            elif parent == "BatchNorm_0" and k == "scale":
                out[k] = rng.uniform(0.7, 1.1, v.shape).astype(np.float32)
            elif parent == "BatchNorm_0" and k == "var":
                out[k] = rng.uniform(0.9, 1.4, v.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.array(v)
        return out
    return walk(variables, None)


def family_model(family, seed=0):
    """(config, module with randomized weights, the weights as a numpy
    Flax tree) of ``family``."""
    name, over, _, _ = FAMILIES[family]
    cfg = get_config(name, **over)
    module = build_model(cfg, torch.Generator().manual_seed(seed))
    variables = randomize(flax_variables(module), np.random.RandomState(seed))
    load_jax_variables(module, variables)
    return cfg, module, variables


def global_batch(family, seed=1, b=GLOBAL_BATCH):
    """The family's global batch (numpy): images [b, H, W, 3]
    and 'leftDisp' [.., 1] (stereo) or 'flow' [.., 2]. In the second half
    of the batch about 70 % of the GT is invalid (0 disparity; NaN flow),
    in the first half a few percent (disparities outside (0, max))."""
    _, _, (h, w), max_disp = FAMILIES[family]
    rng = np.random.RandomState(seed)
    out = {"leftImage": rng.randn(b, h, w, 3).astype(np.float32),
           "rightImage": rng.randn(b, h, w, 3).astype(np.float32)}
    drop = np.zeros((b, h, w, 1), bool)
    drop[b // 2:] = rng.rand(b - b // 2, h, w, 1) < 0.7
    if max_disp is None:
        flow = rng.uniform(-3, 3, (b, h, w, 2)).astype(np.float32)
        out["flow"] = np.where(drop, np.nan, flow).astype(np.float32)
    else:
        disp = rng.uniform(-1, max_disp + 2, (b, h, w, 1))
        out["leftDisp"] = np.where(drop, 0.0, disp).astype(np.float32)
    return out


def train_step(family, rank=0, world=1, b=GLOBAL_BATCH):
    """One train step of ``family`` on this rank's slice of the global
    batch of ``b``: {'metrics', 'grads' (the gradients the optimizer got,
    by parameter name), 'params', 'buffers' (after the step)}."""
    cfg, module, _ = family_model(family)
    data = global_batch(family, b=b)
    per = b // world
    batch = {k: torch.from_numpy(v[rank * per:(rank + 1) * per])
             for k, v in data.items()}
    opt, _ = build_optimizer(cfg, module, 10)
    names = [n for n, _ in module.named_parameters()]
    seen = {}
    real_step = opt.step

    def recording_step(grads, grad_norm):
        seen.update(zip(names, (g.clone() for g in grads)))
        return real_step(grads, grad_norm)
    opt.step = recording_step
    state = TrainState.create(module, opt, seed=1)
    if family == "pwcflow":
        step = make_flow_train_step(
            tuple(cfg["model"]["losses"]["flow_l1_loss"]["weights"]))
    else:
        step = make_train_step(make_loss_evaluator(
            cfg["model"]["losses"],
            cmn_losses_cfg=cfg["model"].get("cmn", {}).get("losses")))
    _, metrics = step(state, batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": seen,
            "params": {n: p.detach().clone()
                       for n, p in module.named_parameters()},
            "buffers": {n: b.clone() for n, b in module.named_buffers()}}


def steps(out_dir, rank, world, port, b, families):
    if world > 1:
        init_distributed(coordinator=f"localhost:{port}",
                         num_processes=world, process_id=rank, device="cpu")
    collectives.reset_collective_counts()
    results = {f: train_step(f, rank, world, b) for f in families}
    results["collectives"] = collectives.collective_counts()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


# tools/test.main's tiny PSMNet over 32x64-padded KITTI frames
TEST_OVERRIDES = [f"{k}={v}" for k, v in PSM_TINY.items()
                  if k.startswith("model.") and "losses" not in k] + [
    f"model.eval.upper_bound={M}", "data.test.input_shape=(32, 64)",
    "data.test.use_right_disp=True", "model.eval.batch_size=3"]


def tool_test_args(root, ann, work_dir):
    return ["--config", "PSMNet/kitti_2015_f32", "--work-dir", work_dir,
            "--data-root", root, "--annfile", ann, "--cpu",
            "--override", *TEST_OVERRIDES]


def bn_check(rank, world):
    """A BatchNorm in training on this rank's rows of a global [4, 3, 5, 6]
    batch: its output, the gradient of sum(y * w) to its input and to its
    weight (summed over the ranks), and its running statistics; and
    torch's one-process batch norm of the global batch for reference."""
    from densematchingbenchmark_tpu_torch.models.layers import BatchNorm
    g = torch.Generator().manual_seed(4)
    x = torch.randn(4, 3, 5, 6, generator=g) * 2.0 + 3.0
    w = torch.randn(4, 3, 5, 6, generator=g)
    bn = BatchNorm(3, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        bn.weight.uniform_(0.7, 1.1, generator=g)
        bn.bias.normal_(0.0, 0.1, generator=g)
    ref_w, ref_b = bn.weight.detach().clone(), bn.bias.detach().clone()
    per = 4 // world
    xr = x[rank * per:(rank + 1) * per].clone().requires_grad_(True)
    y = bn(xr)
    gx, gw = torch.autograd.grad((y * w[rank * per:(rank + 1) * per]).sum(),
                                 [xr, bn.weight])
    gw = collectives.all_reduce_grads([gw])[0]
    xf = x.clone().requires_grad_(True)
    wf = ref_w.clone().requires_grad_(True)
    yf = torch.native_batch_norm(xf, wf, ref_b, None, None, True, 0.0,
                                 1e-5)[0]
    rgx, rgw = torch.autograd.grad((yf * w).sum(), [xf, wf])
    return {"y": y.detach(), "grad_x": gx, "grad_w": gw,
            "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(),
            "ref_y": yf.detach()[rank * per:(rank + 1) * per],
            "ref_grad_x": rgx[rank * per:(rank + 1) * per], "ref_grad_w": rgw,
            "x": x}


def checks(out_dir, rank, world, port, root, ann1, ann3):
    from densematchingbenchmark_tpu_torch.evaluation.format import (
        combine_shard_metrics)
    from densematchingbenchmark_tpu_torch.ops.patch_match import train_noise
    from densematchingbenchmark_tpu_torch.parallel import (
        broadcast_module, shutdown_distributed)
    from densematchingbenchmark_tpu_torch.tools import test as ttest
    out = {}
    flags = ["--num-processes", str(world), "--process-id", str(rank)]
    for i, (name, ann) in enumerate((("three", ann3), ("one", ann1))):
        work = os.path.join(out_dir, f"work{rank}")
        out[name] = ttest.main(tool_test_args(root, ann, work) + [
            "--coordinator", f"localhost:{port + i}", *flags])
    init_distributed(coordinator=f"localhost:{port + 2}",
                     num_processes=world, process_id=rank, device="cpu")
    collectives.reset_collective_counts()
    # one shard empty: rank 1 has no samples and no keys
    out["combined_empty"] = combine_shard_metrics(
        *(({"disp_0/epe": 2.0, "disp_0/3px": 10.0}, 3) if rank == 0
          else ({}, 0)))
    out["combined"] = combine_shard_metrics(
        {"disp_0/epe": 1.0 + rank, "disp_1/epe": 5.0}, 1 + rank)
    t = torch.tensor([1.0, 2.0 * (rank + 1)], requires_grad=True)
    s = collectives.global_sum(t)
    (g,) = torch.autograd.grad((s * torch.tensor([1.0, 3.0])).sum(), t)
    out["global_sum"] = (s.detach(), g)
    out["bn"] = bn_check(rank, world)
    out["noise"] = train_noise(2, 3, 4, 5, torch.Generator().manual_seed(3))
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(float(rank))
    broadcast_module(module)
    out["broadcast"] = module.weight.detach().clone()
    out["grads"] = collectives.all_reduce_grads(
        [torch.full((2, 2), float(rank + 1)), torch.full((3,), 1.0)])
    out["collectives"] = collectives.collective_counts()
    shutdown_distributed()
    torch.save(out, os.path.join(out_dir, f"checks{rank}.pt"))


# the card's pair: a small PSMNet on 64x128 crops, a global batch of 4
CARD_SMALL = {"model.max_disp": 32,
              "model.cost_processor.cost_computation.max_disp": 8,
              "model.cost_processor.cost_aggregator.max_disp": 32,
              "model.disp_predictor.max_disp": 32,
              "model.losses.l1_loss.max_disp": 32}
CARD_STEPS = 2


def card_train(out_dir, rank, world, port, dtype):
    """train_matcher on the small PSMNet/scene_flow_<dtype> for CARD_STEPS
    steps on cuda:0 at batch_size_per_device 4 / WORLD: its parameters, BN
    statistics, the first step's gradients (summed over the ranks) and BN
    statistics, launch and collective counts and (rank 0) losses."""
    import tempfile

    from densematchingbenchmark_tpu_torch.data import (
        SyntheticStereoDataset, transforms)
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.parallel import (
        shutdown_distributed)
    from densematchingbenchmark_tpu_torch.trainer import train_matcher
    from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics
    if world > 1:
        init_distributed(coordinator=f"localhost:{port}",
                         num_processes=world, process_id=rank,
                         device="cuda:0", backend="gloo")
    cfg = get_config(f"PSMNet/scene_flow_{dtype}", **CARD_SMALL, **{
        "data.batch_size_per_device": 4 // world,
        "lr_schedule.warmup_iters": 0})
    cfg["vis"] = {"enabled": False}
    data = cfg["data"]
    ds = SyntheticStereoDataset(
        length=4 * CARD_STEPS, height=96, width=192, max_disp=24,
        transform=transforms.make_train_transform((64, 128), data["mean"],
                                                  data["std"]))
    from densematchingbenchmark_tpu_torch.trainer import optim, train_step
    first = {}
    real = optim._Optimizer.step, train_step.apply_losses

    def step(self, grads, grad_norm=None):       # the gradients it gets
        first.setdefault("grads", [g.detach().float().cpu() for g in grads])
        return real[0](self, grads, grad_norm)

    def apply_losses(state, loss_dict):          # the BN statistics after
        out = real[1](state, loss_dict)
        first.setdefault("buffers", {n: b.detach().cpu().clone() for n, b
                                     in state.module.named_buffers()})
        return out
    optim._Optimizer.step, train_step.apply_losses = step, apply_losses
    with tempfile.TemporaryDirectory() as work:
        kernels.reset_launch_counts()
        collectives.reset_collective_counts()
        state = train_matcher(cfg, work, train_dataset=ds,
                              max_steps=CARD_STEPS, log_interval=1,
                              device="cuda:0")
        torch.cuda.synchronize()
        records = read_metrics(work) if rank == 0 else []
    torch.save({"params": {n: p.detach().cpu()
                           for n, p in state.module.named_parameters()},
                "buffers": {n: b.cpu()
                            for n, b in state.module.named_buffers()},
                "launches": kernels.launch_counts(),
                "bf16_launches": kernels.bf16_launch_counts(),
                "collectives": collectives.collective_counts(),
                "first": first,
                "losses": [r["train/loss"] for r in records]},
               os.path.join(out_dir, f"card{world}_{rank}.pt"))
    shutdown_distributed()


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, out_dir, rank, world = sys.argv[1:5]
    rest = sys.argv[5:]
    if mode == "steps":
        steps(out_dir, int(rank), int(world), int(rest[0]), int(rest[1]),
              rest[2:] or list(FAMILIES))
    elif mode == "card":
        card_train(out_dir, int(rank), int(world), int(rest[0]), rest[1])
    else:
        checks(out_dir, int(rank), int(world), int(rest[0]), *rest[1:])
