"""The ranks of the port's D-sharded cost-volume CPU tests, run as a script
so that a rank imports torch and the port only (no JAX):

    python tests/torch_dsharding_ranks.py grid OUT_DIR RANK WORLD PORT [CASE ...]

runs the CASES named (all by default), as one rank of a gloo group of
WORLD 4 on PORT laid out as a (2, 2) (data, model) grid, or with WORLD 1
(and any PORT) as the one-process reference, and writes
OUT_DIR/grid<RANK>.pt (tests/test_torch_dsharding.py):

- 'aggregator': the eval costs of a PSMAggregator (``psm_aggregator``) on
  this rank's rows and planes of D of a seeded raw volume, gathered;
- for each of FAMILIES, in float64: one eval forward and one train step
  of the tiny model (its cost volume split along D over the model axis
  where the builder splits it) on this rank's data shard of the global
  batch; the loss entries, the gradients the optimizer got, the
  parameters and BN statistics after the step, the disparities, the raw
  volume's shape as the cost processor built it, and the collectives of
  each;
- 'planes': each volume type's planes built on this rank for a range
  that does not start at 0 (and a dilated one);
- 'train_matcher': trainer.loop.train_matcher on the tiny StereoNet with
  ``use_volume_sharding``, one step and the per-epoch eval of EVAL_LEN
  samples: its logged records and (rank 0) the eval's sample count.

    python tests/torch_dsharding_ranks.py collectives OUT_DIR RANK 3 PORT

runs the D-axis collectives over a (1, 3) grid, D = 8 split 3, 3, 2, with
their dense counterparts computed on every rank, and writes
OUT_DIR/coll<RANK>.pt.
"""

import contextlib
import glob
import os
import re
import sys

import numpy as np
import torch
import torch.nn.functional as F

from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.losses import make_loss_evaluator
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.parallel import (
    collectives, init_distributed, make_mesh, shard_batch,
    shutdown_distributed)
from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                      build_optimizer,
                                                      make_train_step)
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

from torch_parallel_ranks import ACF_TINY, PSM_TINY, randomize

GRID = (2, 2)
GLOBAL = 2          # one sample a data index
EVAL_LEN = 3
# JAX's test_packed_psm_aggregator_under_d_sharding: raw [2, 16, 16, 8, 64]
AGG_MAX_DISP = 64
AGG_SHAPE = (2, AGG_MAX_DISP // 4, 16, 8, 64)
GC = {"model.max_disp": 32,
      "model.cost_processor.cost_computation.max_disp": 16,
      "model.cost_processor.cost_aggregator.max_disp": 32,
      "model.disp_predictor.max_disp": 32,
      "model.losses.l1_loss.max_disp": 32, "optimizer.lr": 1e-3}
SN = {"model.max_disp": 32,
      "model.cost_processor.cost_computation.max_disp": 4,
      "model.disp_predictor.max_disp": 4,
      "model.losses.l1_loss.max_disp": 32,
      "model.backbone.residual_num": 2, "optimizer.lr": 1e-3}
# family: (config, overrides, frame (H, W), disparity range of the GT)
FAMILIES = {
    "psmnet": ("PSMNet/scene_flow_f32", PSM_TINY, (32, 64), 16),
    "acfnet": ("AcfNet/scene_flow_adaptive_f32", ACF_TINY, (32, 64), 16),
    "gcnet": ("GCNet/scene_flow_f32", GC, (32, 64), 32),
    "stereonet": ("StereoNet/scene_flow_8x_2stage_f32", SN, (32, 64), 32),
    "anynet": ("AnyNet/scene_flow_f32", {"optimizer.lr": 1e-3}, (32, 64),
               64),
}


def counts():
    return {"kinds": collectives.collective_counts(),
            "bytes": collectives.collective_bytes(),
            "d_axis": collectives.d_axis_counts()}


def psm_aggregator(mesh=None, seed=0):
    """The PSMAggregator of JAX's D-sharding test (max_disp 64, low-res
    costs) with random BN statistics: (module, the weights as a numpy Flax
    tree)."""
    from densematchingbenchmark_tpu_torch.models.aggregators.psmnet import (
        PSMAggregator)
    from densematchingbenchmark_tpu_torch.models.layers import (
        init_parameters)
    from densematchingbenchmark_tpu_torch.parallel.mesh import (
        batch_only_volume_sharding, cost_volume_sharding)
    kw = {}
    if mesh is not None:
        kw = dict(volume_sharding=cost_volume_sharding(mesh),
                  strided_sharding=batch_only_volume_sharding(mesh))
    agg = PSMAggregator(64, AGG_MAX_DISP, return_low_res=True, **kw)
    init_parameters(agg, torch.Generator().manual_seed(seed))
    variables = randomize(flax_variables(agg), np.random.RandomState(seed))
    load_jax_variables(agg, variables)
    return agg.eval(), variables


def agg_input():
    return (np.random.RandomState(0).randn(*AGG_SHAPE) * 0.2).astype(
        np.float32)


def aggregator_case(mesh):
    from densematchingbenchmark_tpu_torch.parallel.collectives import (
        d_planes)
    agg, _ = psm_aggregator(mesh)
    raw = shard_batch(mesh, {"raw": torch.from_numpy(agg_input())})["raw"]
    lo, hi = d_planes(raw.shape[1], mesh) if mesh.n_model > 1 else \
        (0, raw.shape[1])
    collectives.reset_collective_counts()
    with torch.no_grad():
        costs = agg(raw[:, lo:hi].contiguous(), size=raw.shape[1])
    return {"costs": [c.clone() for c in costs], "counts": counts()}


def family_batch(family, mesh, dtype):
    _, _, (h, w), max_disp = FAMILIES[family]
    rng = np.random.RandomState(1)
    data = {"leftImage": rng.randn(GLOBAL, h, w, 3),
            "rightImage": rng.randn(GLOBAL, h, w, 3)}
    drop = np.zeros((GLOBAL, h, w, 1), bool)
    drop[GLOBAL // 2:] = rng.rand(GLOBAL - GLOBAL // 2, h, w, 1) < 0.7
    disp = rng.uniform(-1, max_disp + 2, (GLOBAL, h, w, 1))
    data["leftDisp"] = np.where(drop, 0.0, disp)
    return {k: torch.from_numpy(v).to(dtype)
            for k, v in shard_batch(mesh, data).items()}


@contextlib.contextmanager
def float64_casts():
    """The port's float32 casts (``Tensor.float``: BN statistics, the
    soft-argmin, the losses) made float64 within it."""
    real = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = real


def family_model(family, mesh, dtype):
    """The tiny model of ``family`` on ``mesh`` (its volume split where
    the builder splits it), random BN statistics and biases, in
    ``dtype`` (float64: its parameters and compute dtype)."""
    name, over, _, _ = FAMILIES[family]
    cfg = get_config(name, **over)
    module = build_model(cfg, torch.Generator().manual_seed(0),
                         mesh=mesh if mesh.n_model > 1 else None)
    load_jax_variables(module, randomize(flax_variables(module),
                                         np.random.RandomState(0)))
    if dtype == torch.float64:
        for m in module.modules():
            if getattr(m, "dtype", None) == torch.float32:
                m.dtype = dtype
        module.double()
    return cfg, module


def family_case(family, mesh, dtype=torch.float64, perturb_seed=None):
    """One eval forward, then one train step of ``family`` on this rank,
    by default in float64: the whole arithmetic of the D split and of the
    grid's reductions, without float32's reordering noise (which the tiny
    models amplify to 1e-3 - 2e-2 of their largest gradient, as a 1e-7
    perturbation of their weights does: tests/dsharding_noise_study.py,
    which passes ``perturb_seed``)."""
    casts = float64_casts() if dtype == torch.float64 else \
        contextlib.nullcontext()
    with casts:
        cfg, module = family_model(family, mesh, dtype)
        if perturb_seed is not None:
            g = torch.Generator().manual_seed(perturb_seed)
            with torch.no_grad():
                for p in module.parameters():
                    p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g,
                                                  dtype=p.dtype))
        shapes = []
        cp = getattr(module, "cost_processor", None)
        if cp is not None:
            build = cp.volume

            def recording(*args, **kwargs):
                vol = build(*args, **kwargs)
                shapes.append(tuple(vol.shape))
                return vol
            cp.volume = recording
        batch = family_batch(family, mesh, dtype)
        module.eval()
        collectives.reset_collective_counts()
        with torch.no_grad():
            out = module(batch["leftImage"], batch["rightImage"])
        eval_counts = counts()
        opt, _ = build_optimizer(cfg, module, 10)
        names = [n for n, _ in module.named_parameters()]
        seen = {}
        real_step = opt.step

        def recording_step(grads, grad_norm):
            seen.update(zip(names, (g.clone() for g in grads)))
            return real_step(grads, grad_norm)
        opt.step = recording_step
        state = TrainState.create(module, opt, seed=1)
        step = make_train_step(make_loss_evaluator(
            cfg["model"]["losses"],
            cmn_losses_cfg=cfg["model"].get("cmn", {}).get("losses")))
        collectives.reset_collective_counts()
        _, metrics = step(state, batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": seen,
            "params": {n: p.detach().clone()
                       for n, p in module.named_parameters()},
            "buffers": {n: b.clone() for n, b in module.named_buffers()},
            "disps": [d.clone() for d in out["disps"]],
            "raw_shapes": shapes,
            "train_counts": counts(), "eval_counts": eval_counts}


def planes_case(mesh):
    """Each volume type's planes on this rank for (max_disp, start_disp,
    dilation) ranges that do not start at 0, through the cost processor."""
    from densematchingbenchmark_tpu_torch.models.cost_processors import (
        CostProcessor)
    from densematchingbenchmark_tpu_torch.parallel.mesh import (
        cost_volume_sharding)
    g = torch.Generator().manual_seed(5)
    ref, tgt = torch.randn(2, 1, 3, 12, 4, generator=g)
    out = {}

    def keep(raw, size=None):
        return raw, size
    for kind in ("concatenation", "difference", "correlation"):
        for rng in ((6, 3, 1), (9, -2, 2)):
            cp = CostProcessor(keep, kind, *rng,
                               volume_sharding=cost_volume_sharding(mesh))
            out[kind, rng] = cp(ref, tgt)
    return out


def matcher_case(mesh, out_dir, rank):
    """train_matcher on the tiny StereoNet with its volume split: one
    step at GLOBAL, then the per-epoch eval of EVAL_LEN samples."""
    from densematchingbenchmark_tpu_torch.data import (
        SyntheticStereoDataset, transforms)
    from densematchingbenchmark_tpu_torch.trainer import train_matcher
    from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics
    name, over, hw, max_disp = FAMILIES["stereonet"]
    cfg = get_config(name, **over, **{
        "data.batch_size_per_device": GLOBAL // mesh.n_data,
        "lr_schedule.warmup_iters": 0, "model.eval.upper_bound": max_disp})
    cfg["vis"] = {"enabled": False}
    data = cfg["data"]
    make = lambda n, seed, size, tf: SyntheticStereoDataset(  # noqa: E731
        length=n, height=size[0], width=size[1], max_disp=max_disp - 8,
        seed=seed, transform=tf(hw, data["mean"], data["std"]))
    train = make(GLOBAL, 0, (hw[0] + 8, hw[1] + 16),
                 transforms.make_train_transform)
    evals = make(EVAL_LEN, 1, hw, transforms.make_eval_transform)
    work = os.path.join(out_dir, f"work{rank}")
    collectives.reset_collective_counts()
    train_matcher(cfg, work, train_dataset=train, eval_dataset=evals,
                  max_steps=1, log_interval=1, device="cpu", mesh=mesh,
                  use_volume_sharding=True)
    res = {"counts": counts()}
    if rank == 0:
        res["records"] = read_metrics(work)
        text = "".join(open(p).read() for p in glob.glob(
            os.path.join(work, "**", "*_log.txt"), recursive=True))
        res["eval_samples"] = [int(n) for n in
                               re.findall(r"eval \((\d+) samples\)", text)]
        res["mesh_logged"] = "mesh: {'data': %d, 'model': %d}" % (
            mesh.n_data, mesh.n_model) in text
    return res


CASES = ("aggregator", "planes", *FAMILIES, "train_matcher")


def grid(out_dir, rank, world, port, cases=CASES):
    if world > 1:
        init_distributed(coordinator=f"localhost:{port}",
                         num_processes=world, process_id=rank, device="cpu")
    mesh = make_mesh(GRID if world > 1 else None)
    out = {"mesh": (mesh.data_index, mesh.model_index)}
    for case in cases:
        if case == "aggregator":
            out[case] = aggregator_case(mesh)
        elif case == "planes":
            out[case] = planes_case(mesh) if world > 1 else None
        elif case == "train_matcher":
            out[case] = matcher_case(mesh, out_dir, rank)
        else:
            out[case] = family_case(case, mesh)
    shutdown_distributed()
    torch.save(out, os.path.join(out_dir, f"grid{rank}.pt"))


# the collectives' case: [B, D, H, W, C] with D = COLL_D over 3 ranks
COLL_SHAPE = (2, 8, 3, 2, 4)


def coll(out_dir, rank, world, port):
    """halo_exchange (widths 1 and 2), gather_d and shard_d on this rank's
    planes, forward and backward, each beside its dense counterpart:
    every rank draws every rank's cotangent, so that each computes the
    dense gradient of the ranks' summed losses."""
    from densematchingbenchmark_tpu_torch.parallel.collectives import (
        d_bounds, gather_d, halo_exchange, shard_d)
    init_distributed(coordinator=f"localhost:{port}", num_processes=world,
                     process_id=rank, device="cpu")
    mesh = make_mesh((1, world))
    g = torch.Generator().manual_seed(7)
    full = torch.randn(COLL_SHAPE, generator=g)
    size = full.shape[1]
    bounds = d_bounds(size, world)
    lo, hi = bounds[rank]
    out = {"bounds": bounds}
    collectives.reset_collective_counts()

    def cotangents(shape_of):
        return [torch.randn(shape_of(r), generator=g) for r in range(world)]

    for width in (1, 2):
        x = full[:, lo:hi].clone().requires_grad_(True)
        y = halo_exchange(x, mesh, width)
        w = cotangents(lambda r: (2, bounds[r][1] - bounds[r][0]
                                  + 2 * width, 3, 2, 4))
        (gx,) = torch.autograd.grad((y * w[rank]).sum(), x)
        xf = full.clone().requires_grad_(True)
        padded = F.pad(xf.movedim(1, -1), (width, width)).movedim(-1, 1)
        dense = sum((padded[:, a:b + 2 * width] * w[r]).sum()
                    for r, (a, b) in enumerate(bounds))
        (gf,) = torch.autograd.grad(dense, xf)
        out[f"halo{width}"] = (y.detach(), padded.detach()[:, lo:hi
                                                           + 2 * width],
                               gx, gf[:, lo:hi])
    x = full[:, lo:hi].clone().requires_grad_(True)
    y = gather_d(x, mesh, size)
    v = cotangents(lambda r: COLL_SHAPE)
    (gx,) = torch.autograd.grad((y * v[rank]).sum(), x)
    out["gather"] = (y.detach(), full, gx, sum(v)[:, lo:hi])
    xf = full.clone().requires_grad_(True)
    y = shard_d(xf, mesh, 1)
    u = cotangents(lambda r: (2, bounds[r][1] - bounds[r][0] + 2, 3, 2, 4))
    (gx,) = torch.autograd.grad((y * u[rank]).sum(), xf)
    xd = full.clone().requires_grad_(True)
    padded = F.pad(xd.movedim(1, -1), (1, 1)).movedim(-1, 1)
    (gd,) = torch.autograd.grad((padded[:, lo:hi + 2] * u[rank]).sum(), xd)
    out["shard"] = (y.detach(), padded.detach()[:, lo:hi + 2], gx, gd)
    out["counts"] = counts()
    shutdown_distributed()
    torch.save(out, os.path.join(out_dir, f"coll{rank}.pt"))


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, out_dir, rank, world, port = sys.argv[1:6]
    if mode == "grid":
        grid(out_dir, int(rank), int(world), int(port),
             sys.argv[6:] or CASES)
    else:
        coll(out_dir, int(rank), int(world), int(port))
