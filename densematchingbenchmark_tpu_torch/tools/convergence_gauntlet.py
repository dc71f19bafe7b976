"""Synthetic convergence gauntlet for the whole model zoo.

    python -m densematchingbenchmark_tpu_torch.tools.convergence_gauntlet \\
        [--families PSMNet ...] [--steps 300] [--out results.json] [--cpu]

Counterpart of the repository's tools/convergence_gauntlet.py:38-305.
Each family's shipped loss path (PSMNet, GCNet and StereoNet's
multi-scale smooth-L1, AcfNet's cmn and focal losses, DeepPruner's
quantile loss through PatchMatch, AnyNet's SPN, both flow families'
sequence losses) is trained on the exact-GT synthetic streams
(data.SyntheticStereoDataset, flow.SyntheticFlowDataset) at a reduced
resolution with the shipped config's losses, optimizer and schedules,
and the held-out end-point error is scored against a per-family
threshold. The families, configs and thresholds are the JAX tool's
(STEREO_FAMILIES, FLOW_FAMILIES): a config name without ``_f32`` /
``_bf16`` computes in bfloat16 on a GPU and in float32 on the CPU, as
there (``DMB_DEFAULT_DTYPE`` sets it).

``main`` prints the card's line, one JSON line a family (a family that
raises is recorded with its ``error``, and the next one runs) and
``N/M families under threshold``; it asserts nothing. ``--cpu`` runs the
plain PyTorch versions on the CPU; without a GPU and without it, it
raises. ``overfit=True`` (the CPU test's mode) repeats the first batch
every step and scores that batch.
"""

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_config
from ..data import DataLoader, SyntheticStereoDataset, transforms
from ..flow import SyntheticFlowDataset, build_flow_model
from ..flow import transforms as flow_transforms
from ..losses import make_loss_evaluator
from ..models import build_model
from ..trainer import (TrainState, build_optimizer, make_flow_train_step,
                       make_train_step)
from ..utils.collect_env import card_line
from .common import add_cpu_arg, float32_device, tool_device

# (family, config name, config overrides, EPE threshold after 300 steps),
# the JAX tool's table (tools/convergence_gauntlet.py:44-58): PSMNet,
# AcfNet-adaptive, StereoNet-2stage, AnyNet and DeepPruner-4x pinned at
# 1.5x an EPE measured there; the others provisional, never pinned.
STEREO_FAMILIES = [
    ("PSMNet", "PSMNet/scene_flow", {}, 10.3),
    ("AcfNet-adaptive", "AcfNet/scene_flow_adaptive", {}, 28.6),
    ("AcfNet-uniform", "AcfNet/scene_flow_uniform", {}, 28.6),  # provisional
    ("GCNet", "GCNet/scene_flow", {}, 30.0),  # provisional
    ("StereoNet-2stage", "StereoNet/scene_flow_8x_2stage", {}, 2.5),
    ("StereoNet-4stage", "StereoNet/scene_flow_8x_4stage", {},
     2.5),  # provisional
    ("AnyNet", "AnyNet/scene_flow", {}, 17.8),
    ("DeepPruner-4x", "DeepPruner/scene_flow_4x", {}, 19.5),
    ("DeepPruner-8x", "DeepPruner/scene_flow_8x", {}, 19.5),  # provisional
]
FLOW_FAMILIES = [
    ("PWCFlow", "PWCFlow/flying_chairs", {}, 2.5),  # provisional
    ("RAFT", "RAFT/flying_chairs", {}, 2.0),  # provisional
]

STEREO_KEYS = ("leftImage", "rightImage", "leftDisp")
FLOW_KEYS = ("leftImage", "rightImage", "flow")


def _config(config_name, overrides):
    """(cfg, its name): a config name with ``overrides``, or a config dict
    as it is."""
    if isinstance(config_name, dict):
        return config_name, str(config_name.get("name", "<inline-cfg>"))
    return get_config(config_name, **(overrides or {})), config_name


def _stereo_data(cfg, crop_hw, gen_hw, gen_max_disp, train_len, eval_len,
                 batch, seed):
    """(train loader, eval dataset) of the synthetic stereo stream."""
    mean, std = cfg["data"]["mean"], cfg["data"]["std"]
    train_ds = SyntheticStereoDataset(
        length=train_len, height=gen_hw[0], width=gen_hw[1],
        max_disp=gen_max_disp, seed=seed,
        transform=transforms.make_train_transform(crop_hw, mean, std))
    eval_ds = SyntheticStereoDataset(
        length=eval_len, height=crop_hw[0], width=crop_hw[1],
        max_disp=gen_max_disp, seed=seed + 7,
        transform=transforms.make_eval_transform(crop_hw, mean, std))
    return DataLoader(train_ds, batch, seed=seed), eval_ds


def _flow_data(cfg, crop_hw, gen_hw, max_flow, train_len, eval_len, batch,
               seed):
    """(train loader, eval dataset) of the synthetic flow stream."""
    mean, std = cfg["data"]["mean"], cfg["data"]["std"]
    train_ds = SyntheticFlowDataset(
        length=train_len, height=gen_hw[0], width=gen_hw[1],
        max_flow=max_flow, seed=seed,
        transform=flow_transforms.make_train_transform(crop_hw, mean, std))
    eval_ds = SyntheticFlowDataset(
        length=eval_len, height=crop_hw[0], width=crop_hw[1],
        max_flow=max_flow, seed=seed + 7,
        transform=flow_transforms.make_eval_transform(crop_hw, mean, std))
    return DataLoader(train_ds, batch, seed=seed), eval_ds


def _errors(pred, gt, out_key):
    """Per-pixel end-point errors (numpy): a disparity's over the pixels
    with GT above 0, a flow's L2 over every pixel."""
    if out_key == "disps":
        return np.abs(pred[..., 0] - gt[..., 0])[gt[..., 0] > 0]
    return np.sqrt(((pred - gt) ** 2).sum(-1)).reshape(-1)


def _epe(forward_fn, eval_ds, out_key="disps"):
    """Mean EPE of the best output over the full eval set, the mean of
    each sample's mean. ``forward_fn(left, right)``: numpy [1, H, W, 3]
    frames -> the prediction as a numpy array."""
    errs = []
    gt_key = "leftDisp" if out_key == "disps" else "flow"
    for i in range(len(eval_ds)):
        s = eval_ds.__getitem__(i, rng=np.random.default_rng(i))
        pred = np.asarray(forward_fn(s["leftImage"][None],
                                     s["rightImage"][None])).astype(
                                         np.float32)
        errs.append(float(_errors(pred, s[gt_key][None], out_key).mean()))
    return float(np.mean(errs))


def _to_device(batch, keys, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if k in keys}


def _drive(loader, step, state, steps, log_every, keys, overfit, device):
    """``steps`` train steps over the loader's epochs (with ``overfit``,
    its first batch every step); the loss is read at steps 1, ``steps``
    and every ``log_every``-th. Returns (state, [(step, loss)], the first
    batch on the device or None)."""
    losses, done = [], 0
    fixed = None
    while done < steps:
        for batch_data in loader.epoch(done // max(
                1, loader.steps_per_epoch())):
            batch_dev = _to_device(batch_data, keys, device)
            if overfit:
                fixed = fixed if fixed is not None else batch_dev
                batch_dev = fixed
            state, metrics = step(state, batch_dev)
            done += 1
            if done % log_every == 0 or done in (1, steps):
                losses.append((done, float(metrics["loss"])))
            if done >= steps:
                break
    return state, losses, fixed


def _first_batch(loader, keys, device):
    """The loader's first batch of epoch 0, on the device."""
    batches = loader.epoch(0)
    try:
        return _to_device(next(batches), keys, device)
    finally:
        batches.close()


def _train_and_score(module, cfg, step, loader, eval_ds, keys, out_key,
                     steps, log_every, overfit, seed, device):
    """Train ``module`` (on ``device``) from a fresh optimizer state and
    score it before and after: (epe_init, epe_final, losses, seconds)."""
    optimizer, _ = build_optimizer(cfg, module,
                                   max(1, loader.steps_per_epoch()))
    state = TrainState.create(module, optimizer, seed + 1)

    def forward(left, right):
        module.eval()
        with torch.no_grad():
            out = module(torch.as_tensor(left, device=device),
                         torch.as_tensor(right, device=device))[out_key][0]
        return out.float().cpu().numpy()

    if overfit:
        # the trained batch itself is scored (the descent signal)
        def score(batch):
            pred = forward(batch["leftImage"], batch["rightImage"])
            return float(_errors(pred, batch[keys[2]].cpu().numpy(),
                                 out_key).mean())
        epe0 = score(_first_batch(loader, keys, device))
    else:
        epe0 = _epe(forward, eval_ds, out_key)
    t0 = time.perf_counter()
    state, losses, fixed = _drive(loader, step, state, steps, log_every,
                                  keys, overfit, device)
    wall = time.perf_counter() - t0
    epe1 = score(fixed) if overfit else _epe(forward, eval_ds, out_key)
    return epe0, epe1, losses, wall


def _record(config_name, steps, batch, crop_hw, epe0, epe1, losses, wall,
            **extra):
    return dict(config=config_name, steps=steps, batch=batch,
                crop=list(crop_hw), **extra,
                epe_init=round(epe0, 3), epe_final=round(epe1, 3),
                loss_first=round(losses[0][1], 4),
                loss_last=round(losses[-1][1], 4),
                losses=[(s, round(v, 4)) for s, v in losses],
                train_s=round(wall, 1))


def run_stereo_family(config_name, overrides=None, steps=300, batch=3,
                      crop_hw=(128, 256), gen_hw=(192, 384),
                      gen_max_disp=48, train_len=60, eval_len=8, seed=0,
                      log_every=20, overfit=False, device=None):
    """Train one stereo family on synthetic data from random weights of
    ``seed``; returns the curve dict (the JAX tool's keys). ``device``:
    the GPU by default, ``'cpu'`` for the plain versions.

    train_len defaults to 60, divisible by every shipped gauntlet batch
    (1, 2, 3, 4), so no epoch ends in a partial batch. overfit=True
    repeats the first batch every step and scores that batch (the CPU
    test's mode); otherwise the held-out eval set is scored."""
    cfg, config_name = _config(config_name, overrides)
    device = float32_device(device)
    loader, eval_ds = _stereo_data(cfg, crop_hw, gen_hw, gen_max_disp,
                                   train_len, eval_len, batch, seed)
    module = build_model(cfg, torch.Generator().manual_seed(seed)).to(device)
    step = make_train_step(make_loss_evaluator(
        cfg["model"]["losses"], sparse=False,
        cmn_losses_cfg=cfg["model"].get("cmn", {}).get("losses")))
    epe0, epe1, losses, wall = _train_and_score(
        module, cfg, step, loader, eval_ds, STEREO_KEYS, "disps", steps,
        log_every, overfit, seed, device)
    return _record(config_name, steps, batch, crop_hw, epe0, epe1, losses,
                   wall, gen_max_disp=gen_max_disp)


def run_flow_family(config_name, overrides=None, steps=300, batch=4,
                    crop_hw=(128, 256), gen_hw=(192, 384), max_flow=8,
                    train_len=60, eval_len=8, seed=0, log_every=20,
                    overfit=False, device=None):
    """run_stereo_family's counterpart for a flow family (its sequence
    loss, flow.losses.flow_l1_loss, with the config's weights)."""
    cfg, config_name = _config(config_name, overrides)
    device = float32_device(device)
    loader, eval_ds = _flow_data(cfg, crop_hw, gen_hw, max_flow, train_len,
                                 eval_len, batch, seed)
    module = build_flow_model(
        cfg, torch.Generator().manual_seed(seed)).to(device)
    step = make_flow_train_step(
        tuple(cfg["model"]["losses"]["flow_l1_loss"]["weights"]))
    epe0, epe1, losses, wall = _train_and_score(
        module, cfg, step, loader, eval_ds, FLOW_KEYS, "flows", steps,
        log_every, overfit, seed, device)
    return _record(config_name, steps, batch, crop_hw, epe0, epe1, losses,
                   wall, max_flow=max_flow)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    all_names = [f[0] for f in STEREO_FAMILIES + FLOW_FAMILIES]
    p.add_argument("--families", nargs="*", default=all_names)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--out", default=None, help="write JSON results here")
    add_cpu_arg(p)
    args = p.parse_args(argv)
    device = tool_device(args)
    print(card_line(), flush=True)

    by_name = {f[0]: ("stereo",) + f for f in STEREO_FAMILIES}
    by_name.update({f[0]: ("flow",) + f for f in FLOW_FAMILIES})
    results = []
    for name in args.families:
        task, _, config_name, overrides, thresh = by_name[name]
        # GCNet's shipped batch is 1 (the reference's imgs_per_gpu);
        # every other family trains at 3 (stereo) or 4 (flow)
        kwargs = {"steps": args.steps, "device": device}
        if name == "GCNet":
            kwargs["batch"] = 1
        run = run_stereo_family if task == "stereo" else run_flow_family
        try:
            r = run(config_name, overrides, **kwargs)
            r["family"] = name
            r["threshold"] = thresh
            r["pass"] = bool(r["epe_final"] <= thresh)
        except Exception as e:   # recorded; the next family runs
            r = dict(family=name, config=config_name,
                     error=f"{type(e).__name__}: {e}")
        results.append(r)
        print(json.dumps(r), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    if args.out:
        with open(args.out, "w") as fp:
            json.dump(results, fp, indent=1)
    ok = [r for r in results if r.get("pass")]
    print(f"\n{len(ok)}/{len(results)} families under threshold")
    return results


if __name__ == "__main__":
    main()
