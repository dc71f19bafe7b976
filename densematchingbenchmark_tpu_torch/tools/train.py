"""Train a stereo model from a named config.

    python -m densematchingbenchmark_tpu_torch.tools.train \\
        --config PSMNet/scene_flow_f32 --work-dir work/psmnet \\
        --data-root /data/SceneFlow --annfile /data/cleanpass_train.json \\
        [--eval-annfile /data/cleanpass_test.json] [--resume] [--cpu]
    python -m densematchingbenchmark_tpu_torch.tools.train \\
        --config PSMNet/scene_flow_f32 --synthetic --work-dir /tmp/smoke \\
        --max-steps 20                  # no dataset needed
    python -m densematchingbenchmark_tpu_torch.tools.train \\
        --config PSMNet/scene_flow --dtype bfloat16 --synthetic \\
        --work-dir /tmp/smoke_bf16 --max-steps 20

The counterpart of the JAX package's tools/train.py for stereo models, with
its flags: a thin CLI over ``trainer.loop.train_matcher``. ``--dtype
bfloat16`` (or a ``_bf16`` config name) trains with float32 parameters, BN
statistics and gradients and bfloat16 activations, as JAX's
``model.dtype``; no loss scaling. ``--profile START:STOP`` writes a
torch.profiler trace of those steps to <work-dir>/profile. Runs on the
GPU unless ``--cpu``; with neither it raises.

A flow config (PWCFlow, RAFT) trains through the same ``train_matcher``
(the JAX tools/train.py:91-122, its ``train_flow``): on a FlyingChairs
annotation at data.crop_size, scored and visualised after each epoch on
``--eval-annfile``'s pairs padded to data.pad_to_size; or, with
``--synthetic``, on ``--synthetic-length`` synthetic pairs at
data.crop_size, with ``--synthetic-eval`` (2 by default, as JAX's) for
the eval and the vis hook. Multi-process launchers (ROADMAP.md queue 1
item 5) are not ported and raise.
"""

import argparse

from ..configs import get_config
from ..data import SyntheticStereoDataset, transforms
from ..trainer.loop import train_matcher
from .common import (add_distributed_args, add_dtype_arg, check_launcher,
                     config_overrides)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a dense matching model")
    p.add_argument("--config", required=True,
                   help="config name, e.g. PSMNet/scene_flow_f32 or "
                        "PSMNet/scene_flow_bf16")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--data-root", default=None)
    p.add_argument("--annfile", default=None, help="train annotation JSON")
    p.add_argument("--eval-annfile", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (smoke/debug)")
    p.add_argument("--synthetic-shape", type=int, nargs=2, default=(256, 512),
                   metavar=("H", "W"))
    p.add_argument("--synthetic-length", type=int, default=16)
    p.add_argument("--synthetic-eval", type=int, default=0, metavar="N",
                   help="with --synthetic: also evaluate N synthetic "
                        "samples after every epoch")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch versions on the CPU")
    add_dtype_arg(p)
    p.add_argument("--override", nargs="*", default=[],
                   help="dotted config overrides, e.g. model.max_disp=96")
    p.add_argument("--profile", default=None, metavar="START:STOP",
                   help="write a torch.profiler trace of global steps "
                        "START..STOP to <work-dir>/profile")
    add_distributed_args(p)
    return p.parse_args(argv)


def main(argv=None):
    """Returns the final TrainState."""
    args = parse_args(argv)
    check_launcher(args)
    cfg = get_config(args.config, **config_overrides(args))
    cfg["seed"] = args.seed
    run = dict(resume=args.resume, max_steps=args.max_steps,
               log_interval=args.log_interval,
               device="cpu" if args.cpu else None,
               profile_steps=(tuple(int(x) for x in args.profile.split(":"))
                              if args.profile else None))
    if cfg.get("task") == "flow":
        return flow_main(args, cfg, run)

    if args.synthetic:
        maxd = cfg["model"]["max_disp"]
        sh, sw = args.synthetic_shape
        mean, std = cfg["data"]["mean"], cfg["data"]["std"]
        cfg["data"] = dict(
            type="Synthetic", sparse=False, batch_size_per_device=1,
            mean=mean, std=std,
            train=dict(length=args.synthetic_length, height=sh, width=sw,
                       max_disp=min(maxd, 64), input_shape=(sh, sw)))
        ds = SyntheticStereoDataset(length=args.synthetic_length, height=sh,
                                    width=sw, max_disp=min(maxd, 64))
        ds.transform = transforms.make_train_transform((sh, sw), mean, std)
        eval_ds = None
        if args.synthetic_eval:
            eval_ds = SyntheticStereoDataset(
                length=args.synthetic_eval, height=sh, width=sw,
                max_disp=min(maxd, 64), seed=7)
            eval_ds.transform = transforms.make_eval_transform((sh, sw),
                                                               mean, std)
            cfg["model"].setdefault(
                "eval", dict(lower_bound=0, upper_bound=maxd))
        return train_matcher(cfg, args.work_dir, train_dataset=ds,
                             eval_dataset=eval_ds, **run)

    if not (args.data_root and args.annfile):
        raise ValueError("--data-root and --annfile required (or use "
                         "--synthetic)")
    cfg["data"]["data_root"] = args.data_root
    cfg["data"]["train"]["annfile"] = args.annfile
    if args.eval_annfile:
        cfg["data"]["eval"]["annfile"] = args.eval_annfile
    return train_matcher(cfg, args.work_dir, **run)


def flow_main(args, cfg, run):
    """The flow branch, with train_matcher's keyword arguments ``run``:
    returns the final TrainState."""
    from ..flow import transforms as ftrans
    from ..flow.datasets import FlyingChairsDataset, SyntheticFlowDataset

    mean, std = cfg["data"]["mean"], cfg["data"]["std"]
    crop = tuple(cfg["data"].get("crop_size", (320, 448)))
    pad = tuple(cfg["data"].get("pad_to_size", (384, 512)))
    if args.synthetic:
        train_ds = SyntheticFlowDataset(
            length=args.synthetic_length, height=crop[0], width=crop[1],
            transform=ftrans.make_train_transform(crop, mean, std))
        eval_ds = SyntheticFlowDataset(
            length=args.synthetic_eval or 2, height=crop[0], width=crop[1],
            transform=ftrans.make_eval_transform(crop, mean, std))
    else:
        if not (args.data_root and args.annfile):
            raise ValueError("--data-root and --annfile required (or use "
                             "--synthetic)")
        train_ds = FlyingChairsDataset(
            args.annfile, args.data_root,
            transform=ftrans.make_train_transform(crop, mean, std))
        eval_ds = None
        if args.eval_annfile:
            eval_ds = FlyingChairsDataset(
                args.eval_annfile, args.data_root,
                transform=ftrans.make_eval_transform(pad, mean, std))
    return train_matcher(cfg, args.work_dir, train_dataset=train_ds,
                         eval_dataset=eval_ds, vis_dataset=eval_ds, **run)


if __name__ == "__main__":
    main()
