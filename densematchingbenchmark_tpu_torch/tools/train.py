"""Train a stereo model from a named config.

    python -m densematchingbenchmark_tpu_torch.tools.train \\
        --config PSMNet/scene_flow_f32 --work-dir work/psmnet \\
        --data-root /data/SceneFlow --annfile /data/cleanpass_train.json \\
        [--eval-annfile /data/cleanpass_test.json] [--resume] [--cpu]
    python -m densematchingbenchmark_tpu_torch.tools.train \\
        --config PSMNet/scene_flow_f32 --synthetic --work-dir /tmp/smoke \\
        --max-steps 20                  # no dataset needed

The counterpart of the JAX package's tools/train.py for stereo models, with
its flags: a thin CLI over ``trainer.loop.train_matcher``. Runs on the GPU
unless ``--cpu``; with neither it raises. Flow configs (ROADMAP.md queue 1
item 11), ``--profile`` (item 3) and multi-process launchers (item 5) are
not ported and raise; so does ``--dtype bfloat16`` (item 2).
"""

import argparse

from ..configs import get_config
from ..data import SyntheticStereoDataset, transforms
from ..trainer.loop import train_matcher
from .common import add_distributed_args, check_launcher, parse_overrides


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a dense matching model")
    p.add_argument("--config", required=True,
                   help="config name, e.g. PSMNet/scene_flow_f32")
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
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--override", nargs="*", default=[],
                   help="dotted config overrides, e.g. model.max_disp=96")
    p.add_argument("--profile", default=None, metavar="START:STOP")
    add_distributed_args(p)
    return p.parse_args(argv)


def main(argv=None):
    """Returns the final TrainState."""
    args = parse_args(argv)
    check_launcher(args)
    if args.profile:
        raise NotImplementedError("--profile: the profiler window is not "
                                  "ported yet (ROADMAP.md queue 1 item 3)")
    overrides = parse_overrides(args.override)
    if args.dtype:
        overrides["model.dtype"] = args.dtype
    cfg = get_config(args.config, **overrides)
    cfg["seed"] = args.seed
    if cfg.get("task") == "flow":
        raise NotImplementedError("flow training is not ported yet "
                                  "(ROADMAP.md queue 1 item 11)")
    run = dict(resume=args.resume, max_steps=args.max_steps,
               log_interval=args.log_interval,
               device="cpu" if args.cpu else None)

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


if __name__ == "__main__":
    main()
