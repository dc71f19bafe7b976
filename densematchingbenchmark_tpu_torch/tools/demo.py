"""Stereo inference over a directory of image pairs.

    python -m densematchingbenchmark_tpu_torch.tools.demo \\
        --config PSMNet/kitti_2015_f32 --data-dir pairs --out-dir out \\
        [--work-dir work/psmnet] [--pad-to H W] [--cpu] [--dtype bfloat16]

The counterpart of the JAX package's tools/demo.py for stereo models:
<data-dir>/left/*.png and <data-dir>/right/*.png with matching names in;
per pair, <out-dir>/<name>.pfm (the disparity) and <name>.png (its colour
map) out, through ``apis.inference_stereo``, each pair padded to
``--pad-to`` or to the next multiple of 64. Weights come from
<work-dir>/checkpoints/ when given, else from seed 0. ``--dtype bfloat16``
(or a ``_bf16`` config name) runs the network in bfloat16 compute; the
disparities are float32. Runs on the GPU unless ``--cpu``; with neither it
raises.

A flow config (PWCFlow, RAFT) takes <data-dir>/left/ as frame t and
<data-dir>/right/ as frame t + 1 and writes, per pair, through
``apis.inference_flow`` and ``flow.vis.SaveFlowResultTool``,
<out-dir>/flow_0/<name>.flo and <out-dir>/color_flow/<name>.png (the JAX
tools/demo.py:60-80).
"""

import argparse
import glob
import os
import os.path as osp

import numpy as np

from ..apis import inference_stereo, init_model
from ..configs import get_config
from ..data import io
from ..visualization import disp_to_color
from .common import add_dtype_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Stereo inference demo")
    p.add_argument("--config", required=True,
                   help="config name, e.g. PSMNet/kitti_2015_f32 or "
                        "PSMNet/kitti_2015_bf16")
    p.add_argument("--data-dir", required=True,
                   help="directory with left/ and right/ subdirs")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--work-dir", default=None,
                   help="checkpoint dir; random init if absent")
    p.add_argument("--pad-to", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="pad input to this shape (default: next multiple "
                        "of 64)")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch versions on the CPU")
    add_dtype_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.config, **({"model.dtype": args.dtype}
                                     if args.dtype else {}))
    lefts = sorted(glob.glob(osp.join(args.data_dir, "left", "*")))
    if not lefts:
        raise FileNotFoundError(f"no images under {args.data_dir}/left")
    if cfg.get("task") == "flow":
        return flow_main(args, cfg, lefts)
    model = init_model(cfg, device="cpu" if args.cpu else None,
                       checkpoint_dir=args.work_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    for lpath in lefts:
        rpath = osp.join(args.data_dir, "right", osp.basename(lpath))
        left, right = io.load_image(lpath), io.load_image(rpath)
        h, w = left.shape[:2]
        pad = args.pad_to or (-(-h // 64) * 64, -(-w // 64) * 64)
        disp = inference_stereo(model, [{"leftImage": left,
                                         "rightImage": right}],
                                pad_to_shape=pad)[0]["disps"][0][0, ..., 0]
        name = osp.splitext(osp.basename(lpath))[0]
        io.save_pfm(osp.join(args.out_dir, f"{name}.pfm"), disp)
        io.save_png(osp.join(args.out_dir, f"{name}.png"),
                    np.clip(disp_to_color(disp, cfg["model"]["max_disp"]),
                            0, 255).astype(np.uint8))
        print(f"{name}: disp range [{disp.min():.2f}, {disp.max():.2f}] "
              f"-> {args.out_dir}")


def flow_main(args, cfg, lefts):
    from ..apis import inference_flow, init_flow_model
    from ..flow.vis import SaveFlowResultTool

    model = init_flow_model(cfg, device="cpu" if args.cpu else None,
                            checkpoint_dir=args.work_dir)
    save = SaveFlowResultTool(args.out_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    for lpath in lefts:
        rpath = osp.join(args.data_dir, "right", osp.basename(lpath))
        left, right = io.load_image(lpath), io.load_image(rpath)
        h, w = left.shape[:2]
        pad = args.pad_to or (-(-h // 64) * 64, -(-w // 64) * 64)
        flow = inference_flow(model, [{"leftImage": left,
                                       "rightImage": right}],
                              pad_to_shape=pad)[0]["flows"][0]
        name = osp.splitext(osp.basename(lpath))[0]
        save(name, flow)
        print(f"{name}: flow saved")
    print(f"results in {args.out_dir}")


if __name__ == "__main__":
    main()
