"""How far chip_smoke.py's convergence-gauntlet criterion varies between
runs of one family on the card (a script, not a test):

    python tests/gauntlet_spread_study.py [--families NAME ...] [--runs N]
        [--float32] [--deterministic]

Each family of tools/convergence_gauntlet.py named (AcfNet-uniform and
AcfNet-adaptive by default) is trained ``--runs`` times (default 10) as
chip_smoke.py's phase 18 trains it: its config name (bfloat16), seed 0,
GAUNTLET_STEPS steps on one batch at GAUNTLET_CROP with lr 2e-3 and no
warmup, the loss logged every step. ``--float32`` sets the model's dtype
to float32; ``--deterministic`` sets ``torch.backends.cudnn.deterministic``.
Prints the card's name and power limit, one JSON line per run (the loss
ratio loss_last / loss_first, the batch's EPE before and after, every
step's loss) and one JSON line per family: the ratios' least and largest
value and how many runs met JAX's criterion (ratio below GAUNTLET_DROP
and the EPE down).

Needs a CUDA device; pytest does not collect it.
"""

import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import chip_smoke  # noqa: E402
from densematchingbenchmark_tpu_torch.configs import get_config  # noqa: E402
from densematchingbenchmark_tpu_torch.ops.cuda import _build  # noqa: E402
from densematchingbenchmark_tpu_torch.tools import (  # noqa: E402
    convergence_gauntlet as gauntlet)


def one_run(family, config, overrides, dtype, deterministic):
    cfg = get_config(config, **overrides)
    cfg["name"] = config
    if dtype:
        cfg["model"]["dtype"] = dtype
    cfg["optimizer"]["lr"] = 2e-3
    cfg.setdefault("lr_schedule", {})["warmup_iters"] = 0
    torch.backends.cudnn.deterministic = deterministic
    t0 = time.perf_counter()
    try:
        r = gauntlet.run_stereo_family(
            cfg, steps=chip_smoke.GAUNTLET_STEPS,
            batch=1 if family == "GCNet" else 2,
            crop_hw=chip_smoke.GAUNTLET_CROP, log_every=1, overfit=True,
            device="cuda")
    finally:
        torch.backends.cudnn.deterministic = False
    ratio = r["loss_last"] / r["loss_first"]
    met = ratio < chip_smoke.GAUNTLET_DROP and r["epe_final"] < r["epe_init"]
    return {"family": family, "dtype": cfg["model"]["dtype"],
            "deterministic": deterministic, "ratio": ratio, "met": met,
            "epe": [r["epe_init"], r["epe_final"]],
            "losses": [v for _, v in r["losses"]],
            "s": time.perf_counter() - t0}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--families", nargs="*",
                   default=["AcfNet-uniform", "AcfNet-adaptive"])
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--float32", action="store_true")
    p.add_argument("--deterministic", action="store_true")
    args = p.parse_args(argv)
    smi = chip_smoke.device_phase()
    _build.build()
    by_name = {f[0]: f for f in gauntlet.STEREO_FAMILIES}
    for family in args.families:
        _, config, overrides, _ = by_name[family]
        runs = []
        for _ in range(args.runs):
            rec = one_run(family, config, overrides,
                          "float32" if args.float32 else None,
                          args.deterministic)
            print(json.dumps(rec), flush=True)
            runs.append(rec)
            torch.cuda.empty_cache()
        ratios = [rec["ratio"] for rec in runs]
        print(json.dumps({"family": family, "dtype": runs[0]["dtype"],
                          "deterministic": args.deterministic,
                          "runs": len(runs), "ratio_min": min(ratios),
                          "ratio_max": max(ratios),
                          "met": sum(rec["met"] for rec in runs),
                          "card": smi}), flush=True)


if __name__ == "__main__":
    main()
