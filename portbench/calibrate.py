"""The readings that the correctness limits are set from, all in one
process, each run as the benchmark runs it with a short window: every
number check.compare gives, of sound runs of the program on ``--seeds``
seeds; on the first ``--control`` of them, on the same frames, of the
control (the reference with float8 operands in the program's place);
with ``--witness N``, of N runs of the port's own float32 configuration,
which the float32 reference should match.

    python3 -m portbench.calibrate --workload <name> --seeds 12 \\
        --control 3 [--witness 1] --seconds 3 [--first-seed N] [--out F]

Prints one JSON line a run and, last, the largest program reading and
the smallest control reading of each number.
"""

import argparse
import copy
import json
import time

from . import harness, run


def _run(workload, config, traffic, limits, seed, seconds, control):
    import torch
    t = time.perf_counter()
    numbers = {}
    result, checks = run.run_cell(
        workload, config, traffic, limits, seed, seconds, 0,
        torch.device("cuda"), t0=time.perf_counter(), control=control,
        keep_numbers=numbers)
    numbers["frames_compared"] = checks["frames_compared"]["value"]
    return {"seed": seed, "correct": result["correct"],
            "program": numbers,
            "control": control, "frames_per_s": result["attempted"]
            / seconds, "seconds": time.perf_counter() - t}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--witness", type=int, default=0)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.set_caches()
    bench = harness.spec()
    cell, config, traffic, limits = harness.cell_files(bench, args.workload)
    harness.card(cell["chips"])
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for i in range(args.seeds):
        control = {"fp8": {}} if i < args.control else None
        emit(_run(args.workload, config, traffic, limits,
                  args.first_seed + 7919 * i, args.seconds, control))
    f32 = copy.deepcopy(config)
    f32["port_configs"] = {k: v.replace("_bf16", "_f32")
                           for k, v in f32["port_configs"].items()}
    for i in range(args.witness):
        row = _run(args.workload, f32, traffic, limits,
                   args.first_seed + 104729 * (i + 1), args.seconds, None)
        row["witness"] = "port float32"
        emit(row)
    summary = {}
    sound = [r for r in rows if "witness" not in r]
    for k in sound[0]["program"]:
        prog = [r["program"][k] for r in sound]
        ctrl = [r["control"]["fp8"][k] for r in sound if r["control"]
                and k in r["control"]["fp8"]]
        summary[k] = {"program_max": max(prog),
                      "control_min": min(ctrl) if ctrl else None}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            json.dump({"rows": rows, "summary": summary}, fp, indent=1)


if __name__ == "__main__":
    main()
