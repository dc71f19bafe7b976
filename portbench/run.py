"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout with ``BENCHMARK.json``. The run sets the
build caches inside the checkout, makes its weights and data from the
seed, warms the cell's own shapes (all of it counted as ``setup_s``),
measures its closed loop for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, the first
``trace_seconds`` of the window under torch.profiler), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number
beside its limit (also the last lines of standard error). Without a
CUDA device, or with fewer than the cell asks for, it exits non-zero and
prints no result; so it does if the JAX stack or the JAX package is
loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from . import harness  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(workload, config, traffic, limits, seed, seconds, trace,
             device, e2e=(), per_layer=(), fault=None, t0=None,
             control=None, keep_numbers=None):
    """One run of a cell on ``device``: (result dict, checks dict). The
    tests call it on the CPU at a tiny size; ``fault(state)`` breaks the
    prepared program underneath. ``control`` ({precision: {}}) receives
    the numbers of the reference in each precision in the program's
    place, on the same frames, and ``keep_numbers`` every number the
    check gives (calibrate.py)."""
    import torch

    from . import check
    from .cell import Context
    from .trace import Tracer

    t0 = T0 if t0 is None else t0
    drv = harness.driver(traffic["driver"])
    tracer = Tracer(bool(trace) and device.type == "cuda",
                    traffic.get("trace_seconds", 3.0))
    tmpdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        ctx = Context(config, traffic, seed, device, tmpdir, tracer)
        ctx.phases["start"] = ctx.last - t0
        state = drv.prepare(ctx)
        if fault is not None:
            fault(state)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        # set-up's objects out of the collector's way in the window
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t0
        record = drv.window(state, seconds, tracer)
        gc.unfreeze()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        record.update(setup_s=setup_s, memory_peak_bytes=peak)
        print("set-up seconds: " + ", ".join(
            f"{k} {v:.2f}" for k, v in ctx.phases.items()),
            file=sys.stderr, flush=True)
        obs = None
        if tracer.enabled:
            obs = tracer.observation(config["family"],
                                     config["model"]["max_disp"],
                                     tuple(traffic["pad_to"]))
        weights = state["weights"]
        frames = drv.outputs(state)
        state.clear()
        if cuda:
            torch.cuda.empty_cache()
        data = config["data"]
        numbers = check.compare(frames, weights, config,
                                tuple(traffic["pad_to"]),
                                data["mean"], data["std"],
                                traffic["check_view"], device)
        for name, readings in (control or {}).items():
            readings.update(check.compare(
                frames, weights, config, tuple(traffic["pad_to"]),
                data["mean"], data["std"], traffic["check_view"], device,
                control=name))
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in limits.items()}
    if keep_numbers is not None:
        keep_numbers.update(numbers)
    checks["frames_compared"] = {"value": len(frames), "limit": 1}
    correct = len(frames) >= 1 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for name, c in checks.items() if name != "frames_compared")
    metrics = {}
    for m in (per_layer if tracer.enabled else e2e):
        kind = "layer_metrics" if tracer.enabled else "end_to_end"
        value = harness.reader(kind, m["name"])(obs if tracer.enabled
                                                else record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": 1,
                         "memory_peak_bytes": record["memory_peak_bytes"]}}
    if obs is not None:
        result["device"].update(busy_s=obs["busy_s"],
                                window_s=obs["window_s"])
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s, _ in obs["kernels"][:10]],
            "idle_gaps": obs["idle_gaps"]}
    return result, checks


def main(argv=None):
    args = parse_args(argv)
    harness.set_caches()
    bench = harness.spec()
    cell, config, traffic, limits = harness.cell_files(bench, args.workload)
    harness.card(cell["chips"])
    import torch
    # one intra-op thread: the loader's threads and the dispatching one
    # share the machine's cores with no idle pool spinning among them
    torch.set_num_threads(1)
    result, checks = run_cell(
        args.workload, config, traffic, limits, args.seed, args.seconds,
        args.trace, torch.device("cuda"),
        e2e=harness.cell_metrics(bench, args.workload, "end_to_end"),
        per_layer=harness.cell_metrics(bench, args.workload, "per_layer"))
    found = harness.forbidden_modules()
    if found:
        sys.exit(f"portbench: loaded {found}: the benchmark runs the port "
                 "without the JAX stack or the JAX package")
    harness.emit(result, checks)


if __name__ == "__main__":
    main()
