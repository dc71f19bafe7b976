"""Tiny versions of the benchmark's cells for the CPU tests: every width
as published, the disparity range cut to 16 and the frames to 60 x 120
(padded to 64 x 128), a few pairs."""

import time

import torch

from portbench import harness, run

MAX_DISP = 16


def tiny(workload):
    """(config, traffic, limits) of ``workload`` at the tiny size."""
    bench = harness.spec()
    _, config, traffic, limits = harness.cell_files(bench, workload)
    config["port_overrides"] = {
        "model.max_disp": MAX_DISP,
        "model.cost_processor.cost_computation.max_disp": MAX_DISP // 4,
        "model.cost_processor.cost_aggregator.max_disp": MAX_DISP,
        "model.disp_predictor.max_disp": MAX_DISP,
        "model.eval.upper_bound": MAX_DISP}
    config["model"]["max_disp"] = MAX_DISP
    traffic.update(frame=[60, 120], pad_to=[64, 128], disparity=[1.0, 12.0])
    if traffic["driver"] == "eval":
        traffic.update(pairs=8, samples=12, warmup_pairs=4)
    else:
        traffic.update(pool=4, check=2, check_within=3, warmup_calls=1)
    return config, traffic, limits


def run_tiny(workload, seed=2 ** 31 + 11, seconds=0.5, limits=None,
             fault=None, control=None):
    """run_cell of the tiny ``workload`` on the CPU, its end-to-end
    metrics read: (result, checks)."""
    torch.set_num_threads(2)
    config, traffic, cell_limits = tiny(workload)
    e2e = harness.cell_metrics(harness.spec(), workload, "end_to_end")
    return run.run_cell(workload, config, traffic,
                        cell_limits if limits is None else limits, seed,
                        seconds, 0, torch.device("cpu"), e2e=e2e,
                        fault=fault, t0=time.perf_counter(), control=control)


def workloads():
    return [c["name"] for c in harness.spec()["workloads"]]
