"""The port's two study tools on the CPU at tiny sizes:

- tools/eval_batch_study.py (--cpu): the EPE of every batch size the same,
  JAX's JSON keys on its last line, in the default loop, with --cache and
  with --device-resident;
- tools/dsharding_halo_study.py (--cpu, two gloo ranks): the collectives
  and bytes of a forward on a (1, 2) grid at the shape of
  tests/test_torch_dsharding.py's aggregator case equal those of that
  case's ranks (tests/torch_dsharding_ranks.py, a (2, 2) grid of one
  sample a rank), and the break-even link rate is the bytes over the
  saved compute.
"""

import contextlib
import io
import json
import math
import os

import numpy as np
import pytest
import torch

from densematchingbenchmark_tpu_torch.tools import (dsharding_halo_study,
                                                    eval_batch_study)

from torch_dsharding_ranks import AGG_MAX_DISP, AGG_SHAPE
from torch_parallel_ranks import finish_ranks, free_port, start_ranks

torch.set_num_threads(1)

SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dsharding_ranks.py")
# tools/eval_batch_study.py's keys (the repository's), for --batches 1 2
JAX_KEYS = {"config", "n", "shape", "batch1_ms_per_sample", "batch1_epe",
            "batch2_ms_per_sample", "batch2_epe", "speedup"}


def run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        record = main(argv)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("gpu: ")
    assert json.loads(lines[-1]) == json.loads(json.dumps(record))
    return record


@pytest.mark.parametrize("mode", [[], ["--cache"], ["--device-resident"]])
def test_eval_batch_study_epe_is_the_same_at_every_batch(mode):
    record = run(eval_batch_study.main, [
        "--cpu", "--n", "3", "--batches", "1", "2", "--height", "64",
        "--width", "128", "--dtype", "float32", *mode])
    assert JAX_KEYS <= set(record)
    assert record["n"] == 3 and record["shape"] == [64, 128]
    assert math.isfinite(record["batch1_epe"]) and record["batch1_epe"] > 0
    np.testing.assert_allclose(record["batch2_epe"], record["batch1_epe"],
                               rtol=1e-5)
    for b in (1, 2):
        assert record[f"batch{b}_ms_per_sample"] > 0
    assert record["speedup"] == pytest.approx(
        record["batch1_ms_per_sample"] / record["batch2_ms_per_sample"])


def test_dsharding_halo_study_counts_as_the_dsharding_ranks(tmp_path):
    """The study on (1, 2) against tests/test_torch_dsharding.py's
    aggregator case on (2, 2): a rank of each holds one sample and half
    of D, and hands the same collectives the same bytes."""
    port = free_port()
    procs = start_ranks([[SCRIPT, "grid", str(tmp_path), str(r), "4",
                          str(port), "aggregator"] for r in range(4)])
    try:
        _, d4, h, w, c = AGG_SHAPE
        record = run(dsharding_halo_study.main, [
            "--cpu", "--n-model", "2", "--max-disp", str(AGG_MAX_DISP),
            "--height", str(h), "--width", str(w), "--compute-ms", "3.0",
            "--link-gbps", "100"])
    finally:
        finish_ranks(procs, timeout=120)
    assert record["shape"] == [1, d4, h, w, c]
    for r in range(4):
        want = torch.load(os.path.join(tmp_path, f"grid{r}.pt"),
                          weights_only=False)["aggregator"]["counts"]
        assert record["collective_counts"] == want["kinds"]
        assert record["collective_bytes"] == want["bytes"]
        assert record["d_axis_counts"] == want["d_axis"]
    assert record["d_axis_counts"] == {
        "halo_exchange": 7, "halo_exchange_backward": 0, "gather_d": 2,
        "gather_d_backward": 0}
    # the raw volume's halo (64 channels), six 32-channel halos, the dres
    # output's planes and the three costs', one plane a side each halo
    most = -(-d4 // 2)
    assert record["collective_bytes"]["all_gather"] == 4 * h * w * (
        2 * 64 + 6 * 2 * 32 + most * 32 + 3 * most)
    received = record["collective_bytes"]["all_gather"]     # (2 - 1) x
    assert record["gather_bytes_mib"] == received / 2 ** 20
    assert record["single_chip_compute_ms"] == 3.0
    assert record["compute_measured_on"] is None
    assert record["compute_saved_ms"] == pytest.approx(1.5)
    assert record["modeled_transfer_ms"] == pytest.approx(
        received / 100e9 * 1e3)
    assert record["break_even_link_gbps"] == pytest.approx(
        received / 1.5e-3 / 1e9)
    assert record["d_sharding_wins"] == (1.5 > record["modeled_transfer_ms"])
    assert "not a measured multi-GPU speed" in record["note"]
