"""On the card, at each cell's own size: a sound run of the program is
correct, and the control (the reference with float8 operands in the
program's place) fails the cell's limits. Skips without a CUDA device
(decided inside the test); on the card:

    python -m pytest -o addopts="" -p no:cacheprovider -m cuda portbench/tests
"""

import time

import pytest
import torch

from portbench import harness, run


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [c["name"] for c in
                                      harness.spec()["workloads"]])
def test_program_is_correct_and_control_is_not(workload):
    _card()
    harness.set_caches()
    bench = harness.spec()
    _, config, traffic, limits = harness.cell_files(bench, workload)
    control = {"fp8": {}}
    result, checks = run.run_cell(
        workload, config, traffic, limits, 2 ** 31 + 101, 4.0, 0,
        torch.device("cuda"), t0=time.perf_counter(), control=control)
    assert result["correct"], checks
    assert any(control["fp8"][k] > limit for k, limit in limits.items()), \
        (control, limits)
