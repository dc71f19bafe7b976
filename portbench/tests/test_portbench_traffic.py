"""Every cell of BENCHMARK.json driven on the CPU at a tiny size, sound
and with the timed path broken underneath."""

import pytest

from portbench.tests.portbench_tiny import run_tiny, workloads

# the cells' own limits hold at the tiny size: disp_gap_bf16x reads 1.26-1.45
# for the program and 12.2-15.8 for the float8 control there (three seeds
# a cell), 1.20-1.68 and 10.5-15.0 at the cells' sizes on the card


@pytest.mark.parametrize("workload", workloads())
def test_cell_runs_and_is_correct(workload):
    result, checks = run_tiny(workload)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = set(result["metrics"])
    assert "setup_s" in names and len(names) >= 2
    assert "peak_mem_gib" not in names          # no card: no reading
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert checks["frames_compared"]["value"] >= 1
    assert list(checks)[-1] == "frames_compared"


def _altered(state):
    """A disparity altered where it is produced: +1 px on the best map."""
    def hook(_m, _args, out):
        out["disps"][0] = out["disps"][0] + 1.0
    state["module"].register_forward_hook(hook)


def _half_batch(state):
    """Half of each batch left out: the first half's frames stand in for
    the rest."""
    def pre(_m, args):
        left, right = args[:2]
        h = max(left.shape[0] // 2, 1)
        idx = [i % h for i in range(left.shape[0])]
        return (left[idx], right[idx]) + tuple(args[2:])
    state["module"].register_forward_pre_hook(pre)


@pytest.mark.parametrize("workload", workloads())
def test_altered_answer_is_not_correct(workload):
    result, checks = run_tiny(workload, fault=_altered)
    assert not result["correct"], checks


@pytest.mark.parametrize("workload", [w for w in workloads()
                                      if "-b4" in w])
def test_half_batch_is_not_correct(workload):
    result, checks = run_tiny(workload, fault=_half_batch)
    assert not result["correct"], checks


@pytest.mark.parametrize("workload", workloads())
def test_control_fails_the_cells_limits(workload):
    """The control (the reference with float8 operands in the program's
    place) at the tiny size fails the cell's limit, which the program
    meets on the same frames."""
    control = {"fp8": {}}
    result, checks = run_tiny(workload, control=control)
    assert result["correct"]
    assert any(control["fp8"][k] > c["limit"] for k, c in checks.items()
               if k != "frames_compared")
