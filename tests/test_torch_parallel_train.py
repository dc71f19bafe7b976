"""Data-parallel training of the port over two gloo processes on the CPU.

(a) One train step of PSMNet, AcfNet adaptive, DeepPruner 4x and PWCFlow
    at tiny widths, 2 ranks x 2 samples (tests/torch_parallel_ranks.py
    'steps') against the port's one process at 4, from the same weights
    (BN statistics and conv biases drawn at random) and data (the ground
    truth of the batch's second half mostly invalid, so the ranks' valid
    counts differ): the loss entries, the gradients, the BN running
    statistics, and the parameters after the step bitwise equal on the
    two ranks.

PSMNet's two ranks against JAX's ``make_train_step`` at the global batch
are tests/test_torch_train_step.py's (which compiles that step anyway),
tools/train.main over two processes tests/test_torch_parallel.py's.
"""

import os

import numpy as np
import pytest
import torch

from torch_parallel_ranks import (FAMILIES, RANKS, finish_ranks, free_port,
                                  start_ranks)

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

# Gradients of the two ranks against the one process, of the largest
# gradient. PSMNet and AcfNet: measured 1.1e-5 and 5.6e-6. DeepPruner and
# PWCFlow sample features at fractional positions (PatchMatch's and the
# flow warps' linear interpolation), whose gradient jumps where a position
# crosses an integer: a 1e-7 relative perturbation of their weights alone
# moves their gradients by up to 5.4e-4 and 2.8e-4 of the largest
# (measured, four draws each), and the ranks' float32 sums in another
# order by 3.8e-4 and 3.6e-4 (tests/parallel_noise_study.py measures the
# floor). A BatchNorm whose gradient did not cross the ranks, or a mean of
# the ranks' local means, misses by far more.
GRAD_TOL = {"psmnet": 1e-4, "acfnet": 1e-4, "deeppruner": 1e-3,
            "pwcflow": 1e-3}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {k: str(tmp_path_factory.mktemp(k)) for k in ("one", "two")}
    port = free_port()
    argvs = [[RANKS, "steps", out["one"], "0", "1", "0", "4"]] + [
        [RANKS, "steps", out["two"], str(r), "2", str(port), "4"]
        for r in range(2)]
    finish_ranks(start_ranks(argvs))
    load = lambda d, r: torch.load(os.path.join(d, f"rank{r}.pt"),   # noqa
                                   weights_only=False)
    return {"one": load(out["one"], 0),
            "two": [load(out["two"], r) for r in range(2)]}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_two_ranks_match_one_process(runs, family):
    one, two = runs["one"][family], [r[family] for r in runs["two"]]
    losses = [k for k in one["metrics"] if k != "grad_norm"]
    assert "loss" in losses and len(losses) > 1
    for r in two:
        assert sorted(r["metrics"]) == sorted(one["metrics"])
        # every rank logs the global batch's values
        for k in losses:
            np.testing.assert_allclose(r["metrics"][k], one["metrics"][k],
                                       rtol=1e-5, err_msg=k)
        top = max(float(g.abs().max()) for g in one["grads"].values())
        for k, g in one["grads"].items():
            err = float((r["grads"][k] - g).abs().max())
            assert err <= GRAD_TOL[family] * top, (k, err / top)
        for k, b in one["buffers"].items():
            if b.is_floating_point():
                # float32 sums in another order; the variance biased on
                # both sides
                torch.testing.assert_close(r["buffers"][k], b, rtol=0,
                                           atol=1e-5, msg=k)
            else:
                assert torch.equal(r["buffers"][k], b), k
    # the optimizer stepped identically on both ranks
    for k, p in two[0]["params"].items():
        assert torch.equal(p, two[1]["params"][k]), k
    assert two[0]["grads"].keys() == two[1]["grads"].keys()
    assert all(torch.equal(g, two[1]["grads"][k])
               for k, g in two[0]["grads"].items())


def test_two_ranks_run_the_same_collectives(runs):
    one, two = runs["one"]["collectives"], [r["collectives"] for r in
                                            runs["two"]]
    assert set(one.values()) == {0}          # no group, no collective
    assert two[0] == two[1] and two[0]["all_reduce"] > 0
    assert two[0]["broadcast"] == two[0]["barrier"] == 0
