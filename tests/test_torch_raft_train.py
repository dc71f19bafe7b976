"""One train step of the port's RAFT against the JAX package's, on the
CPU: the three flow losses (the convex-upsampled flow at 1.0, the two
iterations' at 1.0 and 0.8, latest first) and their sum, every gradient
leaf (the weight-tied update block's summed over its iterations, as
JAX's scan sums them) and the BN statistics after the step (``fnet``'s
moved twice) in float32, and a bfloat16 step's loss
(tests/flow_train_parity.py, at the tiny size of tests/flow_parity.py).
"""

import pytest
import torch

from flow_parity import RAFT
from flow_train_parity import (check_bf16_loss, check_bn_stats,
                               check_gradients, check_losses, train_case)

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    return train_case(RAFT)


def test_raft_train_losses_match_jax(case):
    check_losses(*case, n_flows=3)


def test_raft_train_gradients_match_jax(case):
    """Every leaf has a gradient except the encoders' conv biases that
    feed a batch-statistics BN (zero in exact arithmetic: 15 in each of
    fnet and cnet)."""
    port, want = case
    zero = {k for k in port["grads"] if k[-2:] == ("Conv_0", "bias")
            and k[:-2] + ("BatchNorm_0", "scale") in port["grads"]}
    assert len(zero) == 2 * 15
    assert check_gradients(*case, zero=zero) == {
        "fnet", "cnet", "update", "ConvexUpsampler_0"}


def test_raft_train_bn_stats_match_jax(case):
    check_bn_stats(*case)


def test_raft_bf16_train_loss_matches_jax(case):
    check_bf16_loss(*case)
