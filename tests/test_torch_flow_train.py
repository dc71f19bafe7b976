"""One train step of the port's PWCFlow against the JAX package's, on
the CPU: the four levels' flow losses and their sum, every gradient leaf
and the BN statistics after the step (the siamese pyramid's moved twice)
in float32, and a bfloat16 step's loss (tests/flow_train_parity.py, at
the tiny size of tests/flow_parity.py).
"""

import pytest
import torch

from flow_parity import PWC
from flow_train_parity import (check_bf16_loss, check_bn_stats,
                               check_gradients, check_losses, train_case)

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    return train_case(PWC)


def test_pwcflow_train_losses_match_jax(case):
    check_losses(*case, n_flows=4)


def test_pwcflow_train_gradients_match_jax(case):
    """Every leaf has a gradient except the pyramid's and the estimators'
    conv biases that feed a batch-statistics BN (zero in exact
    arithmetic: 6 of the encoder's, 2 of each estimator's, 5 of the
    refinement's)."""
    port, want = case
    zero = {k for k in port["grads"] if k[-2:] == ("Conv_0", "bias")
            and k[:-2] + ("BatchNorm_0", "scale") in port["grads"]}
    assert len(zero) == 6 + 3 * 2 + 5
    assert check_gradients(*case, zero=zero) == {
        "FlowPyramidEncoder_0", "FlowEstimator_0", "FlowEstimator_1",
        "FlowEstimator_2", "ContextRefinement_0"}


def test_pwcflow_train_bn_stats_match_jax(case):
    check_bn_stats(*case)


def test_pwcflow_bf16_train_loss_matches_jax(case):
    check_bf16_loss(*case)
