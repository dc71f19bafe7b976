"""Shared set-up of the flow parity tests (tests/test_torch_flow*.py,
tests/test_torch_raft*.py): the tiny configurations on both sides and the
weights they share.

PWCFlow: three levels of (8, 16, 16) channels, radius 2 (25
displacements), hidden 16, on 32x64 frames (sides multiples of 16).
RAFT: 2 iterations, hidden 32, context 16, on 64x64 frames (an 8x8 map at
1/8 gives all four correlation levels). The weights are the port's seeded
tree with every BatchNorm's parameters and statistics and every conv bias
drawn at random (tests/acfnet_parity.randomize), and PWCFlow's score
heads scaled up so that its soft-argmaxes move by pixels (at the seeded
scale the flows stay within 0.2 px of 0, which a dropped level would
hide); carried to JAX with ``flax_variables``, so JAX's ``init`` is never
traced.
"""

import numpy as np
import torch

from densematchingbenchmark_tpu.configs import get_config as jget_config

from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

from acfnet_parity import randomize

PWC = "PWCFlow/flying_chairs"
RAFT = "RAFT/flying_chairs"
OVERRIDES = {
    PWC: {"model.chans": (8, 16, 16), "model.radius": 2,
          "model.hidden": 16,
          "model.losses.flow_l1_loss.weights": (1.0, 1.0, 0.5, 0.25)},
    RAFT: {"model.iters": 2, "model.hidden": 32, "model.context": 16,
           "model.losses.flow_l1_loss.weights": (1.0, 1.0, 0.8)},
}
SHAPES = {PWC: (2, 32, 64), RAFT: (2, 64, 64)}
SCORE_GAIN = 8.0


def configs(family, suffix="_f32", **extra):
    """(JAX config, port config) of ``family`` + ``suffix`` at the tiny
    size."""
    over = dict(OVERRIDES[family], **extra)
    return (jget_config(family + suffix, **over),
            get_config(family + suffix, **over))


def shared_weights(family, seed=0):
    """The port's tiny float32 module of ``family`` with randomized
    weights, and the same weights as a numpy Flax tree."""
    module = build_model(configs(family)[1],
                         torch.Generator().manual_seed(seed))
    variables = randomize(flax_variables(module), np.random.RandomState(seed))
    for name, sub in variables["params"].items():
        if name.startswith("FlowEstimator_"):
            conv = sub["ConvUnit_2"]["Conv_0"]
            conv["kernel"] = conv["kernel"] * SCORE_GAIN
    load_jax_variables(module, variables)
    return module, variables


def frames(family, seed=1, batch=None):
    """Normalized frames [B, H, W, 3]: the second one the first moved by
    (u, v) = (2, 1) px plus noise, so the flows have a target."""
    b, h, w = SHAPES[family]
    b = batch or b
    rng = np.random.RandomState(seed)
    ref = rng.randn(b, h, w, 3).astype(np.float32)
    tgt = np.roll(ref, (1, 2), axis=(1, 2)) + 0.1 * rng.randn(
        b, h, w, 3).astype(np.float32)
    return ref, tgt.astype(np.float32)


def ground_truth(family, seed=2, batch=None):
    """Dense GT flow [B, H, W, 2] near the frames' (2, 1) px shift, a
    few pixels NaN (masked by the loss)."""
    b, h, w = SHAPES[family]
    b = batch or b
    rng = np.random.RandomState(seed)
    gt = np.stack([np.full((b, h, w), 2.0), np.full((b, h, w), 1.0)],
                  -1) + rng.randn(b, h, w, 2) * 0.5
    gt[:, :3, :5] = np.nan
    return gt.astype(np.float32)
