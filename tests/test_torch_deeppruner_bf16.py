"""The port's DeepPruner Fast (8x) model in bfloat16 against the JAX
package's, on the CPU, by StereoNet's rule, at the size and on the
weights of tests/test_torch_deeppruner_8x.py (helpers:
tests/test_torch_deeppruner.py).
"""

import numpy as np
import pytest
import torch

from test_torch_deeppruner import FAST, batch, configs, run_eval, \
    shared_weights

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

SIZE = (64, 128)
# JAX's bfloat16 refinement at its plain schedule: its row-packed one
# (the config's ``pack`` 4) rounds more in bfloat16 on XLA's CPU back end.
# Measured at this size: JAX's own bfloat16-vs-float32 mean gap on the two
# refined disparities is 0.151 / 0.089 px at pack 4 and 0.0020 / 0.0020 px
# at pack 0, the port's 0.0023 / 0.0023 px.
PLAIN = {"model.disp_refinement.pack": 0}


@pytest.fixture(scope="module")
def bf16_case():
    _, cfg = configs(FAST + "_f32")
    _, variables = shared_weights(cfg)
    cases = {"bf16": (FAST + "_bf16", PLAIN), "f32": (FAST + "_f32", PLAIN)}
    return run_eval(cases, batch(1, SIZE), variables)


def test_deeppruner_fast_bf16_eval_matches_jax(bf16_case):
    """Bfloat16 on both sides (the shipped scoring, JAX's refinement at
    its plain schedule: ``PLAIN``), by StereoNet's rule
    (tests/test_torch_stereonet.py): every disparity within 0.05 px mean
    of JAX's, and the port's own bfloat16-vs-float32 mean gap between 0.8x
    and 1.25x JAX's on each (the lower side fails a model that ignores
    bfloat16)."""
    got, want = bf16_case
    for g, w, g32, w32 in zip(got["bf16"]["disps"], want["bf16"]["disps"],
                              got["f32"]["disps"],
                              want["f32"]["disps"]):
        assert g.dtype == torch.float32
        g, g32 = g.numpy(), g32.numpy()
        gap = np.abs(g - w).mean()
        own, jax_own = np.abs(g - g32).mean(), np.abs(w - w32).mean()
        assert gap < 0.05, (gap, own, jax_own)
        assert 0.8 * jax_own <= own <= 1.25 * jax_own + 1e-3, (gap, own,
                                                               jax_own)
