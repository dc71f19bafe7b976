"""The port's DeepPruner Fast (8x) model against the JAX package's, on the
CPU: its eval under both scorings in float32 (every disparity within
1e-3 px), with JAX's PatchMatch noise injected, at max_disp 64 on 64x128
frames (the 8x features' hourglasses need H / 64 whole). Helpers, sizes
and the rest of the family: tests/test_torch_deeppruner.py; bfloat16:
tests/test_torch_deeppruner_bf16.py.
"""

import pytest
import torch

from test_torch_deeppruner import (FAST, assert_disps_match, batch, configs,
                                   flax_tree_matches_jax, run_eval,
                                   shared_weights)

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

SIZE = (64, 128)
def test_deeppruner_fast_flax_tree_matches_jax():
    flax_tree_matches_jax(FAST, SIZE)


@pytest.fixture(scope="module")
def fast_case():
    _, cfg = configs(FAST + "_f32")
    _, variables = shared_weights(cfg)
    cases = {s: (FAST + "_f32", {"model.disp_sampler.scoring": s})
             for s in ("corr", "warp")}
    return run_eval(cases, batch(1, SIZE), variables)


@pytest.mark.parametrize("scoring", ["corr", "warp"])
def test_deeppruner_fast_eval_matches_jax(fast_case, scoring):
    """Refined (1/2 and full), post, min and max within 1e-3 px of JAX's
    (float32 in another summation order; measured about 1e-5)."""
    got, want = fast_case
    assert len(got[scoring]["disps"]) == 5
    assert_disps_match(got[scoring], want[scoring])
