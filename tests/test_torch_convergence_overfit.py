"""JAX's CPU convergence criterion, met by the port's
tools/convergence_gauntlet.py on the loss paths PSMNet's overfit test
(tests/test_torch_overfit.py) does not reach: AcfNet-adaptive's cmn and
focal losses, AnyNet's SPN and PWCFlow's sequence loss (DeepPruner-4x's
quantile loss through PatchMatch: tests/test_torch_convergence_deeppruner.py,
a file of its own, about 60 s on one worker, so that another worker can
take it).

Each runs exactly JAX's tests/test_convergence_gauntlet.py case: the
port's counterpart of its tiny config (__graft_entry__'s overrides on the
port's config, float32), its CI sizes (24 steps on one batch of 2 at
64x96 from 96x160 frames, disparities up to 12 or flows up to 4), its
speed overrides (lr 2e-3, no warmup), from JAX's initial weights of that
case (``model.init(PRNGKey(0), ...)``, carried by load_jax_variables into
the module the tool builds): the same start, data and optimizer as JAX's
test, so the runs differ only by float32 rounding. The criterion: the loss
at step 24 below 0.7 of step 1's and the batch's EPE down.

AcfNet-adaptive's loss ratio is not a stable quantity at this size: from
the same start JAX's own run ends at 0.681 and, with its initial weights
scaled by 1 + 1e-7 N(0, 1), at 0.829 and 0.830; the port's ends at 0.736
(its trajectory follows JAX's to 1e-3 for 8 steps, then both diverge as
RMSprop's sign-like first updates amplify rounding). Its case holds the
descent every one of those runs shows (the loss and the EPE down), not the
0.7 ratio (ROADMAP §3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as ge
from densematchingbenchmark_tpu.configs import get_config as jget_config
from densematchingbenchmark_tpu.flow.models import (
    build_flow_model as jbuild_flow_model)
from densematchingbenchmark_tpu.models import build_model as jbuild_model

from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.tools import (
    convergence_gauntlet as gauntlet)
from densematchingbenchmark_tpu_torch.utils import load_jax_variables

from acfnet_parity import jit_call

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

# JAX's CI sizes (tests/test_convergence_gauntlet.py:21-27)
KW = dict(steps=24, batch=2, crop_hw=(64, 96), gen_hw=(96, 160),
          gen_max_disp=12, train_len=8, eval_len=2, log_every=4,
          overfit=True, device="cpu")
FLOW_KW = dict({k: v for k, v in KW.items() if k != "gen_max_disp"},
               max_flow=4)
DROP = 0.7    # JAX's criterion: loss_last < DROP * loss_first
M = 32
# __graft_entry__'s overrides of the tiny configs
TINY = {"AcfNet-adaptive": (
            "AcfNet/scene_flow_adaptive", ge._tiny_acfnet_cfg,
            {"model.max_disp": M,
             "model.cost_processor.cost_computation.max_disp": M // 4,
             "model.cost_processor.cost_aggregator.max_disp": M,
             "model.disp_predictor.max_disp": M,
             "model.losses.l1_loss.max_disp": M,
             "model.losses.focal_loss.max_disp": M,
             "model.cmn.in_planes": M,
             "model.cmn.losses.nll_loss.max_disp": M}),
        "DeepPruner-4x": (
            "DeepPruner/scene_flow_4x", ge._tiny_deeppruner_cfg,
            {"model.max_disp": M,
             "model.disp_sampler.max_disp": M // 4,
             "model.losses.l1_loss.max_disp": M,
             "model.losses.quantile_loss.max_disp": M}),
        "AnyNet": ("AnyNet/scene_flow", None, {}),
        "PWCFlow": ("PWCFlow/flying_chairs", None, {})}


def speed(cfg):
    """JAX's _speed_overrides: lr 2e-3, no warmup."""
    cfg["optimizer"]["lr"] = 2e-3
    cfg.setdefault("lr_schedule", {})["warmup_iters"] = 0
    return cfg


def run_from_jax_init(monkeypatch, family):
    """The gauntlet's overfit run of ``family`` at JAX's CI sizes, the
    module built by the tool carrying JAX's initial weights of the same
    case."""
    name, factory, over = TINY[family]
    jcfg = factory() if factory else jget_config(name)
    assert jcfg == jget_config(name, **over)
    flow = family == "PWCFlow"
    jmodel = (jbuild_flow_model if flow else jbuild_model)(jcfg)
    dummy = jnp.zeros((KW["batch"],) + KW["crop_hw"] + (3,), jnp.float32)
    variables = jax.tree.map(np.asarray, jit_call(
        lambda d: jmodel.init(jax.random.PRNGKey(0), d, d, train=False),
        dummy))
    name_of_build = "build_flow_model" if flow else "build_model"
    build = getattr(gauntlet, name_of_build)
    monkeypatch.setattr(gauntlet, name_of_build, lambda cfg, generator:
                        load_jax_variables(build(cfg, generator), variables))
    cfg = speed(get_config(name + "_f32", **over))
    if flow:
        return gauntlet.run_flow_family(cfg, **FLOW_KW)
    return gauntlet.run_stereo_family(cfg, **KW)


@pytest.mark.parametrize("family", ["AnyNet", "PWCFlow"])
def test_family_meets_jax_criterion(monkeypatch, family):
    r = run_from_jax_init(monkeypatch, family)
    assert [s for s, _ in r["losses"]] == [1, 4, 8, 12, 16, 20, 24]
    assert r["loss_last"] < DROP * r["loss_first"], r
    assert r["epe_final"] < r["epe_init"], r


def test_acfnet_adaptive_descends(monkeypatch):
    r = run_from_jax_init(monkeypatch, "AcfNet-adaptive")
    assert np.isfinite([v for _, v in r["losses"]]).all()
    assert r["loss_last"] < r["loss_first"], r
    assert r["epe_final"] < r["epe_init"], r
