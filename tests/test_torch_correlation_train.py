"""One train step of PSMNet with the Correlation cost processor, the port
against JAX's ``make_train_step``, on the CPU.

Both sides build PSMNet/scene_flow_f32 with
``model.cost_processor.type=Correlation`` at tests/acfnet_parity.py's size
(max_disp 16, 2x32x64 frames, JAX's ``pack`` 0), start from the same
weights (the port's seeded tree with every BatchNorm drawn at random,
carried to JAX by ``flax_variables``) and take one step on one batch: the
port through its ``make_train_step`` and RMSprop, JAX through its jitted
step and optax chain. Held: the loss dict, the updated parameters and the
BN statistics. Tolerances are stated where they are asserted.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.losses import make_loss_evaluator as jmake_ev
from densematchingbenchmark_tpu.models import build_model as jbuild_model
from densematchingbenchmark_tpu.trainer.optim import (
    build_optimizer as jbuild_optimizer)
from densematchingbenchmark_tpu.trainer.state import TrainState as JState
from densematchingbenchmark_tpu.trainer.train_step import (
    make_train_step as jmake_train_step)

from densematchingbenchmark_tpu_torch.losses import (make_loss_evaluator,
                                                     total_loss)
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                      build_optimizer,
                                                      make_train_step)
from densematchingbenchmark_tpu_torch.utils import flax_variables

from acfnet_parity import batch, flat, jit_call
from test_torch_correlation import configs, shared_weights

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

NAME = "PSMNet/scene_flow_f32"
STEPS_PER_EPOCH = 10


def find_nu(opt_state):
    found = [s.nu for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "nu")) if hasattr(s, "nu")]
    assert len(found) == 1
    return found[0]


@pytest.fixture(scope="module")
def one_step():
    """The port and JAX after one train step from the same weights."""
    jcfg, cfg = configs(NAME)
    module, variables = shared_weights(cfg)
    data = batch(2)
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    ev = make_loss_evaluator(cfg["model"]["losses"])
    # the port's raw gradients, on a copy (train mode moves BN stats)
    probe = copy.deepcopy(module).train()
    out = probe(tbatch["leftImage"], tbatch["rightImage"])
    loss = total_loss(ev(out["disps"], out["costs"], tbatch["leftDisp"]))
    names = [n for n, _ in probe.named_parameters()]
    grads = torch.autograd.grad(loss, list(probe.parameters()))
    opt, schedule = build_optimizer(cfg, module, STEPS_PER_EPOCH)
    state = TrainState.create(module, opt, seed=1)
    kernels.reset_launch_counts()
    state, metrics = make_train_step(ev)(state, tbatch)
    port = {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flat(flax_variables(probe, dict(zip(names, grads)))[
                "params"]),
            "after": flax_variables(module), "lr0": schedule(0),
            "launches": kernels.launch_counts()}

    tx, _ = jbuild_optimizer(jcfg, STEPS_PER_EPOCH)
    jstate = JState.create(jax.tree.map(jnp.asarray, variables), tx,
                           jax.random.PRNGKey(1))
    step = jmake_train_step(jbuild_model(jcfg), tx,
                            jmake_ev(jcfg["model"]["losses"]), donate=False)
    new_state, jmetrics = jit_call(step, jstate, {
        k: jnp.asarray(v) for k, v in data.items()})
    # JAX's raw gradients, from its optimizer state: after one step
    # RMSprop's nu is (1 - 0.99) g_clipped^2 and the update has the sign
    # of -g; the clip factor follows from the logged grad_norm
    jmetrics = {k: float(v) for k, v in jmetrics.items()}
    clip = min(1.0, jcfg["grad_clip"]["max_norm"] / jmetrics["grad_norm"])
    before, after = flat(jstate.params), flat(new_state.params)
    nu = flat(find_nu(new_state.opt_state))
    want = {"metrics": jmetrics,
            "grads": {k: -np.sign(after[k] - before[k])
                      * np.sqrt(nu[k] / 0.01) / clip for k in before},
            "before": before,
            "after": {"params": flat(new_state.params),
                      "batch_stats": flat(new_state.batch_stats)}}
    return port, want


def test_correlation_train_loss_matches_jax(one_step):
    port, want = one_step
    assert sorted(port["metrics"]) == sorted(want["metrics"]) == [
        "grad_norm", "l1_loss_lvl0", "l1_loss_lvl1", "l1_loss_lvl2", "loss"]
    for k, v in want["metrics"].items():
        # float32 through the whole network in another summation order
        # (tests/test_torch_train_step.py's bound)
        np.testing.assert_allclose(port["metrics"][k], v, rtol=2e-4,
                                   err_msg=k)
    # on the CPU every wrapper ran its plain version and counted nothing
    assert set(port["launches"].values()) == {0}


def test_correlation_train_updated_params_match_jax(one_step):
    """The first RMSprop update is -lr g / sqrt(0.01 g^2 + eps): about
    10 lr sign(g) for |g| >> 1e-3, and continuous through g = 0 with slope
    lr / sqrt(eps) (eps inside the root). So the two sides' parameters
    differ by at most that slope times their gradients' difference, plus
    float32 rounding (tests/test_torch_train_step.py's bound); the first
    unit takes the one-channel correlation volume."""
    port, want = one_step
    got, grads = flat(port["after"]["params"]), port["grads"]
    assert sorted(got) == sorted(want["after"]["params"])
    # the gradients agree as the float32 network's own floor lets them
    # (cosine above 0.999 over all of them; the per-leaf bounds are
    # tests/test_torch_train_step.py's)
    g = np.concatenate([grads[k].ravel() for k in sorted(grads)])
    w = np.concatenate([want["grads"][k].ravel() for k in sorted(grads)])
    assert (g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w)) > 0.999
    slope = port["lr0"] / np.sqrt(1e-8)
    for k, w in want["after"]["params"].items():
        tol = 2e-5 + slope * np.abs(grads[k] - want["grads"][k])
        assert (np.abs(got[k] - w) <= tol).all(), "/".join(k)
    first = ("cost_processor", "aggregator", "ConvUnit_0", "Conv_0",
             "kernel")
    assert got[first].shape == (3, 3, 3, 1, 32)
    moved = np.abs(want["after"]["params"][first] - want["before"][first])
    assert moved.max() > 0


def test_correlation_train_bn_stats_match_jax(one_step):
    port, want = one_step
    got = flat(port["after"]["batch_stats"])
    assert sorted(got) == sorted(want["after"]["batch_stats"])
    for k, w in want["after"]["batch_stats"].items():
        # Flax E[x^2] - E[x]^2 vs torch's two-pass variance, float32
        # (tests/test_torch_train_step.py's bound)
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg="/".join(k))
