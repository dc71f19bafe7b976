"""One train step of the port's AnyNet against the JAX package's, on the
CPU: the four L1 losses, every gradient leaf (the first stage's, whose
gradient comes back through the later stages' warps, and the SPN
refinement's among them) and the BN statistics in float32, and a
bfloat16 step's loss; at the size and on the weights of
tests/test_torch_anynet.py (its helpers: the shipped config on 64x128
frames).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.configs import get_config as jget_config
from densematchingbenchmark_tpu.losses import make_loss_evaluator as jmake_ev
from densematchingbenchmark_tpu.losses.builder import total_loss as jtotal
from densematchingbenchmark_tpu.models import build_model as jbuild_model

from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.losses import make_loss_evaluator
from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                      make_train_step)
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

from acfnet_parity import flat, jit_call
from test_torch_anynet import NAME, batch, shared_weights, to_numpy

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

LOSSES = [f"l1_loss_lvl{i}" for i in range(4)]


class KeepGrads:
    """An optimizer that keeps the gradients of the step and updates
    nothing."""

    def __init__(self, module):
        self.names = [n for n, _ in module.named_parameters()]
        self.params = list(module.parameters())

    def step(self, grads, grad_norm=None):
        self.grads = dict(zip(self.names, grads))


def port_step(name, variables, data):
    """The port's ``make_train_step`` on ``name`` with ``variables``:
    (metrics, the module, the optimizer that kept the gradients)."""
    cfg = get_config(name)
    module, _ = shared_weights(cfg)
    load_jax_variables(module, variables)
    opt = KeepGrads(module)
    state = TrainState.create(module, opt, seed=1)
    _, metrics = make_train_step(make_loss_evaluator(
        cfg["model"]["losses"]))(
        state, {k: torch.from_numpy(v) for k, v in data.items()})
    return {k: float(v) for k, v in metrics.items()}, module, opt


@pytest.fixture(scope="module")
def train_case():
    """One train-mode step in float32 on both sides (JAX's model and loss
    evaluator under one jitted ``jax.value_and_grad``) and the loss of a
    bfloat16 one (JAX's train-mode forward and losses, jitted once)."""
    variables = shared_weights(get_config(NAME + "_f32"), seed=2)[1]
    data = batch(3)
    metrics, module, opt = port_step(NAME + "_f32", variables, data)
    port = {"metrics": metrics,
            "grads": flat(flax_variables(module, opt.grads)["params"]),
            "batch_stats": flat(flax_variables(module)["batch_stats"]),
            "bf16": port_step(NAME + "_bf16", variables, data)[0]}

    v = jax.tree.map(jnp.asarray, variables)

    def losses(name):
        jcfg = jget_config(name)
        jmodel, ev = jbuild_model(jcfg), jmake_ev(jcfg["model"]["losses"])

        def loss_fn(params, batch_stats):
            out, upd = jmodel.apply({"params": params,
                                     "batch_stats": batch_stats},
                                    data["leftImage"], data["rightImage"],
                                    train=True, mutable=["batch_stats"])
            ld = ev(out["disps"], out["costs"], data["leftDisp"])
            return jtotal(ld), (ld, upd["batch_stats"])
        return loss_fn

    (loss, (ld, stats)), g = jit_call(jax.value_and_grad(
        losses(NAME + "_f32"), has_aux=True), v["params"], v["batch_stats"])
    bf16_loss, _ = jit_call(losses(NAME + "_bf16"), v["params"],
                            v["batch_stats"])
    want = {"metrics": {"loss": float(loss),
                        **{k: float(x) for k, x in ld.items()}},
            "grads": flat(to_numpy(g)), "batch_stats": flat(to_numpy(stats)),
            "bf16": float(bf16_loss)}
    return port, want


def test_anynet_train_losses_match_jax(train_case):
    """The four levels' L1 losses (weights 1.0, 1.0, 0.5, 0.25 over the
    refined and the three stages' disparities) and their sum within 3e-5
    relative, the bound of tests/test_torch_acfnet_train.py."""
    port, want = train_case
    assert sorted(want["metrics"]) == LOSSES + ["loss"]
    assert sorted(port["metrics"]) == sorted(LOSSES + ["loss", "grad_norm"])
    for k in LOSSES + ["loss"]:
        np.testing.assert_allclose(port["metrics"][k], want["metrics"][k],
                                   rtol=3e-5, err_msg=k)


def test_anynet_train_gradients_match_jax(train_case):
    """Per leaf, as tests/test_torch_train_step.py holds PSMNet's: cosine
    above 0.999 and relative L2 error below 3e-2. The aggregators' conv
    biases are zero in exact arithmetic: each of ConvUnit_0..4's feeds the
    next unit's batch-statistics BN, and ConvUnit_5's (Co = 1) shifts
    every sample's cost, to which the soft-argmin is blind. Those 18 are
    float32 noise on both sides, below 1e-6 of the largest gradient.
    Every other leaf has a gradient, the first stage's (through the
    later stages' warps and the refinement's scan) and the SPN's among
    them."""
    port, want = train_case
    got, ref = port["grads"], want["grads"]
    assert sorted(got) == sorted(ref)
    top = max(float(np.abs(w).max()) for w in ref.values())
    zero = {k for k in got if k[0].startswith("agg_") and k[-1] == "bias"
            and k[-2] == "Conv_0"}
    assert len(zero) == 18
    checked = set()
    for k, g in got.items():
        w = ref[k]
        assert g.shape == w.shape, k
        if k in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-6 * top, k
            continue
        assert np.abs(w).max() > 0, k
        cos = float((g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w)))
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert cos > 0.999 and rel < 3e-2, ("/".join(k), cos, rel)
        checked.add(k[0])
    assert checked == {"backbone", "agg_init_guess", "agg_warp_level_8",
                       "agg_warp_level_4", "disp_refinement"}


def test_anynet_train_bn_stats_match_jax(train_case):
    port, want = train_case
    got = port["batch_stats"]
    assert sorted(got) == sorted(want["batch_stats"])
    for k, w in want["batch_stats"].items():
        # Flax E[x^2] - E[x]^2 vs torch's two-pass variance, float32
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg="/".join(k))


def test_anynet_bf16_train_loss_matches_jax(train_case):
    """A bfloat16 train step's loss within 1 % of JAX's bfloat16 one, and
    apart from the float32 loss (the step does run in bfloat16)."""
    port, want = train_case
    np.testing.assert_allclose(port["bf16"]["loss"], want["bf16"],
                               rtol=1e-2)
    assert port["bf16"]["loss"] != port["metrics"]["loss"]
