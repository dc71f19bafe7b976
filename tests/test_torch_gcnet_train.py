"""One train step of the port's GCNet against the JAX package's, on the
CPU: the losses, every gradient and the BN statistics, at the size and
on the weights of tests/test_torch_gcnet.py (its helpers), with JAX's
schedules off (that file holds the eval against the shipped ones).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.losses import make_loss_evaluator as jmake_ev
from densematchingbenchmark_tpu.losses.builder import total_loss as jtotal
from densematchingbenchmark_tpu.models import build_model as jbuild_model

from densematchingbenchmark_tpu_torch.losses import make_loss_evaluator
from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                      make_train_step)
from densematchingbenchmark_tpu_torch.utils import flax_variables

from acfnet_parity import flat, jit_call
from test_torch_gcnet import (NAME, OFF, batch, configs, shared_weights,
                              to_numpy)

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def train_case():
    """One train-mode step on both sides (the schedules off: the eval
    cases hold the port against JAX's shipped ones): the port's
    ``make_train_step`` with an optimizer that keeps the gradients, JAX's
    model and loss evaluator under one jitted ``jax.value_and_grad``."""
    jcfg, cfg = configs(NAME + "_f32", **OFF)
    module, variables = shared_weights(cfg, seed=2)
    data = batch(3)

    class KeepGrads:
        def __init__(self, module):
            self.names = [n for n, _ in module.named_parameters()]
            self.params = list(module.parameters())

        def step(self, grads, grad_norm=None):
            self.grads = dict(zip(self.names, grads))

    opt = KeepGrads(module)
    state = TrainState.create(module, opt, seed=1)
    _, metrics = make_train_step(make_loss_evaluator(
        cfg["model"]["losses"]))(
        state, {k: torch.from_numpy(v) for k, v in data.items()})
    port = {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flat(flax_variables(module, opt.grads)["params"]),
            "batch_stats": flat(flax_variables(module)["batch_stats"])}

    jmodel = jbuild_model(jcfg)
    ev = jmake_ev(jcfg["model"]["losses"])

    def loss_fn(params, batch_stats):
        out, upd = jmodel.apply({"params": params,
                                 "batch_stats": batch_stats},
                                data["leftImage"], data["rightImage"],
                                train=True, mutable=["batch_stats"])
        ld = ev(out["disps"], out["costs"], data["leftDisp"])
        return jtotal(ld), (ld, upd["batch_stats"])

    v = jax.tree.map(jnp.asarray, variables)
    (loss, (ld, stats)), g = jit_call(jax.value_and_grad(
        loss_fn, has_aux=True), v["params"], v["batch_stats"])
    want = {"metrics": {"loss": float(loss),
                        **{k: float(x) for k, x in ld.items()}},
            "grads": flat(to_numpy(g)), "batch_stats": flat(to_numpy(stats))}
    return port, want


def test_gcnet_train_step_matches_jax(train_case):
    """The loss within 3e-5 relative (tests/test_torch_acfnet_train.py's
    bound); per gradient leaf cosine above 0.999 and relative L2 error
    below 3e-2 (tests/test_torch_train_step.py's), except the conv biases
    that feed batch-statistics BN (the stem's) and the head's bias, a
    shift of every disparity's cost to which the soft-argmin is blind:
    zero in exact arithmetic, float32 noise on both sides (below 1e-6 of
    the largest gradient); BN statistics within 1e-4 relative."""
    port, want = train_case
    keys = ["l1_loss_lvl0", "loss"]
    assert sorted(want["metrics"]) == keys
    for k in keys:
        np.testing.assert_allclose(port["metrics"][k], want["metrics"][k],
                                   rtol=3e-5, err_msg=k)
    got, ref = port["grads"], want["grads"]
    assert sorted(got) == sorted(ref)
    top = max(float(np.abs(w).max()) for w in ref.values())
    zero = {("backbone", "stem", "Conv_0", "bias"),
            ("cost_processor", "aggregator", "ConvTransposeExact_0",
             "bias")}
    for k, g in got.items():
        w = ref[k]
        assert g.shape == w.shape, k
        if k in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-4 * top, k
            continue
        cos = float((g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w)))
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert cos > 0.999 and rel < 3e-2, ("/".join(k), cos, rel)
    for k, w in want["batch_stats"].items():
        np.testing.assert_allclose(port["batch_stats"][k], w, rtol=1e-4,
                                   atol=1e-5, err_msg="/".join(k))
