"""One train step of a flow model in the port against the JAX package's
``make_flow_train_step`` math (tests/test_torch_flow_train.py,
tests/test_torch_raft_train.py): the model in train mode with its BN
statistics mutable, the multi-scale flow loss and its total under one
jitted ``jax.value_and_grad``, and the port's ``make_flow_train_step``
with an optimizer that keeps the gradients; at the tiny sizes and on the
shared weights of tests/flow_parity.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from densematchingbenchmark_tpu.flow.losses import flow_l1_loss as jloss
from densematchingbenchmark_tpu.flow.models import (
    build_flow_model as jbuild_flow)
from densematchingbenchmark_tpu.losses.builder import total_loss as jtotal

from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                      make_flow_train_step)
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

from acfnet_parity import flat, jit_call
from flow_parity import configs, frames, ground_truth, shared_weights


class KeepGrads:
    """An optimizer that keeps the gradients of the step and updates
    nothing."""

    def __init__(self, module):
        self.names = [n for n, _ in module.named_parameters()]
        self.params = list(module.parameters())

    def step(self, grads, grad_norm=None):
        self.grads = dict(zip(self.names, grads))


def port_step(family, suffix, variables, data):
    """(metrics, module, optimizer) of the port's flow train step."""
    cfg = configs(family, suffix)[1]
    module = build_model(cfg)
    load_jax_variables(module, variables)
    opt = KeepGrads(module)
    state = TrainState.create(module, opt, seed=1)
    weights = cfg["model"]["losses"]["flow_l1_loss"]["weights"]
    _, metrics = make_flow_train_step(weights)(
        state, {k: torch.from_numpy(v) for k, v in data.items()})
    return {k: float(v) for k, v in metrics.items()}, module, opt


def train_case(family):
    """One float32 train step on both sides (losses, every gradient leaf,
    the BN statistics after the step) and a bfloat16 step's loss."""
    variables = shared_weights(family, seed=3)[1]
    ref, tgt = frames(family, seed=4)
    data = {"leftImage": ref, "rightImage": tgt,
            "flow": ground_truth(family, seed=5)}
    metrics, module, opt = port_step(family, "_f32", variables, data)
    port = {"metrics": metrics,
            "grads": flat(flax_variables(module, opt.grads)["params"]),
            "batch_stats": flat(flax_variables(module)["batch_stats"]),
            "bf16": port_step(family, "_bf16", variables, data)[0]}

    def losses(suffix):
        jcfg = configs(family, suffix)[0]
        jmodel = jbuild_flow(jcfg)
        weights = jcfg["model"]["losses"]["flow_l1_loss"]["weights"]

        def loss_fn(params, batch_stats):
            out, upd = jmodel.apply(
                {"params": params, "batch_stats": batch_stats},
                data["leftImage"], data["rightImage"], train=True,
                mutable=["batch_stats"])
            ld = jloss(out["flows"], data["flow"], weights)
            return jtotal(ld), (ld, upd["batch_stats"])
        return loss_fn

    v = jax.tree.map(jnp.asarray, variables)
    (loss, (ld, stats)), g = jit_call(jax.value_and_grad(
        losses("_f32"), has_aux=True), v["params"], v["batch_stats"])
    bf16_loss, _ = jit_call(losses("_bf16"), v["params"], v["batch_stats"])
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    want = {"metrics": {"loss": float(loss),
                        **{k: float(x) for k, x in ld.items()}},
            "grads": flat(to_np(g)), "batch_stats": flat(to_np(stats)),
            "bf16": float(bf16_loss)}
    return port, want


def check_losses(port, want, n_flows):
    """Each level's loss and their sum within 3e-5 relative (the bound of
    tests/test_torch_acfnet_train.py)."""
    keys = [f"flow_loss_lvl{i}" for i in range(n_flows)]
    assert sorted(want["metrics"]) == sorted(keys + ["loss"])
    assert sorted(port["metrics"]) == sorted(keys + ["loss", "grad_norm"])
    for k in keys + ["loss"]:
        np.testing.assert_allclose(port["metrics"][k], want["metrics"][k],
                                   rtol=3e-5, err_msg=k)


def check_gradients(port, want, zero=()):
    """Per leaf, as tests/test_torch_train_step.py holds PSMNet's: cosine
    above 0.999 and relative L2 error below 3e-2; the leaves in ``zero``
    (zero in exact arithmetic) below 1e-6 of the largest gradient on
    both sides. Returns the top-level modules that had a gradient."""
    got, ref = port["grads"], want["grads"]
    assert sorted(got) == sorted(ref)
    top = max(float(np.abs(w).max()) for w in ref.values())
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
    return checked


def check_bn_stats(port, want):
    """The running statistics after the step (the siamese encoder's moved
    twice, once a frame, in order) within 1e-4 relative (Flax's
    E[x^2] - E[x]^2 against torch's two-pass variance, float32)."""
    got = port["batch_stats"]
    assert sorted(got) == sorted(want["batch_stats"])
    for k, w in want["batch_stats"].items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg="/".join(k))


def check_bf16_loss(port, want):
    """A bfloat16 step's loss within 1 % of JAX's bfloat16 one, and apart
    from the float32 loss (the step does run in bfloat16)."""
    np.testing.assert_allclose(port["bf16"]["loss"], want["bf16"], rtol=1e-2)
    assert port["bf16"]["loss"] != port["metrics"]["loss"]
