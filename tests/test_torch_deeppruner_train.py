"""One train step of the port's DeepPruner Fast (8x) model against the JAX package's, on the CPU: the losses (the smooth-L1
levels over the five disparities and the quantile loss on the predicted
range), every gradient and the BN statistics, at the size and on the
weights of tests/test_torch_deeppruner.py (its helpers), 64x128 frames,
batch 2 (the SPP branches' batch-statistics BN sees 2 x 2 values a
channel there; at batch 1 it sees 2, and float32 differences in their
gradients grow past the bound). JAX's trace and compile of the step take
about 25 s of this file's time.

JAX's train step draws the PatchMatch noise from the 'patch_match' rng
that the caller passes; here JAX's model is handed a fixed key instead
(its ``patch_match`` wrapped), the port's the draw JAX makes from it,
[B, n, H', W'] (no broadcast in training). Also: a port model in
training draws its noise from the generator it is given, and refuses to
run without one.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.losses import make_loss_evaluator as jmake_ev
from densematchingbenchmark_tpu.losses.builder import total_loss as jtotal
from densematchingbenchmark_tpu.models import build_model as jbuild_model
from densematchingbenchmark_tpu.models import deeppruner as jdeeppruner

from densematchingbenchmark_tpu_torch.losses import make_loss_evaluator
from densematchingbenchmark_tpu_torch.models import deeppruner as tdeeppruner
from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                      make_train_step)
from densematchingbenchmark_tpu_torch.utils import flax_variables

from acfnet_parity import flat, jit_call
from test_torch_deeppruner import (BEST, FAST, batch, configs,
                                   shared_weights, to_numpy)

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

SIZE = (64, 128)
KEY = jax.random.PRNGKey(11)


class KeepGrads:
    """An optimizer that keeps the gradients of the step and updates
    nothing."""

    def __init__(self, module):
        self.names = [n for n, _ in module.named_parameters()]
        self.params = list(module.parameters())

    def step(self, grads, grad_norm=None):
        self.grads = dict(zip(self.names, grads))


@pytest.fixture(scope="module")
def train_case():
    jcfg, cfg = configs(FAST + "_f32")
    module, variables = shared_weights(cfg, seed=2)
    data = batch(3, SIZE, b=2)
    b, h, w = data["leftImage"].shape[0], SIZE[0] // 8, SIZE[1] // 8
    noise = np.array(jax.random.uniform(KEY, (b, 12, h, w), jnp.float32))

    # the port: its patch_match handed JAX's draw
    real = tdeeppruner.patch_match

    def injected(*args, generator=None, noise=None, **kw):
        assert generator is not None      # the train step's
        return real(*args, noise=torch.from_numpy(noise_arr), **kw)
    noise_arr = noise
    opt = KeepGrads(module)
    state = TrainState.create(module, opt, seed=1)
    tdeeppruner.patch_match = injected
    try:
        _, metrics = make_train_step(make_loss_evaluator(
            cfg["model"]["losses"]))(
            state, {k: torch.from_numpy(v) for k, v in data.items()})
    finally:
        tdeeppruner.patch_match = real
    port = {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flat(flax_variables(module, opt.grads)["params"]),
            "batch_stats": flat(flax_variables(module)["batch_stats"])}

    # JAX: its patch_match handed KEY
    jreal = jdeeppruner.patch_match

    def keyed(left, right, lo, hi, key, *args, **kw):
        return jreal(left, right, lo, hi, KEY, *args, **kw)
    jmodel = jbuild_model(jcfg)
    ev = jmake_ev(jcfg["model"]["losses"])

    def loss_fn(params, batch_stats):
        out, upd = jmodel.apply({"params": params,
                                 "batch_stats": batch_stats},
                                data["leftImage"], data["rightImage"],
                                train=True, mutable=["batch_stats"],
                                rngs={"patch_match": jax.random.PRNGKey(0)})
        ld = ev(out["disps"], out["costs"], data["leftDisp"],
                min_disparity=out["min_disparity"],
                max_disparity=out["max_disparity"])
        return jtotal(ld), (ld, upd["batch_stats"])

    v = jax.tree.map(jnp.asarray, variables)
    jdeeppruner.patch_match = keyed
    try:
        (loss, (ld, stats)), g = jit_call(jax.value_and_grad(
            loss_fn, has_aux=True), v["params"], v["batch_stats"])
    finally:
        jdeeppruner.patch_match = jreal
    want = {"metrics": {"loss": float(loss),
                        **{k: float(x) for k, x in ld.items()}},
            "grads": flat(to_numpy(g)), "batch_stats": flat(to_numpy(stats))}
    return port, want


def test_deeppruner_train_losses_match_jax(train_case):
    """Every loss entry and the total within 3e-5 relative (the bound of
    tests/test_torch_acfnet_train.py)."""
    port, want = train_case
    keys = [f"l1_loss_lvl{i}" for i in range(5)] + ["loss", "quantile_loss"]
    assert sorted(want["metrics"]) == keys
    assert sorted(port["metrics"]) == sorted(keys + ["grad_norm"])
    for k in keys:
        np.testing.assert_allclose(port["metrics"][k], want["metrics"][k],
                                   rtol=3e-5, err_msg=k)


def test_deeppruner_train_gradients_match_jax(train_case):
    """Per leaf, as tests/test_torch_train_step.py holds PSMNet's: cosine
    above 0.999 and relative L2 error below 3e-2. The conv biases that
    feed batch-statistics BN have a zero gradient in exact arithmetic:
    float32 noise on both sides, below 1e-6 of the largest gradient."""
    port, want = train_case
    got, ref = port["grads"], want["grads"]
    assert sorted(got) == sorted(ref)
    top = max(float(np.abs(w).max()) for w in ref.values())
    zero = {k for k in got if k[-2:] == ("Conv_0", "bias")
            and k[:-2] + ("BatchNorm_0", "scale") in got}
    for k, g in got.items():
        w = ref[k]
        assert g.shape == w.shape, k
        if k in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-6 * top, k
            continue
        cos = float((g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w)))
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert cos > 0.999 and rel < 3e-2, ("/".join(k), cos, rel)


def test_deeppruner_train_bn_stats_match_jax(train_case):
    port, want = train_case
    got = port["batch_stats"]
    assert sorted(got) == sorted(want["batch_stats"])
    for k, w in want["batch_stats"].items():
        # Flax E[x^2] - E[x]^2 vs torch's two-pass variance, float32
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg="/".join(k))


def test_deeppruner_training_draws_from_its_generator():
    """In training the model draws its PatchMatch noise from the
    generator it is given ([B, n, H', W'], advancing it): the same as the
    draw handed in as ``noise``; without either it raises."""
    _, cfg = configs(BEST + "_f32")
    module, _ = shared_weights(cfg)
    module.train()
    x = {k: torch.from_numpy(v) for k, v in batch(4, (32, 64)).items()}
    with pytest.raises(ValueError, match="generator"):
        module(x["leftImage"], x["rightImage"])
    state = torch.get_rng_state()
    with torch.no_grad():
        a = module(x["leftImage"], x["rightImage"],
                   generator=torch.Generator().manual_seed(9))
        noise = torch.rand((1, 12, 8, 16),
                           generator=torch.Generator().manual_seed(9))
        b = module(x["leftImage"], x["rightImage"], noise=noise)
    assert torch.equal(state, torch.get_rng_state())
    for d, e in zip(a["disps"], b["disps"]):
        torch.testing.assert_close(d, e, rtol=0, atol=0)
