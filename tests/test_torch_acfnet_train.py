"""One AcfNet train step of the port against JAX, on the CPU.

Both sides start from the same weights (tests/acfnet_parity.py) and take
the same batch in train mode (batch-statistics BN). JAX's side is its own
model and loss evaluator under one jitted ``jax.value_and_grad`` (the
loss function of its ``make_train_step``: the focal loss on the cmn's
variances, plus the cmn's NLL loss); the port's is its ``make_train_step``
with an optimizer that keeps the gradients it is handed. Held: the loss
dicts of both configs key by key, the adaptive step's gradients per leaf
(the focal loss's gradient reaches the cmn through the variance, as in
JAX) and BN statistics, and a bfloat16 step's losses. Then the port's
``train_matcher`` on AcfNet with its per-epoch evaluation, vis hook and
profiler window. Tolerances are stated where they are asserted.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.losses import make_loss_evaluator as jmake_ev
from densematchingbenchmark_tpu.losses.builder import total_loss as jtotal
from densematchingbenchmark_tpu.models import build_model as jbuild_model

from densematchingbenchmark_tpu_torch.data import (SyntheticStereoDataset,
                                                   transforms)
from densematchingbenchmark_tpu_torch.losses import make_loss_evaluator
from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                      make_train_step,
                                                      train_matcher)
from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics
from densematchingbenchmark_tpu_torch.utils import flax_variables

from acfnet_parity import M, batch, configs, flat, jit_call, shared_weights

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

UNIFORM = "AcfNet/scene_flow_uniform_f32"
ADAPTIVE = "AcfNet/scene_flow_adaptive_f32"
ADAPTIVE_BF16 = "AcfNet/scene_flow_adaptive_bf16"


class KeepGrads:
    """An optimizer that keeps the gradients of the step and updates
    nothing."""

    def __init__(self, module):
        self.names = [n for n, _ in module.named_parameters()]
        self.params = list(module.parameters())

    def step(self, grads, grad_norm=None):
        self.grads = dict(zip(self.names, grads))


def jax_step(name, variables, data, grads):
    """JAX's loss dict (and, with ``grads``, the gradients) and BN
    statistics of one train-mode step."""
    jcfg, _ = configs(name)
    model = jbuild_model(jcfg)
    ev = jmake_ev(jcfg["model"]["losses"],
                  cmn_losses_cfg=jcfg["model"].get("cmn", {}).get("losses"))

    def loss_fn(params, batch_stats):
        out, upd = model.apply({"params": params,
                                "batch_stats": batch_stats},
                               data["leftImage"], data["rightImage"],
                               train=True, mutable=["batch_stats"])
        ld = ev(out["disps"], out["costs"], data["leftDisp"],
                variance=out.get("variances"))
        if "conf_costs" in out:
            ld.update(ev.cmn_loss(out["conf_costs"], data["leftDisp"]))
        return jtotal(ld), (ld, upd["batch_stats"])

    v = jax.tree.map(jnp.asarray, variables)
    if grads:
        (loss, (ld, stats)), g = jit_call(jax.value_and_grad(
            loss_fn, has_aux=True), v["params"], v["batch_stats"])
    else:
        (loss, (ld, stats)), g = jit_call(loss_fn, v["params"],
                                          v["batch_stats"]), None
    return {"loss": float(loss), **{k: float(x) for k, x in ld.items()},
            "grads": None if g is None else flat(jax.tree.map(np.asarray,
                                                              g)),
            "batch_stats": flat(jax.tree.map(np.asarray, stats))}


def port_step(name, data):
    _, cfg = configs(name)
    module, variables = shared_weights(cfg, seed=0)
    ev = make_loss_evaluator(
        cfg["model"]["losses"],
        cmn_losses_cfg=cfg["model"].get("cmn", {}).get("losses"))
    opt = KeepGrads(module)
    state = TrainState.create(module, opt, seed=1)
    _, metrics = make_train_step(ev)(
        state, {k: torch.from_numpy(v) for k, v in data.items()})
    return variables, {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": flat(flax_variables(module, opt.grads)["params"]),
        "batch_stats": flat(flax_variables(module)["batch_stats"])}


@pytest.fixture(scope="module")
def steps():
    data = batch(2)
    out = {}
    for name in (UNIFORM, ADAPTIVE, ADAPTIVE_BF16):
        variables, port = port_step(name, data)
        out[name] = port, jax_step(name, variables, data,
                                   grads=name == ADAPTIVE)
    return out


def loss_keys(adaptive):
    levels = range(3)
    keys = [f"l1_loss_lvl{i}" for i in levels] + [
        f"stereo_focal_loss_lvl{i}" for i in levels]
    if adaptive:
        keys += [f"conf_loss_lvl{i}" for i in levels]
    return sorted(keys + ["loss"])


@pytest.mark.parametrize("name", [UNIFORM, ADAPTIVE])
def test_acfnet_train_loss_dict_matches_jax(steps, name):
    port, want = steps[name]
    got = port["metrics"]
    keys = loss_keys("adaptive" in name)
    assert sorted(got) == sorted(keys + ["grad_norm"])
    assert sorted(k for k in want if k not in ("grads", "batch_stats")) \
        == keys
    for k in keys:
        # Measured against a float64 run of the port: the port's entries
        # within 2e-7 relative, JAX's focal-loss entries up to 1.13e-5 and
        # its total 5e-6 (XLA's float32 log-softmax and sums)
        np.testing.assert_allclose(got[k], want[k], rtol=3e-5, err_msg=k)


def test_acfnet_adaptive_gradients_match_jax(steps):
    """The aggregator's and the cmn's leaves within 1e-4 of each leaf's
    largest |gradient| (JAX's); the cmn's include the focal loss's part,
    which flows through the variances. Measured against a float64 run of
    the port: both float32 sides within 4e-5 of their leaf's largest
    gradient there.

    The backbone's leaves are held as tests/test_torch_train_step.py holds
    PSMNet's: cosine above 0.999 and relative L2 error below 3e-2. Behind
    the cost volume and three soft-argmins their float32 gradients are as
    far from the float64 run on JAX's side (up to 5.9e-2 of a leaf's
    largest value) as on the port's (4.8e-2): the float32 network's own
    floor, not a difference of the two.

    Conv biases that feed batch-statistics BN have a zero gradient in
    exact arithmetic: float32 noise on both sides."""
    port, want = steps[ADAPTIVE]
    got, ref = port["grads"], want["grads"]
    assert sorted(got) == sorted(ref)
    top = max(float(np.abs(w).max()) for w in ref.values())
    zero = {k for k in got if k[-2:] == ("Conv_0", "bias")
            and k[:-2] + ("BatchNorm_0", "scale") in got}
    # the backbone's two downsample convs and the aggregator's 7 units
    assert len(zero) == 9
    for k, g in got.items():
        w = ref[k]
        assert g.shape == w.shape, k
        if k in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-6 * top, k
        elif k[0] == "backbone":
            cos = float((g * w).sum() / (np.linalg.norm(g)
                                         * np.linalg.norm(w)))
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert cos > 0.999 and rel < 3e-2, ("/".join(k), cos, rel)
        else:
            np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(),
                                       err_msg="/".join(k))
    cmn = [k for k in got if k[0] == "cmn"]
    assert len(cmn) == 12 and all(np.abs(got[k]).max() > 0 for k in cmn)


def test_acfnet_bn_stats_after_step_match_jax(steps):
    for name in (UNIFORM, ADAPTIVE):
        port, want = steps[name]
        got = port["batch_stats"]
        assert sorted(got) == sorted(want["batch_stats"])
        for k, w in want["batch_stats"].items():
            # Flax E[x^2] - E[x]^2 vs torch's two-pass variance, float32
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                       err_msg="/".join(k))


def test_acfnet_bf16_train_loss_matches_jax(steps):
    """A bfloat16 adaptive step on both sides: every loss entry within 1 %
    (tests/test_torch_bf16_train.py's bound for PSMNet)."""
    port, want = steps[ADAPTIVE_BF16]
    got = port["metrics"]
    for k in loss_keys(True):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, err_msg=k)


def test_train_matcher_runs_acfnet(tmp_path):
    """train_matcher on AcfNet adaptive: the focal and confidence losses
    logged per step, the per-epoch evaluation, the vis hook's panels (with
    the confidence maps) and the profiler window's trace."""
    _, cfg = configs(ADAPTIVE, **{"data.batch_size_per_device": 2,
                                  "lr_schedule.warmup_iters": 0})
    data = cfg["data"]
    ds = SyntheticStereoDataset(length=2, height=40, width=72,
                                max_disp=M - 4,
                                transform=transforms.make_train_transform(
                                    (32, 64), data["mean"], data["std"]))
    eval_ds = SyntheticStereoDataset(length=1, height=32, width=64,
                                     max_disp=M - 4, seed=7,
                                     transform=transforms.make_eval_transform(
                                         (32, 64), data["mean"],
                                         data["std"]))
    work = str(tmp_path)
    state = train_matcher(cfg, work, train_dataset=ds, eval_dataset=eval_ds,
                          max_steps=1, log_interval=1, device="cpu",
                          profile_steps=(1, 1))
    assert state.step == 1
    records = read_metrics(work)
    train = [r for r in records if "train/loss" in r]
    assert [r["step"] for r in train] == [1]
    for r in train:
        assert {f"train/{k}" for k in loss_keys(True)} <= set(r)
        assert np.isfinite(list(r.values())).all()
    assert [r["step"] for r in records if "eval/disp_0/epe" in r] == [1]
    assert "conf_0_1.png" in os.listdir(os.path.join(work, "vis",
                                                     "sample_000"))
    assert os.listdir(os.path.join(work, "profile")) == [
        "steps_1_1.pt.trace.json"]
    assert len(os.listdir(os.path.join(work, "tb"))) == 1
