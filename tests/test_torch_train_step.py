"""One PSMNet train step of the port against JAX ``make_train_step``, and
the port's ``train_matcher`` with exact resume, on the CPU.

The port's model (tiny PSMNet, max_disp 16) is built from a seed, every
BatchNorm's parameters and running statistics are drawn at random (identity
BN hides bugs), and the same weights go to the JAX package as a Flax tree
(``flax_variables``). Both sides take one step on the same batch, the JAX
side through its own jitted ``make_train_step`` with its optax chain. JAX's
raw gradients are read back from its optimizer state: after one step
RMSprop's nu is (1 - 0.99) * g_clipped^2 and the update has the sign of
-g, and the clip factor follows from the logged ``grad_norm``. Both sides
compute in float32 and differ in the order of their sums; each tolerance
is stated where it is asserted.
"""

import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.configs import get_config as jget_config
from densematchingbenchmark_tpu.losses import make_loss_evaluator as jmake_ev
from densematchingbenchmark_tpu.models import build_model as jbuild_model
from densematchingbenchmark_tpu.trainer.optim import (
    build_optimizer as jbuild_optimizer)
from densematchingbenchmark_tpu.trainer.state import TrainState as JState
from densematchingbenchmark_tpu.trainer.train_step import (
    make_train_step as jmake_train_step)

from densematchingbenchmark_tpu_torch import apis as tapis
from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.data import (SyntheticStereoDataset,
                                                   transforms)
from densematchingbenchmark_tpu_torch.evaluation import evaluate
from densematchingbenchmark_tpu_torch.losses import (make_loss_evaluator,
                                                     total_loss)
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                      build_optimizer,
                                                      make_train_step,
                                                      train_matcher)
from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

M = 16
TINY = {"model.max_disp": M,
        "model.cost_processor.cost_computation.max_disp": M // 4,
        "model.cost_processor.cost_aggregator.max_disp": M,
        "model.disp_predictor.max_disp": M,
        "model.losses.l1_loss.max_disp": M,
        "data.batch_size_per_device": 2,
        "optimizer.lr": 1e-3}
STEPS_PER_EPOCH = 10
B, H, W = 2, 32, 64


def randomize_bn(variables, rng):
    """Numpy copy of ``variables`` with every BatchNorm's scale / bias /
    mean / var drawn at random."""
    def walk(tree, in_bn):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, in_bn or k == "BatchNorm_0")
            elif in_bn and k in ("scale", "var"):
                out[k] = rng.uniform(0.8, 1.25, v.shape).astype(np.float32)
            elif in_bn and k in ("bias", "mean"):
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.array(v)
        return out
    return walk(variables, False)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def make_batch(seed):
    rng = np.random.RandomState(seed)
    return {"leftImage": rng.randn(B, H, W, 3).astype(np.float32),
            "rightImage": rng.randn(B, H, W, 3).astype(np.float32),
            # some GT beyond max_disp and below 0: the mask is exercised
            "leftDisp": rng.uniform(-2, 20, (B, H, W, 1)).astype(np.float32)}


def find_nu(opt_state):
    found = [s.nu for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "nu")) if hasattr(s, "nu")]
    assert len(found) == 1
    return found[0]


@pytest.fixture(scope="module")
def one_step():
    """The port and JAX after one train step from the same weights."""
    cfg = get_config("PSMNet/scene_flow_f32", **TINY)
    module = build_model(cfg, torch.Generator().manual_seed(0))
    variables = randomize_bn(flax_variables(module),
                             np.random.RandomState(0))
    load_jax_variables(module, variables)
    batch = make_batch(1)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ev = make_loss_evaluator(cfg["model"]["losses"])

    # the port's raw gradients, on a copy (train mode moves BN stats)
    probe = copy.deepcopy(module).train()
    out = probe(tbatch["leftImage"], tbatch["rightImage"])
    loss = total_loss(ev(out["disps"], out["costs"], tbatch["leftDisp"]))
    names = [n for n, _ in probe.named_parameters()]
    grads = torch.autograd.grad(loss, list(probe.parameters()))
    port_grads = flax_variables(probe, dict(zip(names, grads)))["params"]

    opt, schedule = build_optimizer(cfg, module, STEPS_PER_EPOCH)
    state = TrainState.create(module, opt, seed=1)
    kernels.reset_launch_counts()
    state, metrics = make_train_step(ev)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    port = {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": port_grads, "after": flax_variables(module),
            "launches": kernels.launch_counts(), "step": state.step,
            "lr0": schedule(0)}

    jcfg = jget_config("PSMNet/scene_flow_f32", **TINY)
    jmodel = jbuild_model(jcfg)
    tx, _ = jbuild_optimizer(jcfg, STEPS_PER_EPOCH)
    jstate = JState.create(jax.tree.map(jnp.asarray, variables), tx,
                           jax.random.PRNGKey(1))
    step = jmake_train_step(jmodel, tx, jmake_ev(jcfg["model"]["losses"]),
                            donate=False)
    new_state, jmetrics = step(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    jmetrics = {k: float(v) for k, v in jmetrics.items()}
    clip = min(1.0, jcfg["grad_clip"]["max_norm"] / jmetrics["grad_norm"])
    before, after = flat(jstate.params), flat(new_state.params)
    nu = flat(find_nu(new_state.opt_state))
    jgrads = {k: -np.sign(after[k] - before[k]) * np.sqrt(nu[k] / 0.01)
              / clip for k in before}
    want = {"metrics": jmetrics, "grads": jgrads,
            "after": {"params": after,
                      "batch_stats": flat(new_state.batch_stats)},
            "before": before}
    return port, want


def test_train_step_loss_dict_matches_jax(one_step):
    port, want = one_step
    assert sorted(port["metrics"]) == sorted(want["metrics"]) == [
        "grad_norm", "l1_loss_lvl0", "l1_loss_lvl1", "l1_loss_lvl2", "loss"]
    for k, v in want["metrics"].items():
        # float32 through the whole network in another summation order
        np.testing.assert_allclose(port["metrics"][k], v, rtol=2e-4,
                                   err_msg=k)
    assert port["step"] == 1
    # on the CPU every wrapper ran its plain version and counted nothing
    assert set(port["launches"].values()) == {0}


def zero_grad_leaves(keys):
    """Conv biases that feed batch-statistics BN: their gradient is zero in
    exact arithmetic (BN subtracts the batch mean), float32 noise on both
    sides."""
    return {k for k in keys if k[-2:] == ("Conv_0", "bias")
            and k[:-2] + ("BatchNorm_0", "scale") in keys}


def test_train_step_gradients_match_jax(one_step):
    port, want = one_step
    got = flat(port["grads"])
    assert sorted(got) == sorted(want["grads"])
    top = max(float(np.abs(w).max()) for w in want["grads"].values())
    zero = zero_grad_leaves(set(got))
    assert len(zero) == 2          # the two downsample convs of the backbone
    worst = 1.0
    for k, g in got.items():
        w = want["grads"][k]
        assert g.shape == w.shape, k
        if k in zero:
            # measured: ~1e-8 on both sides against a largest gradient of ~10
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-6 * top, k
            continue
        denom = np.linalg.norm(g) * np.linalg.norm(w)
        cos = float((g * w).sum() / denom) if denom > 0 else 1.0
        worst = min(worst, cos)
        # Per leaf: cosine above 0.999 and relative L2 error below 3e-2.
        # Measured: cosine above 0.9999, relative error median 0.3%, worst
        # 0.4% with 8 torch threads and 1.3% with one. That is this float32
        # network's own floor: a 1e-7 relative perturbation of the port's
        # weights moves its gradients by a median 0.3% (up to 0.7%).
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert cos > 0.999 and rel < 3e-2, ("/".join(k), cos, rel)
    assert worst > 0.999


def test_train_step_updated_params_match_jax(one_step):
    port, want = one_step
    got = flat(port["after"]["params"])
    grads = flat(port["grads"])
    lr0 = port["lr0"]
    for k, w in want["after"]["params"].items():
        # The first RMSprop update is -lr * g / sqrt(0.01 g^2 + eps): about
        # 10 * lr * sign(g) for |g| >> 1e-3, and continuous through g = 0
        # with slope lr / sqrt(eps) (eps inside the root). So the two sides'
        # parameters differ by at most that slope times their gradients'
        # difference (measured up to 2.5e-3 where |g| ~ 1e-4 differs by
        # ~7e-4), plus float32 rounding.
        slope = lr0 / np.sqrt(1e-8)
        tol = 2e-5 + slope * np.abs(grads[k] - want["grads"][k])
        assert (np.abs(got[k] - w) <= tol).all(), "/".join(k)
    moved = sum(float(np.abs(want["after"]["params"][k] -
                             want["before"][k]).max()) for k in got)
    assert moved > 0


def test_train_step_bn_stats_match_jax(one_step):
    port, want = one_step
    got = flat(port["after"]["batch_stats"])
    assert sorted(got) == sorted(want["after"]["batch_stats"])
    for k, w in want["after"]["batch_stats"].items():
        # Flax E[x^2] - E[x]^2 vs torch's two-pass variance, float32
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg="/".join(k))


def test_flax_variables_round_trip():
    cfg = get_config("PSMNet/scene_flow_f32", **TINY)
    a = build_model(cfg, torch.Generator().manual_seed(2))
    b = build_model(cfg, torch.Generator().manual_seed(3))
    load_jax_variables(b, flax_variables(a))
    sa, sb = a.state_dict(), b.state_dict()
    for k in sa:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sa[k], sb[k]), k


def tiny_train_cfg():
    return get_config("PSMNet/scene_flow_f32", **dict(
        TINY, **{"lr_schedule.warmup_iters": 0, "total_epochs": 3}))


def tiny_dataset():
    ds = SyntheticStereoDataset(length=8, height=40, width=72,
                                max_disp=M // 2)
    ds.transform = transforms.make_train_transform((32, 64), (128.,) * 3,
                                                   (64.,) * 3)
    return ds


def test_train_matcher_resume_reproduces_losses(tmp_path):
    cfg = tiny_train_cfg()
    whole = str(tmp_path / "whole")
    state = train_matcher(cfg, whole, train_dataset=tiny_dataset(),
                          max_steps=6, log_interval=1, device="cpu")
    assert state.step == 6
    cut = str(tmp_path / "cut")
    train_matcher(cfg, cut, train_dataset=tiny_dataset(), max_steps=3,
                  log_interval=1, device="cpu")
    assert os.listdir(os.path.join(cut, "checkpoints")) == ["3.pt"]
    resumed = train_matcher(cfg, cut, train_dataset=tiny_dataset(),
                            max_steps=6, log_interval=1, device="cpu",
                            resume=True)
    assert resumed.step == 6
    # each run's text log lands in its own work_dir
    assert any(f.endswith("_log.txt") for f in os.listdir(whole))
    assert any(f.endswith("_log.txt") for f in os.listdir(cut))
    a, b = read_metrics(whole), read_metrics(cut)
    assert [r["step"] for r in b] == [1, 2, 3, 4, 5, 6]
    for ra, rb in zip(a, b):
        for k in ("train/loss", "train/grad_norm", "train/l1_loss_lvl0",
                  "train/lr"):
            assert ra[k] == rb[k], (ra["step"], k)     # exact on the CPU
        assert np.isfinite(ra["train/loss"])
    # 8 samples at batch 2: 4 steps per epoch, so the resumed run crossed
    # into epoch 2 exactly where the uninterrupted one did
    sa = state.module.state_dict()
    sb = resumed.module.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_train_matcher_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_matcher(tiny_train_cfg(), str(tmp_path),
                      train_dataset=tiny_dataset(), max_steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapis.init_model("PSMNet/scene_flow_f32", **TINY)


def test_train_matcher_refuses_what_is_not_ported(tmp_path):
    """Per-epoch evaluation: after each epoch's checkpoint (and at
    max_steps) train_matcher logs 'eval/' metrics equal to ``evaluate`` of
    the state at that point, here on aspect-grouped batches. A file
    dataset without its annotation file raises, naming it."""
    cfg = tiny_train_cfg()
    cfg["data"]["group_sampling"] = True
    eval_ds = SyntheticStereoDataset(length=3, height=30, width=60,
                                     max_disp=M // 2, seed=7)
    eval_ds.transform = transforms.make_eval_transform(
        (32, 64), cfg["data"]["mean"], cfg["data"]["std"])
    work = str(tmp_path / "work")
    # 8 samples at batch 2: epoch 1 ends at step 4, max_steps stops at 5
    state = train_matcher(cfg, work, train_dataset=tiny_dataset(),
                          eval_dataset=eval_ds, max_steps=5,
                          log_interval=10, device="cpu")
    evals = [r for r in read_metrics(work) if "eval/disp_0/epe" in r]
    assert [r["step"] for r in evals] == [4, 5]
    want, n = evaluate(state.module, eval_ds, cfg["model"]["eval"],
                       cfg["eval_disparity_id"])
    assert n == 3 and len(want) == 3 * 5          # 3 disparities, no occ
    assert {k[len("eval/"):]: v for k, v in evals[-1].items()
            if k.startswith("eval/")} == want

    with pytest.raises(KeyError, match="annfile"):     # SceneFlow files
        train_matcher(tiny_train_cfg(), str(tmp_path), device="cpu",
                      max_steps=1)
    missing = str(tmp_path / "missing.json")
    cfg = tiny_train_cfg()
    cfg["data"].update(data_root=str(tmp_path),
                       train=dict(cfg["data"]["train"], annfile=missing))
    with pytest.raises(FileNotFoundError, match="missing.json"):
        train_matcher(cfg, str(tmp_path), device="cpu", max_steps=1)
