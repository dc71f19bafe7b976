"""One bfloat16 PSMNet train step of the port against the JAX package's, on
the CPU (the counterpart of tests/models/test_bf16_training.py).

The port's model (tiny PSMNet, max_disp 16, ``PSMNet/scene_flow_bf16``) is
built from a seed with every BatchNorm made random, and the same weights
go to JAX as a Flax tree. The port takes one ``make_train_step`` step on a
2x32x64 batch. On the JAX side the loss is the one its ``make_train_step``
reports, the train-mode forward and the loss evaluator of its ``loss_fn``
(trainer/train_step.py:32-47), jitted without the gradient: differentiating
the bfloat16 network takes JAX about 34 s to compile on the CPU, and the
gradients' algorithm is held against JAX in float32 by
tests/test_torch_train_step.py. The bfloat16 gradients are held to the
port's own float32 ones on the same weights and batch instead, with a
bound sized from JAX's own bfloat16-vs-float32 gap.
"""

import copy

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
from densematchingbenchmark_tpu_torch.losses import (make_loss_evaluator,
                                                     total_loss)
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                      build_optimizer,
                                                      make_train_step)
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
B, H, W = 2, 32, 64
LOSS_RTOL = 0.01


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


def make_batch(seed):
    rng = np.random.RandomState(seed)
    return {"leftImage": rng.randn(B, H, W, 3).astype(np.float32),
            "rightImage": rng.randn(B, H, W, 3).astype(np.float32),
            # some GT beyond max_disp and below 0: the mask is exercised
            "leftDisp": rng.uniform(-2, 20, (B, H, W, 1)).astype(np.float32)}


def port_grads(module, batch, ev):
    """Loss and {name: gradient} of a train-mode copy of ``module``."""
    probe = copy.deepcopy(module).train()
    out = probe(batch["leftImage"], batch["rightImage"])
    loss = total_loss(ev(out["disps"], out["costs"], batch["leftDisp"]))
    names = [n for n, _ in probe.named_parameters()]
    grads = torch.autograd.grad(loss, list(probe.parameters()))
    return out, dict(zip(names, grads))


@pytest.fixture(scope="module")
def one_step():
    cfg = get_config("PSMNet/scene_flow_bf16", **TINY)
    module = build_model(cfg, torch.Generator().manual_seed(0))
    variables = randomize_bn(flax_variables(module),
                             np.random.RandomState(0))
    load_jax_variables(module, variables)
    batch = make_batch(1)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ev = make_loss_evaluator(cfg["model"]["losses"])
    out, grads = port_grads(module, tbatch, ev)
    f32 = build_model(get_config("PSMNet/scene_flow_f32", **TINY))
    load_jax_variables(f32, variables)
    _, grads_f32 = port_grads(f32, tbatch, ev)

    opt, _ = build_optimizer(cfg, module, 10)
    state = TrainState.create(module, opt, seed=1)
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    kernels.reset_launch_counts()
    state, metrics = make_train_step(ev)(state, tbatch)
    port = {"metrics": {k: float(v) for k, v in metrics.items()},
            "out": out, "grads": grads, "grads_f32": grads_f32,
            "before": before, "module": module,
            "launches": kernels.launch_counts(), "step": state.step}

    jcfg = jget_config("PSMNet/scene_flow_bf16", **TINY)
    jmodel = jbuild_model(jcfg)
    jev = jmake_ev(jcfg["model"]["losses"])

    @jax.jit
    def loss_fn(params, batch_stats, b):
        o, updates = jmodel.apply(
            {"params": params, "batch_stats": batch_stats},
            b["leftImage"], b["rightImage"], train=True,
            mutable=["batch_stats"])
        loss_dict = jev(o["disps"], o["costs"], b["leftDisp"])
        return jtotal(loss_dict), loss_dict

    jv = jax.tree.map(jnp.asarray, variables)
    loss, loss_dict = loss_fn(jv["params"], jv["batch_stats"],
                              {k: jnp.asarray(v) for k, v in batch.items()})
    want = {"loss": float(loss), **{k: float(v)
                                    for k, v in loss_dict.items()}}
    return port, want


def test_bf16_train_step_loss_matches_jax(one_step):
    """The loss and each level's term within 1 % of JAX's; measured
    0.04-0.08 % on the total (port 8.2292-8.2326 with 8 and 1 CPU threads,
    JAX 8.2259; tests/bf16_gap_study.py)."""
    port, want = one_step
    assert port["step"] == 1
    for k, v in want.items():
        got = port["metrics"][k]
        assert np.isfinite(got)
        assert abs(got - v) <= LOSS_RTOL * abs(v), (k, got, v)
    # on the CPU every wrapper ran its plain version and counted nothing
    assert set(port["launches"].values()) == {0}


def test_bf16_train_step_keeps_float32_master_weights(one_step):
    """As tests/models/test_bf16_training.py: the network computes in
    bfloat16 (its costs are bfloat16, the disparities float32), while every
    gradient and every parameter after the step is float32 and finite, and
    the step moved every parameter that has a gradient."""
    port, _ = one_step
    assert all(c.dtype == torch.bfloat16 for c in port["out"]["costs"])
    assert all(d.dtype == torch.float32 for d in port["out"]["disps"])
    for name, g in port["grads"].items():
        assert g.dtype == torch.float32, name
        assert torch.isfinite(g).all(), name
    for name, p in port["module"].named_parameters():
        assert p.dtype == torch.float32 and torch.isfinite(p).all(), name
        if port["grads"][name].abs().max() > 0:
            assert not torch.equal(p.detach(), port["before"][name]), name
    assert all(b.dtype == torch.float32 for b in port["module"].buffers()
               if b.is_floating_point())


def test_bf16_gradients_follow_float32(one_step):
    """The bfloat16 gradients against the port's float32 ones on the same
    weights and batch, all parameters as one vector: cosine above 0.7 and
    norms within 10 %. This tiny network with random BN is sensitive to
    rounding. Measured (tests/bf16_gap_study.py --grads; JAX's bfloat16
    gradient takes 34 s to compile, so it is not run here): JAX's own
    bfloat16 and float32 gradients have a cosine of 0.836 and norms 0.2 %
    apart; the port's 0.781-0.797 and its bfloat16 norm 1.2-3.9 % below
    (8 and 1 CPU threads: the sums' order moves the bfloat16 rounding)."""
    port, _ = one_step
    names = sorted(port["grads"])
    g16, g32 = (torch.cat([gs[n].flatten().double() for n in names])
                for gs in (port["grads"], port["grads_f32"]))
    cos = float(g16 @ g32 / (g16.norm() * g32.norm()))
    assert cos > 0.7, cos
    assert abs(float(g16.norm() - g32.norm())) <= 0.1 * float(g32.norm())
