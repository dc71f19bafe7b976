"""The port's hand-written kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a GPU machine that has none; from the repository root:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the CPU suite.) Shapes
are small and ragged (edges that no block size divides). The kernels and
the plain versions both compute in float32 and differ in the order of their
sums; tolerances are stated per test.
"""

import copy

import numpy as np
import pytest
import torch

from densematchingbenchmark_tpu_torch.apis import init_model, inference_stereo
from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.losses import (make_loss_evaluator,
                                                     total_loss)
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.ops.cost_volume import (
    disp_sample_values)
from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                      build_optimizer,
                                                      make_train_step)

TINY = {"model.max_disp": 64,
        "model.cost_processor.cost_computation.max_disp": 16,
        "model.cost_processor.cost_aggregator.max_disp": 64,
        "model.disp_predictor.max_disp": 64,
        "data.test.input_shape": (64, 64)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA and Triton kernels run "
                    "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def conv_inputs(shape, cout, seed):
    rng = np.random.RandomState(seed)
    cin = shape[-1]
    return (rng.randn(*shape).astype(np.float32),
            (rng.randn(3, 3, 3, cin, cout) * 0.1).astype(np.float32),
            (rng.rand(cout) + 0.5).astype(np.float32),
            rng.randn(cout).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,relu", [
    ((1, 4, 16, 24, 8), 16, True),
    ((2, 3, 7, 78, 32), 32, False),    # ragged H and W, batch 2
    ((1, 2, 5, 9, 64), 64, True),      # two Cout blocks
    ((1, 3, 4, 5, 12), 20, False),     # Cin, Cout not multiples of 16
])
def test_conv3d_kernel_matches_plain_on_card(cuda, shape, cout, relu):
    args = [torch.from_numpy(a).to(cuda)
            for a in conv_inputs(shape, cout, seed=shape[3])]
    before = kernels.fused_conv3d.launches
    got = kernels.fused_conv3d(*args, relu=relu)
    want = kernels.conv3d_plain(*args, relu)
    torch.cuda.synchronize()
    assert kernels.fused_conv3d.launches == before + 1
    tol = 1e-4 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_disp,start,dilation,alpha", [
    ((2, 16, 8, 128), 16, 0, 1, 1.0),
    ((1, 3, 5, 130), 6, -2, 2, 2.5),
    ((1, 50, 3, 77), 50, 0, 1, 0.5),   # D and W not block multiples
])
def test_soft_argmin_kernel_matches_plain_on_card(cuda, shape, max_disp,
                                                  start, dilation, alpha):
    cost = torch.randn(shape, device=cuda) * 3
    vals = torch.as_tensor(disp_sample_values(max_disp, start, dilation),
                           device=cuda)
    before = kernels.fused_soft_argmin.launches
    got = kernels.fused_soft_argmin(cost, max_disp, start, dilation, alpha)
    want = kernels.soft_argmin_plain(cost, vals, alpha)
    torch.cuda.synchronize()
    assert kernels.fused_soft_argmin.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("low_shape,out", [
    ((1, 12, 8, 64), (48, 32, 256)),
    ((2, 5, 3, 7), (20, 11, 30)),      # ragged, batch 2
    ((1, 1, 1, 5), (4, 3, 9)),         # single source depth and row
])
def test_upsample_kernel_matches_plain_on_card(cuda, low_shape, out):
    low = torch.randn(low_shape, device=cuda) * 3
    vals = torch.as_tensor(disp_sample_values(out[0]), device=cuda)
    before = kernels.fused_upsample_soft_argmin.launches
    got = kernels.fused_upsample_soft_argmin(low, *out)
    want = kernels.upsample_soft_argmin_plain(low, *out, vals)
    torch.cuda.synchronize()
    assert kernels.fused_upsample_soft_argmin.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_tiny_slice_on_card_matches_cpu(cuda, fused):
    over = dict(TINY, **{"model.eval.fused_upsample_argmin": fused})
    model = init_model("PSMNet/scene_flow_f32", device=cuda, seed=1, **over)
    cpu = init_model("PSMNet/scene_flow_f32", device="cpu", seed=1, **over)
    rng = np.random.RandomState(0)
    batch = [{"leftImage": rng.rand(50, 60, 3).astype(np.float32) * 255,
              "rightImage": rng.rand(50, 60, 3).astype(np.float32) * 255}]
    kernels.reset_launch_counts()
    got = inference_stereo(model, batch, pad_to_shape=(64, 64))
    counts = kernels.launch_counts()
    regress = "fused_upsample_soft_argmin" if fused else "fused_soft_argmin"
    assert counts["fused_conv3d"] == 13 and counts[regress] == 3, counts
    want = inference_stereo(cpu, batch, pad_to_shape=(64, 64))
    for g, w in zip(got[0]["disps"], want[0]["disps"]):
        assert g.shape == (1, 50, 60, 1)
        # cuDNN's and the CPU's convolutions sum in other orders
        np.testing.assert_allclose(g, w, atol=1e-2)


def packed_inputs(shape, pack, cout, form, seed, device):
    """xp [B, R, H, W, pack*Ci], kernel, and a scalar / [Co] / [pack*Co]
    scale and bias."""
    rng = np.random.RandomState(seed)
    cin = shape[-1] // pack
    n = {"scalar": (), "co": (cout,), "pco": (pack * cout,)}[form]
    arrays = (rng.randn(*shape), rng.randn(3, 3, 3, cin, cout) * 0.1,
              rng.rand(*n) + 0.5, rng.randn(*n))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pack,cout,form,relu", [
    ((1, 4, 16, 24, 8), 1, 16, "co", True),          # plain NDHWC
    ((2, 3, 7, 78, 32), 1, 32, "scalar", False),     # ragged H and W
    ((1, 2, 5, 9, 2 * 12), 2, 20, "pco", True),      # Ci 12, Co 20
    ((2, 3, 6, 33, 4 * 16), 4, 64, "co", False),     # two Cout blocks
    ((1, 1, 4, 5, 4 * 4), 4, 8, "pco", True),        # one packed row
])
def test_packed_conv3d_kernel_matches_plain_on_card(cuda, shape, pack, cout,
                                                    form, relu):
    xp, k, scale, bias = packed_inputs(shape, pack, cout, form, shape[3],
                                       cuda)
    before = kernels.conv3d_packed_s1.launches
    got = kernels.conv3d_packed_s1(xp, k, scale, bias, pack=pack, relu=relu)
    want = kernels.conv3d_packed_s1_plain(xp, k, scale, bias, pack, relu)
    torch.cuda.synchronize()
    assert kernels.conv3d_packed_s1.launches == before + 1
    assert got.shape == want.shape == (*shape[:-1], pack * cout)
    # 27 * Ci products summed in another order
    tol = 1e-4 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pack,cout,form,relu", [
    ((2, 3, 7, 78, 32), 1, 32, "unit", False),       # the trunk's call
    ((1, 2, 5, 9, 4 * 8), 4, 12, "co", True),
    ((2, 3, 6, 10, 2 * 16), 2, 16, "pco", False),
])
def test_packed_conv3d_backward_matches_autograd_on_card(cuda, shape, pack,
                                                         cout, form, relu):
    xp, k, scale, bias = packed_inputs(shape, pack, cout,
                                       "scalar" if form == "unit" else form,
                                       shape[2], cuda)
    leaves = [xp, k] if form == "unit" else [xp, k, scale, bias]
    for t in leaves:
        t.requires_grad_()
    epilogue = {} if form == "unit" else {"scale": scale, "bias": bias}
    ct = torch.randn((*shape[:-1], pack * cout), device=cuda)
    out = kernels.conv3d_packed_s1(xp, k, pack=pack, relu=relu, **epilogue)
    got = torch.autograd.grad(out, leaves, ct)
    # The ReLU passes the gradient where the kernel's output is positive;
    # the plain output differs by ~1e-5 and would flip that mask at outputs
    # nearest 0, so the plain side takes the kernel's mask instead of its own
    # ReLU.
    want = torch.autograd.grad(
        kernels.conv3d_packed_s1_plain(xp, k, pack=pack, **epilogue), leaves,
        ct * (out > 0) if relu else ct)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        # sums of up to B*D*H*W cotangent products in another order
        tol = 1e-4 * w.abs().max().item()
        assert (g - w).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_disp,start,dilation,alpha", [
    ((2, 16, 8, 128), 16, 0, 1, 1.0),
    ((1, 3, 5, 130), 6, -2, 2, 2.5),
    ((1, 50, 3, 77), 50, 0, 1, 0.5),   # D and W not block multiples
])
def test_soft_argmin_backward_matches_autograd_on_card(cuda, shape, max_disp,
                                                       start, dilation,
                                                       alpha):
    cost = (torch.randn(shape, device=cuda) * 3).requires_grad_()
    g = torch.randn((shape[0], *shape[2:], 1), device=cuda)
    vals = torch.as_tensor(disp_sample_values(max_disp, start, dilation),
                           device=cuda)
    fwd = kernels.fused_soft_argmin.launches
    bwd = kernels.fused_soft_argmin_backward.launches
    out = kernels.fused_soft_argmin(cost, max_disp, start, dilation, alpha)
    (got,) = torch.autograd.grad((out * g).sum(), cost)
    (want,) = torch.autograd.grad(
        (kernels.soft_argmin_plain(cost, vals, alpha) * g).sum(), cost)
    torch.cuda.synchronize()
    assert kernels.fused_soft_argmin.launches == fwd + 1
    assert kernels.fused_soft_argmin_backward.launches == bwd + 1
    # the expectation from the online softmax vs the plain one: ~1e-6 of
    # the sample range in (v_d - E), times alpha * |g|
    tol = 1e-4 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_fused_soft_argmin_on_card_has_grad_fn(cuda):
    cost = torch.randn((1, 8, 4, 8), device=cuda, requires_grad=True)
    out = kernels.fused_soft_argmin(cost, 8)
    assert out.grad_fn is not None
    out.sum().backward()
    assert cost.grad is not None and torch.isfinite(cost.grad).all()
    # each pixel's gradient sums to zero over D (softmax)
    assert cost.grad.sum(1).abs().max().item() < 1e-5


TRAIN_TINY = {"model.max_disp": 16,
              "model.cost_processor.cost_computation.max_disp": 4,
              "model.cost_processor.cost_aggregator.max_disp": 16,
              "model.disp_predictor.max_disp": 16,
              "model.losses.l1_loss.max_disp": 16}


def grads_and_step(module, batch, cfg):
    """(loss, {name: grad}, metrics, parameters after one train step) of
    ``module`` on ``batch``; the gradients from a train-mode copy."""
    ev = make_loss_evaluator(cfg["model"]["losses"])
    probe = copy.deepcopy(module).train()
    out = probe(batch["leftImage"], batch["rightImage"])
    loss = total_loss(ev(out["disps"], out["costs"], batch["leftDisp"]))
    names = [n for n, _ in probe.named_parameters()]
    grads = torch.autograd.grad(loss, list(probe.parameters()))
    opt, _ = build_optimizer(cfg, module, 10)
    _, metrics = make_train_step(ev)(TrainState.create(module, opt, 1),
                                     batch)
    return ({n: g.cpu() for n, g in zip(names, grads)},
            {k: float(v) for k, v in metrics.items()},
            {n: p.detach().cpu() for n, p in module.named_parameters()})


@pytest.mark.cuda
def test_tiny_train_step_on_card_matches_cpu(cuda):
    cfg = get_config("PSMNet/scene_flow_f32", **TRAIN_TINY)
    cpu = build_model(cfg, torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.RandomState(0)
    batch = {"leftImage": rng.randn(2, 32, 64, 3),
             "rightImage": rng.randn(2, 32, 64, 3),
             "leftDisp": rng.uniform(0, 20, (2, 32, 64, 1))}
    batch = {k: torch.tensor(v, dtype=torch.float32) for k, v in
             batch.items()}
    kernels.reset_launch_counts()
    g_card, m_card, p_card = grads_and_step(
        card, {k: v.to(cuda) for k, v in batch.items()}, cfg)
    counts = kernels.launch_counts()
    # the probe and the step: two forwards, one backward each
    assert counts == {"fused_conv3d": 0, "fused_soft_argmin": 6,
                      "fused_soft_argmin_backward": 6,
                      "fused_upsample_soft_argmin": 0,
                      "conv3d_packed_s1": 26}, counts
    g_cpu, m_cpu, p_cpu = grads_and_step(cpu, batch, cfg)
    for k in m_cpu:
        # cuDNN vs the CPU's convolutions, float32
        np.testing.assert_allclose(m_card[k], m_cpu[k], rtol=1e-3)
    lr0 = 1e-3 / 3                       # the warmup's first rate
    for n, gc in g_cpu.items():
        ga = g_card[n]
        if gc.abs().max() < 1e-6:        # conv bias before batch-stat BN
            continue
        cos = float((ga * gc).sum() / (ga.norm() * gc.norm()))
        assert cos > 0.999, (n, cos)
        # the update's slope through g = 0 is lr / sqrt(eps)
        tol = 2e-5 + lr0 / 1e-4 * (ga - gc).abs()
        assert ((p_card[n] - p_cpu[n]).abs() <= tol).all(), n
