"""The port's hand-written kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a GPU machine that has none; from the repository root:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the CPU suite.) Shapes
are small and ragged (edges that no block size divides). The kernels and
the plain versions both sum in float32 and differ in the order of their
sums; in bfloat16 both round their float32 result once, so they may differ
by one bfloat16 step (2^-7 of the largest output) besides. Tolerances are
stated per test.
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
from densematchingbenchmark_tpu_torch.ops.cuda import (
    packed_conv3d_kernel as pk)
from densematchingbenchmark_tpu_torch.ops.cost_volume import (
    disp_sample_values)
from densematchingbenchmark_tpu_torch.tools import microbench_packed
from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                      build_optimizer,
                                                      make_train_step)

BF16_STEP = 2.0 ** -7
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
    ((1, 2, 5, 9, 64), 64, True),      # Cout 64: one block for all
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
@pytest.mark.parametrize("low_shape,out,start,dilation,alpha,dtype", [
    # out_h, out_w not multiples of a tile (16 x 64); D' 40, out_d / D'
    # not an integer
    ((1, 40, 13, 50), (150, 51, 197), 0, 1, 1.0, torch.float32),
    ((2, 7, 9, 33), (30, 35, 130), 3, 2, 2.0, torch.float32),
    ((1, 24, 6, 20), (64, 21, 79), -4, 2, -0.7, torch.float32),  # alpha < 0
    ((1, 48, 10, 40), (192, 40, 160), 0, 1, 1.0, torch.bfloat16),
    ((1, 3, 4, 70), (12, 4, 70), 1, 1, 1.5, torch.float32),     # no H/W
                                                                # upsample
    # a patch too large for shared memory (W downsampled 60x): the
    # kernel's taps read device memory
    ((1, 40, 3, 2400), (96, 5, 40), 0, 1, 1.0, torch.float32),
])
def test_upsample_kernel_ragged_on_card(cuda, low_shape, out, start,
                                        dilation, alpha, dtype):
    low = (torch.randn(low_shape, device=cuda) * 3).to(dtype)
    vals = torch.as_tensor(
        disp_sample_values(out[0] * dilation, start, dilation), device=cuda)
    before = kernels.fused_upsample_soft_argmin.launches
    got = kernels.fused_upsample_soft_argmin(low, *out, start_disp=start,
                                             dilation=dilation, alpha=alpha)
    want = kernels.upsample_soft_argmin_plain(low, *out, vals, alpha)
    torch.cuda.synchronize()
    assert kernels.fused_upsample_soft_argmin.launches == before + 1
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (low_shape[0], *out[1:], 1)
    # lerps in another order, softmax sums over D in another order: 1e-3 px
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


def packed_inputs(shape, pack, cout, form, seed, device,
                  dtype=torch.float32):
    """xp [B, R, H, W, pack*Ci] and kernel in ``dtype``, and a float32
    scalar / [Co] / [pack*Co] scale and bias."""
    rng = np.random.RandomState(seed)
    cin = shape[-1] // pack
    n = {"scalar": (), "co": (cout,), "pco": (pack * cout,)}[form]
    arrays = (rng.randn(*shape), rng.randn(3, 3, 3, cin, cout) * 0.1,
              rng.rand(*n) + 0.5, rng.randn(*n))
    return [torch.tensor(a, dtype=dt, device=device)
            for a, dt in zip(arrays, (dtype, dtype, torch.float32,
                                      torch.float32))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pack,cout,form,relu", [
    ((1, 4, 16, 24, 8), 1, 16, "co", True),          # plain NDHWC
    ((2, 3, 7, 78, 32), 1, 32, "scalar", False),     # ragged H and W
    ((1, 2, 5, 9, 2 * 12), 2, 20, "pco", True),      # Ci 12, Co 20
    ((2, 3, 6, 33, 4 * 16), 4, 64, "co", False),     # Cout 64: one block
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
@pytest.mark.parametrize("shape,pack,cout,form,relu,dtype", [
    ((1, 3, 7, 45, 2 * 4), 2, 8, "scalar", True, torch.float32),  # Cin 4,
                                                     # D 6: a short last chunk
    ((2, 5, 5, 33, 4 * 4), 4, 12, "co", False, torch.float32),   # D 20
    ((1, 3, 9, 40, 4 * 8), 4, 36, "pco", True, torch.float32),   # two Cout
                                                     # blocks, ragged
    ((1, 1, 4, 5, 4 * 4), 4, 8, "co", True, torch.float32),      # one row
    # bfloat16 (the tensor cores) takes Cin % 16 == 0, Cout % 8 == 0
    ((1, 3, 7, 45, 2 * 16), 2, 8, "scalar", True, torch.bfloat16),
    ((2, 5, 5, 33, 4 * 16), 4, 16, "co", False, torch.bfloat16),
    ((1, 3, 9, 40, 4 * 32), 4, 40, "pco", True, torch.bfloat16),
    ((1, 1, 4, 5, 4 * 16), 4, 8, "co", True, torch.bfloat16),
])
def test_packed_conv3d_v2_kernel_matches_plain_on_card(cuda, shape, pack,
                                                       cout, form, relu,
                                                       dtype):
    xp, k, scale, bias = packed_inputs(shape, pack, cout, form, shape[3],
                                       cuda, dtype)
    before = kernels.conv3d_packed_s1_v2.launches
    got = kernels.conv3d_packed_s1_v2(xp, k, scale, bias, pack=pack,
                                      relu=relu)
    want = kernels.conv3d_packed_s1_plain(xp, k, scale, bias, pack, relu)
    torch.cuda.synchronize()
    assert kernels.conv3d_packed_s1_v2.launches == before + 1
    assert got.dtype == want.dtype == dtype
    assert got.shape == want.shape == (*shape[:-1], pack * cout)
    # 27 * Ci products summed in another order; in bfloat16 one rounding
    # step of the result besides
    step = BF16_STEP if dtype == torch.bfloat16 else 0.0
    tol = (1e-4 + step) * want.abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pack,cout,form,relu", [
    ((1, 5, 7, 45, 4), 1, 4, "scalar", True),        # Ci 4: half a slice
    ((2, 3, 9, 33, 2 * 12), 2, 40, "co", False),     # Ci 12: a ragged slice
    ((1, 5, 6, 70, 4 * 36), 4, 64, "pco", True),     # Ci 36, D 20
    ((1, 4, 5, 31, 4 * 64), 4, 4, "scalar", False),  # Ci 64, W < 32
    ((1, 17, 10, 40, 64), 1, 40, "pco", False),      # D 17: past a chunk
    ((2, 2, 3, 65, 2 * 4), 2, 64, "co", True),       # W 65: a third tile
    ((1, 9, 13, 37, 4 * 12), 4, 4, "co", True),      # D 36, H 13
    ((1, 1, 4, 5, 4 * 36), 4, 40, "scalar", True),   # one packed row
])
def test_packed_conv3d_v2_float32_widths_on_card(cuda, shape, pack, cout,
                                                  form, relu):
    xp, k, scale, bias = packed_inputs(shape, pack, cout, form, shape[3],
                                       cuda)
    before = kernels.conv3d_packed_s1_v2.launches
    got = kernels.conv3d_packed_s1_v2(xp, k, scale, bias, pack=pack,
                                      relu=relu)
    want = kernels.conv3d_packed_s1_plain(xp, k, scale, bias, pack, relu)
    torch.cuda.synchronize()
    assert kernels.conv3d_packed_s1_v2.launches == before + 1
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (*shape[:-1], pack * cout)
    # 27 * Ci products summed in another order
    tol = 1e-4 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


def _sync_free(fn):
    """Call ``fn`` once to build and fill its caches, then again under
    torch.cuda.set_sync_debug_mode("error"), which raises on a
    synchronising call (a copy from pageable host memory among them)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["upsample_argmin", "upsample_3d",
                                  "soft_argmin", "packed_v2_f32"])
def test_regression_ops_issue_no_synchronising_call_on_card(cuda, path):
    from densematchingbenchmark_tpu_torch.ops.interpolate import upsample_3d
    low = torch.randn((1, 12, 8, 30), device=cuda)
    if path == "upsample_argmin":
        _sync_free(lambda: kernels.fused_upsample_soft_argmin(
            low, 48, 32, 120, start_disp=2, dilation=2, alpha=1.5))
    elif path == "upsample_3d":
        _sync_free(lambda: upsample_3d(low, 48, 32, 120))
    elif path == "soft_argmin":
        cost = torch.randn((2, 16, 8, 40), device=cuda, requires_grad=True)
        _sync_free(lambda: torch.autograd.grad(
            kernels.fused_soft_argmin(cost, 32, -2, 2, 2.0).sum(), cost))
    else:
        xp, k, scale, bias = packed_inputs((1, 3, 6, 40, 4 * 12), 4, 8, "co",
                                           0, cuda)
        _sync_free(lambda: (
            kernels.conv3d_packed_s1_v2(xp, k, pack=4),
            kernels.conv3d_packed_s1_v2(xp, k, scale, bias, pack=4,
                                        relu=True)))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_tiny_eval_forward_issues_no_synchronising_call_on_card(cuda,
                                                                fused):
    model = init_model("PSMNet/scene_flow_f32", device=cuda, seed=0,
                       **dict(TINY, **{
                           "model.eval.fused_upsample_argmin": fused}))
    x = torch.randn((1, 64, 64, 3), device=cuda)
    _sync_free(lambda: model.forward(x, x))


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["conv3d_packed_s1",
                                     "conv3d_packed_s1_v2"])
@pytest.mark.parametrize("shape,pack,cout,form,relu", [
    ((1, 6, 8, 64, 16), 1, 8, "scalar", False),      # Ci 16, Co 8
    ((2, 5, 7, 70, 32), 1, 32, "co", True),          # H % 4, W % 64 ragged
    ((1, 4, 6, 100, 2 * 64), 2, 40, "pco", True),    # Co 40: two Cout tiles
    ((1, 5, 9, 130, 4 * 16), 4, 64, "co", False),    # D 20, W 2 * 64 + 2
    ((1, 1, 4, 5, 4 * 32), 4, 32, "pco", False),     # one packed row
    ((1, 17, 5, 33, 32), 1, 40, "scalar", True),     # D 17: past one chunk
    ((2, 3, 3, 64, 2 * 48), 2, 8, "co", True),       # Ci 48 (16-ch stages)
])
def test_packed_conv3d_wgmma_matches_plain_on_card(cuda, wrapper, shape,
                                                   pack, cout, form, relu):
    fn = getattr(kernels, wrapper)
    xp, k, scale, bias = packed_inputs(shape, pack, cout, form, shape[3],
                                       cuda, torch.bfloat16)
    before, bf16 = fn.launches, fn.bf16_launches
    got = fn(xp, k, scale, bias, pack=pack, relu=relu)
    want = kernels.conv3d_packed_s1_plain(xp, k, scale, bias, pack, relu)
    torch.cuda.synchronize()
    assert (fn.launches, fn.bf16_launches) == (before + 1, bf16 + 1)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (*shape[:-1], pack * cout)
    # float32 sums in another order, then one bfloat16 rounding each
    tol = (1e-4 + BF16_STEP) * want.abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["per_call", "prepared"])
@pytest.mark.parametrize("shape,pack,cout,form,relu", [
    ((1, 1, 6, 45, 16), 1, 8, "scalar", True),       # D 1: 2 items, 2 blocks
    ((2, 2, 5, 78, 32), 1, 40, "co", False),         # D 2, Co 40: 2 tiles
    ((1, 13, 7, 130, 64), 1, 64, "co", True),        # D 13, H 7, W 130
    ((3, 13, 9, 130, 112), 1, 64, "scalar", False),  # Ci 112; 351 items a
                                                     # tile, 66 blocks
    ((1, 12, 24, 78, 64), 1, 64, "co", True),        # the 12x24x78 trunk
    ((2, 4, 6, 78, 4 * 16), 4, 40, "pco", True),     # pack 4, D 16
    ((2, 3, 10, 45, 4 * 32), 4, 8, "pco", False),    # pack 4, W 45
])
def test_persistent_wgmma_grid_matches_plain_on_card(cuda, entry, shape,
                                                     pack, cout, form, relu):
    """K4's persistent bfloat16 grid, through the per-call route and on a
    prepared image (the eval trunk's entry), against the plain version:
    more work items than blocks and fewer, ragged D, H and W, every width
    class, pack 1 and 4, every epilogue, ReLU both ways. Both entries launch
    the same kernel on the same plan: their results are equal bit for
    bit."""
    xp, k, scale, bias = packed_inputs(shape, pack, cout, form, shape[1],
                                       cuda, torch.bfloat16)
    fn = kernels.conv3d_packed_s1
    before = fn.bf16_launches
    if entry == "prepared":
        got = pk.conv3d_packed_s1_prepared(
            xp, pk.wgmma_operands(k, scale, bias, pack), relu=relu)
        assert torch.equal(got, fn(xp, k, scale, bias, pack=pack, relu=relu))
        assert fn.bf16_launches == before + 2
    else:
        got = fn(xp, k, scale, bias, pack=pack, relu=relu)
        assert fn.bf16_launches == before + 1
    want = kernels.conv3d_packed_s1_plain(xp, k, scale, bias, pack, relu)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (*shape[:-1], pack * cout)
    # float32 sums in another order, then one bfloat16 rounding each
    tol = (1e-4 + BF16_STEP) * want.abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_prepared_entry_is_forward_only_on_card(cuda):
    xp, k, scale, bias = packed_inputs((1, 2, 4, 8, 16), 1, 8, "co", 0,
                                       cuda, torch.bfloat16)
    prepared = pk.wgmma_operands(k, scale, bias)
    before = kernels.conv3d_packed_s1.launches
    xp.requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        pk.conv3d_packed_s1_prepared(xp, prepared)
    with pytest.raises(ValueError, match="prepared"):
        pk.conv3d_packed_s1_prepared(xp.detach().float(), prepared)
    assert kernels.conv3d_packed_s1.launches == before


@pytest.mark.cuda
def test_tiny_bf16_model_picks_up_new_weights_on_card(cuda):
    """The bfloat16 eval trunk keeps K4's prepared operands: a second
    forward builds none, and after load_state_dict with other weights the
    13 units build theirs again and give the new weights' result (cuDNN's
    convolutions in sums of another order aside)."""
    from densematchingbenchmark_tpu_torch.models.layers import ConvUnit
    model = init_model("PSMNet/scene_flow_bf16", device=cuda, seed=0, **TINY)
    other = init_model("PSMNet/scene_flow_bf16", device=cuda, seed=1, **TINY)
    x = torch.randn((1, 64, 64, 3), device=cuda)
    first = model.forward(x, x)["disps"][0]
    builds = ConvUnit.operand_builds
    kernels.reset_launch_counts()
    model.forward(x, x)
    assert ConvUnit.operand_builds == builds
    assert kernels.bf16_launch_counts()["conv3d_packed_s1"] == 13
    model.module.load_state_dict(other.module.state_dict())
    got = model.forward(x, x)["disps"][0]
    assert ConvUnit.operand_builds == builds + 13
    want = other.forward(x, x)["disps"][0]
    gap = (got - want).abs().mean().item()
    assert gap <= 0.01 * (first - want).abs().mean().item(), gap


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pack,cout,form,relu", [
    ((2, 3, 7, 78, 32), 1, 32, "co", True),
    ((1, 2, 5, 9, 4 * 16), 4, 16, "pco", False),     # bf16: Ci % 16 == 0
])
def test_packed_conv3d_bf16_matches_plain_on_card(cuda, shape, pack, cout,
                                                  form, relu):
    xp, k, scale, bias = packed_inputs(shape, pack, cout, form, shape[2],
                                       cuda, torch.bfloat16)
    leaves = [xp, k, scale, bias]
    for t in leaves:
        t.requires_grad_()
    out = kernels.conv3d_packed_s1(xp, k, scale, bias, pack=pack, relu=relu)
    want = kernels.conv3d_packed_s1_plain(xp, k, scale, bias, pack, relu)
    assert out.dtype == want.dtype == torch.bfloat16
    tol = (1e-4 + BF16_STEP) * want.abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= tol
    ct = torch.randn(out.shape, device=cuda).bfloat16()
    got = torch.autograd.grad(out, leaves, ct)
    # the plain side takes the kernel's ReLU mask (see the float32 test)
    plain = kernels.conv3d_packed_s1_plain(xp, k, scale, bias, pack)
    want = torch.autograd.grad(plain, leaves, ct * (out > 0) if relu else ct)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        # cuDNN's bfloat16 gradient convolutions take the cotangent times
        # the scale rounded to bfloat16 and round their result: a few
        # bfloat16 steps of the largest gradient
        tol = 4 * BF16_STEP * w.abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["conv3d_packed_s1",
                                     "conv3d_packed_s1_v2"])
@pytest.mark.parametrize("cin,cout", [(4, 8), (16, 12), (128, 32)])
def test_packed_conv3d_bf16_rejects_unsupported_widths_on_card(cuda, wrapper,
                                                               cin, cout):
    xp, k, scale, bias = packed_inputs((1, 2, 4, 8, 2 * cin), 2, cout, "co",
                                       0, cuda, torch.bfloat16)
    fn = getattr(kernels, wrapper)
    before = fn.launches
    with pytest.raises(ValueError, match="bfloat16"):
        fn(xp, k, scale, bias, pack=2)
    assert fn.launches == before
    # the float32 route takes these widths (Ci % 4, Co % 4)
    fn(xp.float(), k.float(), scale, bias, pack=2)
    assert fn.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["conv3d_packed_s1",
                                     "conv3d_packed_s1_v2"])
def test_wgmma_kernel_refuses_a_plan_short_of_its_layout_on_card(
        cuda, wrapper, monkeypatch):
    # csrc/conv3d_wgmma.cuh checks the plan's shared memory against the
    # block's own layout: one byte short and nothing is launched
    plan = pk.wgmma_plan
    monkeypatch.setattr(pk, "wgmma_plan", lambda *a: dict(
        plan(*a), smem=plan(*a)["smem"] - 1))
    xp, k, scale, bias = packed_inputs((1, 2, 4, 8, 2 * 16), 2, 8, "co", 0,
                                       cuda, torch.bfloat16)
    fn = getattr(kernels, wrapper)
    before = fn.launches
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        fn(xp, k, scale, bias, pack=2)
    assert fn.launches == before


@pytest.mark.cuda
def test_packed_conv3d_v2_is_forward_only_on_card(cuda):
    xp, k, scale, bias = packed_inputs((1, 2, 4, 5, 8), 2, 4, "co", 0, cuda)
    k.requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        kernels.conv3d_packed_s1_v2(xp, k, scale, bias, pack=2)
    before = kernels.conv3d_packed_s1_v2.launches
    with torch.no_grad():
        kernels.conv3d_packed_s1_v2(xp, k, scale, bias, pack=2)
    assert kernels.conv3d_packed_s1_v2.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_microbench_runs_on_card(cuda, dtype):
    kernels.reset_launch_counts()
    width = 16 if dtype == torch.bfloat16 else 8   # bf16: Ci % 16 == 0
    rows = microbench_packed.run(
        cases=(("small", (1, 8, 20, 40), width, width),), dtype=dtype,
        pack=4, iters=2, device=cuda)
    counts = kernels.launch_counts()
    # the chain of two calls once untimed, then timed
    assert counts["conv3d_packed_s1"] == counts["conv3d_packed_s1_v2"] == 4
    n_bf16 = 4 if dtype == torch.bfloat16 else 0
    assert kernels.bf16_launch_counts() == {"conv3d_packed_s1": n_bf16,
                                            "conv3d_packed_s1_v2": n_bf16}
    assert [r["row"] for r in rows] == list(microbench_packed.ROWS)
    assert all(r["device"] == "cuda" and r["ms"] > 0 for r in rows)


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
                      "conv3d_packed_s1": 26, "conv3d_packed_s1_v2": 0}, counts
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


# The float32 block of K1 and K4 (csrc/conv3d_tile.cuh): ragged H and W
# (16-row and 32-column tiles), W 78 and 312 (the eval trunk's), Cin 4, 12
# and 64 (half, one and a half, eight 8-channel stages), Cout 4, 36, 64 and
# 68 (one or two Cout tiles of 32 or 64)
F32_BLOCK_CASES = [
    ((1, 5, 7, 45, 4), 1, 4, "scalar", True),
    ((2, 3, 13, 78, 12), 1, 36, "co", False),
    ((1, 4, 9, 312, 64), 1, 64, "co", True),
    ((1, 3, 19, 33, 64), 1, 68, "scalar", False),
    ((1, 3, 6, 78, 4 * 12), 4, 36, "pco", True),
    ((2, 2, 5, 70, 4 * 64), 4, 68, "co", False),
    ((1, 1, 4, 5, 4 * 4), 4, 64, "pco", False),
    ((1, 2, 17, 312, 4 * 4), 4, 4, "scalar", True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pack,cout,form,relu", F32_BLOCK_CASES)
def test_float32_block_packed_matches_plain_on_card(cuda, shape, pack, cout,
                                                    form, relu):
    xp, k, scale, bias = packed_inputs(shape, pack, cout, form, shape[3],
                                       cuda)
    before = kernels.conv3d_packed_s1.launches
    got = kernels.conv3d_packed_s1(xp, k, scale, bias, pack=pack, relu=relu)
    want = kernels.conv3d_packed_s1_plain(xp, k, scale, bias, pack, relu)
    torch.cuda.synchronize()
    assert kernels.conv3d_packed_s1.launches == before + 1
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (*shape[:-1], pack * cout)
    # 27 * Ci products summed in another order
    tol = 1e-4 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pack,cout,form,relu",
                         [c for c in F32_BLOCK_CASES if c[1] == 1])
def test_float32_block_k1_matches_plain_on_card(cuda, shape, pack, cout,
                                                form, relu):
    args = [torch.from_numpy(a).to(cuda)
            for a in conv_inputs(shape, cout, seed=shape[2])]
    before = kernels.fused_conv3d.launches
    got = kernels.fused_conv3d(*args, relu=relu)
    want = kernels.conv3d_plain(*args, relu)
    torch.cuda.synchronize()
    assert kernels.fused_conv3d.launches == before + 1
    assert got.shape == want.shape == (*shape[:-1], cout)
    tol = 1e-4 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["fused_conv3d", "conv3d_packed_s1"])
def test_float32_block_refuses_a_plan_short_of_its_layout_on_card(
        cuda, wrapper, monkeypatch):
    # csrc/conv3d_tile.cuh checks the plan's shared memory against the
    # block's own layout: one byte short and nothing is launched
    plan = pk.f32_plan
    monkeypatch.setattr(pk, "f32_plan", lambda *a: dict(
        plan(*a), smem=plan(*a)["smem"] - 1))
    x, k, scale, bias = packed_inputs((1, 2, 4, 8, 16), 1, 8, "co", 0, cuda)
    fn = getattr(kernels, wrapper)
    before = fn.launches
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        fn(x, k, scale, bias, relu=True) if wrapper == "fused_conv3d" \
            else fn(x, k, scale, bias, pack=1)
    assert fn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_disp,start,dilation,alpha,dtype", [
    ((1, 13, 3, 77), 13, 0, 1, 1.0, torch.float32),     # D % 8, W % 4
    ((2, 50, 5, 130), 100, -2, 2, 2.5, torch.float32),  # linspace samples
    ((1, 3, 4, 6), 3, 0, 1, -0.5, torch.float32),       # D < a chunk
    ((1, 48, 6, 258), 48, 0, 1, 1.0, torch.bfloat16),   # promoted
    ((3, 24, 4, 512), 48, -2, 2, 2.5, torch.bfloat16),
])
def test_soft_argmin_forward_routes_on_card(cuda, shape, max_disp, start,
                                            dilation, alpha, dtype):
    # without grad the forward stores no statistics; with grad it stores the
    # per-pixel max and sum that the backward reads, and both match the
    # plain version
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        soft_argmin_kernel as sak)
    cost = (torch.randn(shape, device=cuda) * 3).to(dtype)
    vals = torch.as_tensor(disp_sample_values(max_disp, start, dilation),
                           device=cuda)
    want = kernels.soft_argmin_plain(cost, vals, alpha)
    before = kernels.fused_soft_argmin.launches
    with torch.no_grad():
        eval_out = kernels.fused_soft_argmin(cost, max_disp, start, dilation,
                                             alpha)
    out, m, l = sak._forward(cost, vals, alpha, stats=False)
    assert m is None and l is None
    leaf = cost.detach().requires_grad_()
    train_out = kernels.fused_soft_argmin(leaf, max_disp, start, dilation,
                                          alpha)
    torch.cuda.synchronize()
    assert kernels.fused_soft_argmin.launches == before + 3
    assert eval_out.grad_fn is None and train_out.grad_fn is not None
    assert torch.equal(eval_out, out)
    # the statistics' stores are the only difference between the two
    assert (eval_out - train_out.detach()).abs().max().item() <= 1e-5
    # softmax sums over D in another order: 1e-3 px
    assert eval_out.shape == want.shape == (shape[0], *shape[2:], 1)
    assert (eval_out - want).abs().max().item() <= 1e-3
    g = torch.randn_like(want)
    (got,) = torch.autograd.grad(train_out, leaf, g)
    plain_leaf = cost.detach().float().requires_grad_()
    (ref,) = torch.autograd.grad(
        kernels.soft_argmin_plain(plain_leaf, vals, alpha), plain_leaf, g)
    assert got.dtype == dtype
    # the expectation from the online softmax, as in the backward test; in
    # bfloat16 the gradient is rounded once besides
    step = BF16_STEP if dtype == torch.bfloat16 else 0.0
    tol = (1e-4 + step) * ref.abs().max().item()
    assert (got.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernels_launch_on_their_operands_device_on_card(cuda):
    # a tiny PSMNet on the last device while the current device is 0: both
    # eval modes and one train step match the same model on device 0
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: a model on the last one while the "
                    "current device is 0")
    first, last = torch.device("cuda", 0), torch.device(
        "cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(first)
    rng = np.random.RandomState(0)
    image = torch.tensor(rng.rand(1, 64, 128, 3) * 255, dtype=torch.float32)
    sync = {"model.max_disp": 64,
            "model.cost_processor.cost_computation.max_disp": 16,
            "model.cost_processor.cost_aggregator.max_disp": 64,
            "model.disp_predictor.max_disp": 64}
    for fused in (False, True):
        over = dict(sync, **{"model.eval.fused_upsample_argmin": fused})
        want = init_model("PSMNet/scene_flow_f32", device=first, seed=0,
                          **over)
        got = init_model("PSMNet/scene_flow_f32", device=last, seed=0,
                         **over)
        kernels.reset_launch_counts()
        a = want.forward(image.to(first), image.to(first))["disps"]
        b = got.forward(image.to(last), image.to(last))["disps"]
        torch.cuda.synchronize(last)
        assert torch.cuda.current_device() == 0
        assert kernels.launch_counts()["fused_conv3d"] == 26
        for x, y in zip(a, b):
            assert y.device == last
            # the same kernels on two cards of one kind: equal up to the
            # order of cuDNN's sums
            assert (x.cpu() - y.cpu()).abs().max().item() <= 1e-3
    cfg = get_config("PSMNet/scene_flow_f32", **TRAIN_TINY)
    module = build_model(cfg, torch.Generator().manual_seed(0))
    batch = {"leftImage": rng.randn(2, 32, 64, 3),
             "rightImage": rng.randn(2, 32, 64, 3),
             "leftDisp": rng.uniform(0, 20, (2, 32, 64, 1))}
    results = []
    for device in (first, last):
        moved = {k: torch.tensor(v, dtype=torch.float32, device=device)
                 for k, v in batch.items()}
        results.append(grads_and_step(copy.deepcopy(module).to(device),
                                      moved, cfg))
    assert torch.cuda.current_device() == 0
    (g0, m0, p0), (g1, m1, p1) = results
    for k in m0:
        np.testing.assert_allclose(m1[k], m0[k], rtol=1e-4)
    for n in p0:
        assert (p1[n] - p0[n]).abs().max().item() <= 1e-4, n


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout", [
    ((4, 12, 24, 78, 64), 32),        # the eval trunk's shapes at batch 4
    ((4, 6, 12, 39, 64), 64),
    ((4, 3, 7, 30, 32), 32),          # ragged
])
def test_conv3d_kernel_at_eval_batch_4_on_card(cuda, shape, cout):
    args = [torch.from_numpy(a).to(cuda)
            for a in conv_inputs(shape, cout, seed=shape[2])]
    before = kernels.fused_conv3d.launches
    got = kernels.fused_conv3d(*args, relu=True)
    want = kernels.conv3d_plain(*args, True)
    torch.cuda.synchronize()
    assert kernels.fused_conv3d.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("low_shape,out", [
    ((4, 12, 24, 78), (48, 96, 312)),
    ((4, 5, 9, 33), (20, 35, 130)),   # ragged
])
def test_upsample_kernel_at_eval_batch_4_on_card(cuda, low_shape, out):
    low = torch.randn(low_shape, device=cuda) * 3
    vals = torch.as_tensor(disp_sample_values(out[0]), device=cuda)
    before = kernels.fused_upsample_soft_argmin.launches
    got = kernels.fused_upsample_soft_argmin(low, *out)
    want = kernels.upsample_soft_argmin_plain(low, *out, vals)
    torch.cuda.synchronize()
    assert kernels.fused_upsample_soft_argmin.launches == before + 1
    assert got.shape == (4, *out[1:], 1)
    assert (got - want).abs().max().item() <= 1e-3


def eval_set():
    """Five synthetic samples with right disparities, padded to 64x64."""
    from densematchingbenchmark_tpu_torch.data import (SyntheticStereoDataset,
                                                       transforms)
    ds = SyntheticStereoDataset(length=5, height=60, width=62, max_disp=40,
                                seed=3, with_right_disp=True)
    ds.transform = transforms.make_eval_transform(
        (64, 64), (123.675, 116.28, 103.53), (58.395, 57.12, 57.375))
    return ds


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_evaluate_on_card_matches_cpu(cuda, fused):
    from densematchingbenchmark_tpu_torch.evaluation import evaluate
    over = dict(TINY, **{"model.eval.fused_upsample_argmin": fused,
                         "model.eval.upper_bound": 64})
    card = init_model("PSMNet/scene_flow_f32", device=cuda, seed=2, **over)
    cpu = init_model("PSMNet/scene_flow_f32", device="cpu", seed=2, **over)
    ecfg, ids = card.cfg["model"]["eval"], card.cfg["eval_disparity_id"]
    kernels.reset_launch_counts()
    got, n = evaluate(card.module, eval_set(), ecfg, ids, batch_size=4)
    counts = kernels.launch_counts()
    regress = "fused_upsample_soft_argmin" if fused else "fused_soft_argmin"
    assert counts["fused_conv3d"] == 2 * 13 and counts[regress] == 2 * 3
    want, m = evaluate(cpu.module, eval_set(), ecfg, ids, batch_size=4)
    assert n == m == 5 and set(got) == set(want)
    assert "disp_0/occ_epe" in got
    for k in want:
        # cuDNN's and the CPU's convolutions sum in other orders: EPE
        # within 1e-3 px; an n-px share moves if a pixel's error crosses
        # its threshold, by 100 / (60 * 62) points each
        tol = 1e-3 if k.endswith("epe") else 3 * 100 / (60 * 62)
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_eval_loop_issues_no_synchronising_call_per_batch_on_card(cuda,
                                                                  fused):
    """The eval loop's per-batch work (pinned copy to the card, forward,
    metrics) waits for nothing; only the final fetch does."""
    from densematchingbenchmark_tpu_torch.evaluation import eval_loop
    model = init_model("PSMNet/scene_flow_f32", device=cuda, seed=0,
                       **dict(TINY, **{
                           "model.eval.fused_upsample_argmin": fused}))
    ecfg = model.cfg["model"]["eval"]
    pending = []
    _sync_free(lambda: pending.append(eval_loop.eval_batches(
        model.module, eval_set(), ecfg, (0, 1, 2), batch_size=2)))
    results = eval_loop.average_metrics(*pending[-1])
    assert pending[-1][1] == 5 and np.isfinite(list(results.values())).all()


# bfloat16 compute (model.dtype="bfloat16"): the trunk's 13 stride-1 units
# run K4's tensor-core route at pack 1, in eval with the folded-BN [Co]
# epilogue and in training with unit scale; K1 stays idle.

def draw_bn(module, seed):
    """Give every BatchNorm of ``module`` (on the CPU) random parameters
    and running statistics, drawn as the CPU tests draw them against JAX
    (tests/test_torch_psmnet.py): with gains under 1 a random network's
    disparities move by hundredths of a pixel under bfloat16 rounding,
    with the default (identity) BN by tenths, wherever it rounds."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=gen) * 0.4 + 0.7)
                m.running_var.copy_(torch.rand(n, generator=gen) * 0.5 + 0.9)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
    return module


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_tiny_bf16_slice_on_card_matches_cpu(cuda, fused):
    """The bfloat16 forward on the card (K4's wgmma route, then K2 or K3)
    against the plain versions on the CPU, same weights (BN drawn as the
    CPU tests draw it): disparities float32, a mean |difference| within
    0.05 px and the largest within 0.3 px, the bound the CPU tests hold the
    port to against JAX (both sides round to bfloat16, in sums of another
    order)."""
    from densematchingbenchmark_tpu_torch.apis import StereoModel
    over = dict(TINY, **{"model.eval.fused_upsample_argmin": fused})
    cpu = init_model("PSMNet/scene_flow_bf16", device="cpu", seed=1, **over)
    draw_bn(cpu.module, 1)
    model = StereoModel(cpu.cfg, copy.deepcopy(cpu.module).to(cuda), cuda)
    rng = np.random.RandomState(0)
    batch = [{"leftImage": rng.rand(50, 60, 3).astype(np.float32) * 255,
              "rightImage": rng.rand(50, 60, 3).astype(np.float32) * 255}]
    kernels.reset_launch_counts()
    got = inference_stereo(model, batch, pad_to_shape=(64, 64))
    counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
    regress = "fused_upsample_soft_argmin" if fused else "fused_soft_argmin"
    assert counts["fused_conv3d"] == 0 and counts[regress] == 3, counts
    assert counts["conv3d_packed_s1"] == bf16["conv3d_packed_s1"] == 13
    want = inference_stereo(cpu, batch, pad_to_shape=(64, 64))
    for g, w in zip(got[0]["disps"], want[0]["disps"]):
        assert g.shape == (1, 50, 60, 1) and g.dtype == np.float32
        diff = np.abs(g - w)
        assert diff.mean() <= 0.05 and diff.max() <= 0.3, (diff.mean(),
                                                           diff.max())


@pytest.mark.cuda
def test_tiny_bf16_train_step_on_card_matches_cpu(cuda):
    """One bfloat16 train step on the card and on the CPU from the same
    weights: K4's bfloat16 route 13 launches a forward, K2 forward and
    backward 3 each; the losses within 1 %, the gradient norm within
    10 %; gradients and parameters float32 and finite."""
    cfg = get_config("PSMNet/scene_flow_bf16", **TRAIN_TINY)
    cpu = draw_bn(build_model(cfg, torch.Generator().manual_seed(0)), 0)
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
    counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
    # the probe and the step: two forwards, one backward each
    assert counts == {"fused_conv3d": 0, "fused_soft_argmin": 6,
                      "fused_soft_argmin_backward": 6,
                      "fused_upsample_soft_argmin": 0,
                      "conv3d_packed_s1": 26, "conv3d_packed_s1_v2": 0}, counts
    assert bf16["conv3d_packed_s1"] == 26, bf16
    _, m_cpu, _ = grads_and_step(cpu, batch, cfg)
    for k in m_cpu:
        # the losses are means over every pixel; the gradients' norm, of
        # bfloat16 backward passes that round apart, within 10 % (the
        # port's bf16 and float32 gradient norms on the CPU: 3.9 %)
        tol = 0.1 if k == "grad_norm" else 0.01
        assert abs(m_card[k] - m_cpu[k]) <= tol * abs(m_cpu[k]), (
            k, m_card[k], m_cpu[k])
    for n, g in g_card.items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), n
        assert p_card[n].dtype == torch.float32, n
        assert torch.isfinite(p_card[n]).all(), n


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
def test_bf16_unit_at_an_unsupported_width_raises_on_card(cuda, train,
                                                         monkeypatch):
    """K4's wgmma block raises for widths it does not take (Cin 24), on a
    direct call; a bfloat16 trunk unit of those widths never falls back:
    in eval and in training it runs the block on its input and weights
    padded with zero channels to Cin 32 (one launch), never the library's
    conv, never float32, within 2 bfloat16 steps of the same unit on the
    CPU."""
    from densematchingbenchmark_tpu_torch.models import layers
    cpu = draw_bn(layers.ConvUnit(24, 32, 3, 1, 1, dims=3, bias=False,
                                  dtype=torch.bfloat16), 1).train(train)
    unit = copy.deepcopy(cpu).to(cuda)
    assert cpu.fusable and cpu.widths == (32, 32, ((0, 32),))
    x = torch.randn((1, 4, 6, 8, 24), device=cuda)
    want = cpu(x.cpu())
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="bfloat16"):
        kernels.conv3d_packed_s1(x.bfloat16(), torch.randn(
            (3, 3, 3, 24, 32), device=cuda), pack=1)

    def refuse(*args):
        raise AssertionError("the library's conv ran")
    monkeypatch.setattr(layers, "library_conv", refuse)
    got = unit(x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts.pop("conv3d_packed_s1") == 1
    assert kernels.bf16_launch_counts()["conv3d_packed_s1"] == 1
    assert set(counts.values()) == {0}, counts
    assert got.dtype == torch.bfloat16
    tol = 2 * BF16_STEP * want.float().abs().max().item()
    assert (got.float().cpu() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_tiny_bf16_eval_forward_issues_no_synchronising_call_on_card(
        cuda, fused):
    """The bfloat16 casts of the float32 weights and the folded epilogue
    are made on the card: the forward waits for nothing."""
    model = init_model("PSMNet/scene_flow_bf16", device=cuda, seed=0,
                       **dict(TINY, **{
                           "model.eval.fused_upsample_argmin": fused}))
    x = torch.randn((1, 64, 64, 3), device=cuda)
    _sync_free(lambda: model.forward(x, x))


def biased_unit(cuda, dtype, seed=0):
    """A 32 -> 32 trunk unit with a conv bias (AcfNet's 7 aggregator units
    outside the hourglasses), random BN statistics and bias, on the CPU
    and a copy on the card."""
    from densematchingbenchmark_tpu_torch.models.layers import (
        ConvUnit, init_parameters)
    unit = ConvUnit(32, 32, 3, 1, 1, dims=3, bias=True, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    init_parameters(unit, gen)
    bn = unit.BatchNorm_0
    with torch.no_grad():
        unit.Conv_0.bias.normal_(0.0, 0.5, generator=gen)
        bn.weight.uniform_(0.7, 1.1, generator=gen)
        bn.bias.normal_(0.0, 0.1, generator=gen)
        bn.running_mean.normal_(0.0, 0.1, generator=gen)
        bn.running_var.uniform_(0.9, 1.4, generator=gen)
    return unit, copy.deepcopy(unit).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_biased_conv_unit_eval_matches_plain_on_card(cuda, dtype):
    """A biased unit in eval: the conv bias folded into the shift of K1's
    float32 epilogue, or of K4's bfloat16 kept operands, against the same
    unit through the plain versions on the CPU; after an in-place change
    to the bias alone the kept operands are built again and give the new
    bias's result."""
    from densematchingbenchmark_tpu_torch.models.layers import ConvUnit
    cpu, card = biased_unit(cuda, dtype)
    cpu.eval(), card.eval()
    x = torch.randn((1, 6, 9, 78, 32), generator=torch.Generator()
                    .manual_seed(1))
    name = "fused_conv3d" if dtype == torch.float32 else "conv3d_packed_s1"
    step = 1e-4 if dtype == torch.float32 else 1e-4 + BF16_STEP
    for _ in range(2):
        builds = ConvUnit.operand_builds
        kernels.reset_launch_counts()
        with torch.no_grad():
            got = card(x.to(cuda))
        assert kernels.launch_counts()[name] == 1
        assert ConvUnit.operand_builds == builds + 1
        with torch.no_grad():
            want = cpu(x)
        assert got.dtype == want.dtype == dtype
        tol = step * want.abs().max().item()
        assert (got.float().cpu() - want.float()).abs().max().item() <= tol
        with torch.no_grad():                  # the bias alone changes
            card.Conv_0.bias.add_(0.25)
            cpu.Conv_0.bias.add_(0.25)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_biased_conv_unit_train_matches_plain_on_card(cuda, dtype):
    """A biased unit in training (K4, then the conv bias, batch-statistics
    BN and ReLU) on the card against the CPU: output, gradients of the
    input and of every parameter, and the BN statistics."""
    cpu, card = biased_unit(cuda, dtype, seed=2)
    cpu.train(), card.train()
    x = torch.randn((2, 4, 9, 40, 32), generator=torch.Generator()
                    .manual_seed(3))
    ct = torch.randn((2, 4, 9, 40, 32), generator=torch.Generator()
                     .manual_seed(4))
    outs = []
    for unit, device in ((card, cuda), (cpu, torch.device("cpu"))):
        xi = x.to(device).requires_grad_()
        kernels.reset_launch_counts()
        y = unit(xi)
        assert kernels.launch_counts()["conv3d_packed_s1"] == (
            1 if device.type == "cuda" else 0)
        grads = torch.autograd.grad(y.float(), [xi, *unit.parameters()],
                                    ct.to(device))
        outs.append([t.detach().float().cpu() for t in (y, *grads)]
                    + [unit.BatchNorm_0.running_mean.cpu(),
                       unit.BatchNorm_0.running_var.cpu()])
    # float32: sums in another order; bfloat16: both round their float32
    # results, the gradients through cuDNN's bfloat16 convolutions
    step = 1e-3 if dtype == torch.float32 else 4 * BF16_STEP
    # [y, dx, dW, d(conv bias), d(BN scale), d(BN bias), mean, var]; the
    # conv bias feeds batch-statistics BN: its gradient is zero in exact
    # arithmetic, rounding noise on both sides
    for i, (g, w) in enumerate(zip(*outs)):
        assert g.shape == w.shape
        if i == 3:
            noise = step * outs[1][5].abs().max().item()
            assert max(g.abs().max().item(), w.abs().max().item()) <= noise
            continue
        tol = step * w.abs().max().item()
        assert (g - w).abs().max().item() <= tol, i


ACF_TINY = {"model.max_disp": 16,
            "model.cost_processor.cost_computation.max_disp": 4,
            "model.cost_processor.cost_aggregator.max_disp": 16,
            "model.disp_predictor.max_disp": 16,
            "model.losses.l1_loss.max_disp": 16,
            "model.losses.focal_loss.max_disp": 16,
            "model.cmn.in_planes": 16,
            "model.cmn.losses.nll_loss.max_disp": 16}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tiny_acfnet_on_card_matches_cpu(cuda, dtype):
    """AcfNet adaptive at max_disp 16: the eval forward on the card (the
    13 trunk units on K1 in float32 or K4's bfloat16 route, K2 on the
    three learned-upsampled costs, no K3) against the plain versions on
    the CPU, same weights; then one train step (K4 13, K2 3 forward and
    3 backward) against the CPU's losses."""
    from densematchingbenchmark_tpu_torch.apis import StereoModel
    name = f"AcfNet/scene_flow_adaptive_{dtype}"
    cfg = get_config(name, **ACF_TINY)
    cpu = draw_bn(build_model(cfg, torch.Generator().manual_seed(0)), 0)
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(1, 32, 64, 3), dtype=torch.float32)
    kernels.reset_launch_counts()
    got = StereoModel(cfg, card.eval(), cuda).forward(x.to(cuda),
                                                      x.to(cuda))
    counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
    k1 = 13 if dtype == "f32" else 0
    assert counts == {"fused_conv3d": k1, "fused_soft_argmin": 3,
                      "fused_soft_argmin_backward": 0,
                      "fused_upsample_soft_argmin": 0,
                      "conv3d_packed_s1": 13 - k1,
                      "conv3d_packed_s1_v2": 0}, counts
    assert bf16["conv3d_packed_s1"] == 13 - k1
    want = StereoModel(cfg, cpu.eval(), torch.device("cpu")).forward(x, x)
    # float32: cuDNN vs the CPU's convolutions through soft-argmin (the
    # PSMNet slice's 1e-2 px); bfloat16: the CPU tests' 0.05 px mean
    atol = 1e-2 if dtype == "f32" else 0.05
    for g, w in zip(got["disps"], want["disps"]):
        diff = (g.cpu() - w).abs()
        assert (diff.max() if dtype == "f32" else diff.mean()) <= atol
    for g, w in zip(got["confs"], want["confs"]):
        assert ((g.cpu() - w).abs().mean() <= 1e-3 if dtype == "f32"
                else (g.cpu() - w).abs().mean() <= 1e-2)
    batch = {"leftImage": rng.randn(2, 32, 64, 3),
             "rightImage": rng.randn(2, 32, 64, 3),
             "leftDisp": rng.uniform(0, 20, (2, 32, 64, 1))}
    batch = {k: torch.tensor(v, dtype=torch.float32) for k, v in
             batch.items()}
    losses = []
    for module, device in ((card, cuda), (cpu, torch.device("cpu"))):
        ev = make_loss_evaluator(cfg["model"]["losses"],
                                 cmn_losses_cfg=cfg["model"]["cmn"]["losses"])
        opt, _ = build_optimizer(cfg, module, 10)
        kernels.reset_launch_counts()
        _, metrics = make_train_step(ev)(
            TrainState.create(module, opt, 1),
            {k: v.to(device) for k, v in batch.items()})
        if device.type == "cuda":
            counts = kernels.launch_counts()
            assert counts["conv3d_packed_s1"] == 13, counts
            assert counts["fused_soft_argmin"] == 3, counts
            assert counts["fused_soft_argmin_backward"] == 3, counts
        losses.append({k: float(v) for k, v in metrics.items()})
    for k, v in losses[1].items():
        assert np.isfinite(losses[0][k]), k
        # float32: cuDNN vs the CPU (the PSMNet step's 1e-3); bfloat16:
        # the losses within 1 %, the gradients' norm within 10 %
        tol = (1e-3 if dtype == "f32" else
               0.1 if k == "grad_norm" else 0.01)
        assert abs(losses[0][k] - v) <= tol * abs(v), (k, losses[0][k], v)


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci,co", [(128, 128), (65, 64)])
def test_unit_at_any_width_runs_its_kernels_on_card(cuda, ci, co, dtype,
                                                    train, monkeypatch):
    """A fusable unit at widths the blocks do not take as they are
    (GCNet's 128 -> 128, above the bfloat16 block's Ci of 112; an odd
    width in both dtypes) runs on its kernels, never the library's conv:
    one launch a slice of Ci (``route_widths``: 128 in bfloat16 as two of
    64), against the same unit on the CPU (its plain versions at the same
    widths): float32 within 1e-4 of the largest output (sums in another
    order), bfloat16 within 2 steps."""
    from densematchingbenchmark_tpu_torch.models import layers
    cpu = draw_bn(layers.ConvUnit(ci, co, 3, 1, 1, dims=3, bias=True,
                                  dtype=dtype), ci).train(train)
    with torch.no_grad():
        cpu.Conv_0.bias.normal_(0, 0.3, generator=torch.Generator()
                                .manual_seed(co))
    unit = copy.deepcopy(cpu).to(cuda)
    x = torch.randn((2, 3, 5, 9, ci), generator=torch.Generator()
                    .manual_seed(1)).to(dtype).float()
    ref = cpu(x)

    def refuse(*args):
        raise AssertionError("the library's conv ran")
    monkeypatch.setattr(layers, "library_conv", refuse)
    kernels.reset_launch_counts()
    got = unit(x.to(cuda))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    name = ("fused_conv3d" if dtype == torch.float32 and not train
            else "conv3d_packed_s1")
    assert counts.pop(name) == len(unit.widths.slices)
    assert set(counts.values()) == {0}, counts
    assert len(unit.widths.slices) == (2 if (ci, dtype) == (
        128, torch.bfloat16) else 1)
    assert got.dtype == ref.dtype == dtype
    tol = (1e-4 if dtype == torch.float32 else 2 * BF16_STEP) * \
        ref.float().abs().max().item()
    assert (got.float().cpu() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_soft_argmin_at_24_disparities_on_card(cuda, dtype):
    """K2 at StereoNet's 24 disparities (not a multiple of its 32-sample
    block), at a 1/8-resolution cost of a 384x1248 frame, forward and
    backward, against the plain version and its autograd."""
    shape = (2, 24, 48, 156)
    cost = (torch.randn(shape, device=cuda) * 3).to(dtype).requires_grad_()
    g = torch.randn((2, 48, 156, 1), device=cuda)
    vals = torch.as_tensor(disp_sample_values(24), device=cuda)
    kernels.reset_launch_counts()
    out = kernels.fused_soft_argmin(cost, 24)
    (got,) = torch.autograd.grad((out * g).sum(), cost)
    torch.cuda.synchronize()
    assert kernels.fused_soft_argmin.launches == 1
    assert kernels.fused_soft_argmin_backward.launches == 1
    want = kernels.soft_argmin_plain(cost, vals)
    (want_g,) = torch.autograd.grad((want * g).sum(), cost)
    assert out.dtype == torch.float32
    # softmax sums over 24 samples in another order (the plain version
    # reads the same bfloat16 cost); the gradient as in the test above,
    # plus a rounding of the bfloat16 gradient
    assert (out - want).abs().max().item() <= 1e-4
    tol = (1e-4 if dtype == torch.float32 else BF16_STEP) * \
        want_g.float().abs().max().item()
    assert (got.float() - want_g.float()).abs().max().item() <= tol


STEREO_TINY = {"model.max_disp": 32,
               "model.cost_processor.cost_computation.max_disp": 4,
               "model.disp_predictor.max_disp": 4,
               "model.losses.l1_loss.max_disp": 32,
               "model.backbone.residual_num": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tiny_stereonet_on_card_matches_cpu(cuda, dtype):
    """StereoNet 4-stage at max_disp 32: the eval forward on the card (the
    4 aggregator units on K1 in float32 or K4's bfloat16 route, K2 once
    on the 1/8 cost, no K3) against the plain versions on the CPU, same
    weights; then one train step (K4 4, K2 1 forward and 1 backward)
    against the CPU's losses."""
    from densematchingbenchmark_tpu_torch.apis import StereoModel
    name = f"StereoNet/scene_flow_8x_4stage_{dtype}"
    cfg = get_config(name, **STEREO_TINY)
    cpu = draw_bn(build_model(cfg, torch.Generator().manual_seed(0)), 0)
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(1, 64, 128, 3), dtype=torch.float32)
    kernels.reset_launch_counts()
    got = StereoModel(cfg, card.eval(), cuda).forward(x.to(cuda),
                                                      x.to(cuda))
    counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
    k1 = 4 if dtype == "f32" else 0
    assert counts == {"fused_conv3d": k1, "fused_soft_argmin": 1,
                      "fused_soft_argmin_backward": 0,
                      "fused_upsample_soft_argmin": 0,
                      "conv3d_packed_s1": 4 - k1,
                      "conv3d_packed_s1_v2": 0}, counts
    assert bf16["conv3d_packed_s1"] == 4 - k1
    want = StereoModel(cfg, cpu.eval(), torch.device("cpu")).forward(x, x)
    assert len(got["disps"]) == len(want["disps"]) == 4
    # float32: cuDNN vs the CPU's convolutions through the soft-argmin and
    # 39 full-resolution refinement convs (the PSMNet slice's 1e-2 px).
    # bfloat16: the initial disparity (the trunk's soft-argmin) within the
    # CPU tests' 0.05 px mean; a refined one carries bfloat16's own error
    # on each side at the scale of its residual, so its mean gap within
    # twice the CPU's own bfloat16-vs-float32 gap on the same weights,
    # plus 0.01 px (chip_smoke.py's STEREO_BF16_NOISE), and the card's
    # own bfloat16-vs-float32 gap between 0.8x and 1.25x the CPU's (the
    # rule the CPU tests hold the port to against JAX: the lower side
    # fails a refinement that ignores bfloat16)
    f32_cfg = get_config(name.replace("bf16", "f32"), **STEREO_TINY)
    f32 = build_model(f32_cfg)
    f32.load_state_dict(cpu.state_dict())
    ref = StereoModel(cfg, f32.eval(), torch.device("cpu")).forward(x, x)
    card_ref = StereoModel(f32_cfg, copy.deepcopy(f32).to(cuda), cuda) \
        .forward(x.to(cuda), x.to(cuda))
    for i, (g, w) in enumerate(zip(got["disps"], want["disps"])):
        assert g.dtype == torch.float32
        diff = (g.cpu() - w).abs()
        if dtype == "f32":
            assert diff.max() <= 1e-2
        elif i == 3:
            assert diff.mean() <= 0.05
        else:
            own = (w - ref["disps"][i]).abs().mean()
            card_own = (g - card_ref["disps"][i]).abs().mean().cpu()
            assert diff.mean() <= 2 * own + 0.01, (i, diff.mean(), own)
            assert 0.8 * own <= card_own <= 1.25 * own + 1e-3, (
                i, card_own, own)
    batch = {"leftImage": rng.randn(2, 64, 128, 3),
             "rightImage": rng.randn(2, 64, 128, 3),
             "leftDisp": rng.uniform(0, 30, (2, 64, 128, 1))}
    batch = {k: torch.tensor(v, dtype=torch.float32) for k, v in
             batch.items()}
    losses = []
    for module, device in ((card, cuda), (cpu, torch.device("cpu"))):
        ev = make_loss_evaluator(cfg["model"]["losses"])
        opt, _ = build_optimizer(cfg, module, 10)
        kernels.reset_launch_counts()
        _, metrics = make_train_step(ev)(
            TrainState.create(module, opt, 1),
            {k: v.to(device) for k, v in batch.items()})
        if device.type == "cuda":
            counts = kernels.launch_counts()
            assert counts["conv3d_packed_s1"] == 4, counts
            assert counts["fused_soft_argmin"] == 1, counts
            assert counts["fused_soft_argmin_backward"] == 1, counts
        losses.append({k: float(v) for k, v in metrics.items()})
    assert sorted(losses[0]) == ["grad_norm", "l1_loss_lvl0", "l1_loss_lvl1",
                                 "l1_loss_lvl2", "l1_loss_lvl3", "loss"]
    for k, v in losses[1].items():
        assert np.isfinite(losses[0][k]), k
        # float32: cuDNN vs the CPU (the PSMNet step's 1e-3); bfloat16:
        # the losses within 1 %, the gradients' norm within 10 %
        tol = (1e-3 if dtype == "f32" else
               0.1 if k == "grad_norm" else 0.01)
        assert abs(losses[0][k] - v) <= tol * abs(v), (k, losses[0][k], v)


# a volume just over 2^31 elements: [4, 64, 128, 2049, 32] holds
# 2^31 + 2^20 of them, as does the output of a 32 -> 32 unit
FAULT9_SHAPE = (4, 64, 128, 2049, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["K1", "K4", "K4-bf16"])
def test_trunk_kernels_past_2_31_elements_on_card(cuda, route):
    """ROADMAP.md section 3 fault 9: K1 and K4 (its float32 block and its
    bfloat16 route, pack 1) take a volume of 2^31 elements or more, as
    JAX's Pallas kernels do, and match their plain version on the card
    over every element (the last batch item lies past 2^31): 1e-4 of the
    largest output in float32, a bfloat16 step besides in bfloat16."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    dtype = torch.bfloat16 if route == "K4-bf16" else torch.float32
    x = torch.randn(FAULT9_SHAPE, device=cuda, generator=gen).to(dtype)
    assert x.numel() >= 2 ** 31
    kernel = torch.randn((3, 3, 3, 32, 32), device=cuda,
                         generator=gen) * (27 * 32) ** -0.5
    scale = torch.rand(32, device=cuda, generator=gen) + 0.5
    bias = torch.randn(32, device=cuda, generator=gen) * 0.1
    kernels.reset_launch_counts()
    if route == "K1":
        got = kernels.fused_conv3d(x, kernel, scale, bias, relu=True)
        assert kernels.launch_counts()["fused_conv3d"] == 1
    else:
        got = kernels.conv3d_packed_s1(x, kernel.to(dtype), scale, bias,
                                       pack=1, relu=True)
        assert kernels.launch_counts()["conv3d_packed_s1"] == 1
    want = kernels.conv3d_packed_s1_plain(x, kernel.to(dtype), scale, bias,
                                          pack=1, relu=True)
    assert got.shape == want.shape == FAULT9_SHAPE and got.dtype == dtype
    top = want.float().abs().max().item()
    tol = 1e-4 * top + (BF16_STEP * top if dtype == torch.bfloat16 else 0)
    for b in range(FAULT9_SHAPE[0]):
        err = (got[b].float() - want[b].float()).abs().max().item()
        assert err <= tol, (b, err, tol)


TINY_GCNET = {"model.max_disp": 32,
              "model.cost_processor.cost_computation.max_disp": 16,
              "model.cost_processor.cost_aggregator.max_disp": 32,
              "model.disp_predictor.max_disp": 32,
              "model.losses.l1_loss.max_disp": 32}
TINY_DEEPPRUNER = {"model.max_disp": 64,
                   "model.losses.l1_loss.max_disp": 64,
                   "model.losses.quantile_loss.max_disp": 64}


def card_and_cpu_step(cfg, cpu, card, cuda, batch):
    """One train step of ``card`` (on the card) and ``cpu`` from the same
    weights and batch: (their metrics, the card's launch counts)."""
    out = []
    for module, device in ((card, cuda), (cpu, torch.device("cpu"))):
        ev = make_loss_evaluator(cfg["model"]["losses"])
        opt, _ = build_optimizer(cfg, module, 10)
        kernels.reset_launch_counts()
        _, metrics = make_train_step(ev)(
            TrainState.create(module, opt, 1),
            {k: v.to(device) for k, v in batch.items()})
        out.append({k: float(v) for k, v in metrics.items()})
        if device.type == "cuda":
            counts = kernels.launch_counts()
    return out, counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tiny_gcnet_on_card_matches_cpu(cuda, dtype):
    """GCNet at max_disp 32 on a 64x128 pair: the eval forward on the card
    (the 10 stride-1 units on K1 in float32, K4's bfloat16 route in
    bfloat16, 12 launches with c31 and c32 in two Ci slices; K2 once on
    the full-resolution cost) against the plain versions on the CPU, same
    weights; then one train step (K4 10 or 12, K2 1 forward and 1
    backward) against the CPU's losses."""
    from densematchingbenchmark_tpu_torch.apis import StereoModel
    cfg = get_config(f"GCNet/scene_flow_{dtype}", **TINY_GCNET)
    cpu = draw_bn(build_model(cfg, torch.Generator().manual_seed(0)), 0)
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(1, 64, 128, 3), dtype=torch.float32)
    units = 10 if dtype == "f32" else 12
    kernels.reset_launch_counts()
    got = StereoModel(cfg, card.eval(), cuda).forward(x.to(cuda), x.to(cuda))
    counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
    assert counts == {"fused_conv3d": units if dtype == "f32" else 0,
                      "fused_soft_argmin": 1,
                      "fused_soft_argmin_backward": 0,
                      "fused_upsample_soft_argmin": 0,
                      "conv3d_packed_s1": 0 if dtype == "f32" else units,
                      "conv3d_packed_s1_v2": 0}, counts
    assert bf16["conv3d_packed_s1"] == (0 if dtype == "f32" else units)
    want = StereoModel(cfg, cpu.eval(), torch.device("cpu")).forward(x, x)
    g, w = got["disps"][0].cpu(), want["disps"][0]
    assert g.shape == w.shape == (1, 64, 128, 1)
    # float32: cuDNN vs the CPU's convolutions through the soft-argmin
    # (the PSMNet slice's 1e-2 px); bfloat16: the mean gap within the CPU
    # tests' 0.05 px
    if dtype == "f32":
        assert (g - w).abs().max() <= 1e-2
    else:
        assert (g - w).abs().mean() <= 0.05
    batch = {"leftImage": rng.randn(1, 64, 128, 3),
             "rightImage": rng.randn(1, 64, 128, 3),
             "leftDisp": rng.uniform(0, 30, (1, 64, 128, 1))}
    batch = {k: torch.tensor(v, dtype=torch.float32)
             for k, v in batch.items()}
    (card_m, cpu_m), counts = card_and_cpu_step(cfg, cpu, card, cuda, batch)
    assert counts["conv3d_packed_s1"] == units, counts
    assert counts["fused_soft_argmin"] == 1, counts
    assert counts["fused_soft_argmin_backward"] == 1, counts
    assert sorted(card_m) == ["grad_norm", "l1_loss_lvl0", "loss"]
    for k, v in cpu_m.items():
        # float32: cuDNN vs the CPU (the PSMNet step's 1e-3); bfloat16:
        # the losses within 1 %, the gradients' norm within 10 %
        tol = 1e-3 if dtype == "f32" else 0.1 if k == "grad_norm" else 0.01
        assert abs(card_m[k] - v) <= tol * abs(v), (k, card_m[k], v)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", ["4x", "8x"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tiny_deeppruner_on_card_matches_cpu(cuda, dtype, scale):
    """DeepPruner 4x and 8x at max_disp 64 on a 64x128 pair (the 8x
    model's hourglasses need H / 64 whole): the eval forward on the card
    (its 20 stride-1 units on K1 in float32, K4's bfloat16 route in
    bfloat16, 23 launches with the three hourglasses' 128 -> 128 units in
    two Ci slices; the eval noise the same draw on both devices)
    against the plain versions on the CPU, same weights; then one train
    step (K4 20 or 23) against the CPU's losses, the noise drawn from each
    step's generator, seeded alike."""
    from densematchingbenchmark_tpu_torch.apis import StereoModel
    cfg = get_config(f"DeepPruner/scene_flow_{scale}_{dtype}",
                     **TINY_DEEPPRUNER)
    n_disps = 4 if scale == "4x" else 5     # refined..., post, min, max
    cpu = draw_bn(build_model(cfg, torch.Generator().manual_seed(0)), 0)
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(1, 64, 128, 3), dtype=torch.float32)
    units = 20 if dtype == "f32" else 23
    kernels.reset_launch_counts()
    got = StereoModel(cfg, card.eval(), cuda).forward(x.to(cuda), x.to(cuda))
    counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
    assert counts == {"fused_conv3d": units if dtype == "f32" else 0,
                      "fused_soft_argmin": 0,
                      "fused_soft_argmin_backward": 0,
                      "fused_upsample_soft_argmin": 0,
                      "conv3d_packed_s1": 0 if dtype == "f32" else units,
                      "conv3d_packed_s1_v2": 0}, counts
    assert bf16["conv3d_packed_s1"] == (0 if dtype == "f32" else units)
    want = StereoModel(cfg, cpu.eval(), torch.device("cpu")).forward(x, x)
    assert len(got["disps"]) == len(want["disps"]) == n_disps
    for g, w in zip(got["disps"], want["disps"]):
        diff = (g.cpu() - w).abs()
        # float32: cuDNN vs the CPU's convolutions through PatchMatch's
        # softmax selections (1e-2 px); bfloat16: the mean within 0.05 px
        assert (diff.max() if dtype == "f32" else diff.mean()) <= (
            1e-2 if dtype == "f32" else 0.05), diff.max()
    batch = {"leftImage": rng.randn(2, 64, 128, 3),
             "rightImage": rng.randn(2, 64, 128, 3),
             "leftDisp": rng.uniform(0, 60, (2, 64, 128, 1))}
    batch = {k: torch.tensor(v, dtype=torch.float32)
             for k, v in batch.items()}
    (card_m, cpu_m), counts = card_and_cpu_step(cfg, cpu, card, cuda, batch)
    assert counts["conv3d_packed_s1"] == units, counts
    assert counts["fused_soft_argmin"] == 0, counts
    assert sorted(card_m) == sorted(
        ["grad_norm", "loss", "quantile_loss"]
        + [f"l1_loss_lvl{i}" for i in range(n_disps)])
    for k, v in cpu_m.items():
        tol = 1e-3 if dtype == "f32" else 0.1 if k == "grad_norm" else 0.01
        assert abs(card_m[k] - v) <= tol * abs(v), (k, card_m[k], v)


@pytest.mark.cuda
def test_tiny_deeppruner_train_step_issues_no_synchronising_call_on_card(
        cuda):
    """A DeepPruner train step on the card draws its PatchMatch noise from
    the state's host generator and copies it from pinned memory: the step
    (forward, losses, gradients, clip and update) issues no synchronising
    call."""
    cfg = get_config("DeepPruner/scene_flow_4x_f32", **TINY_DEEPPRUNER)
    module = build_model(cfg, torch.Generator().manual_seed(0)).to(cuda)
    opt, _ = build_optimizer(cfg, module, 10)
    state = TrainState.create(module, opt, 1)
    step = make_train_step(make_loss_evaluator(cfg["model"]["losses"]))
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {"leftImage": torch.randn((2, 64, 128, 3), device=cuda,
                                      generator=gen),
             "rightImage": torch.randn((2, 64, 128, 3), device=cuda,
                                       generator=gen),
             "leftDisp": torch.rand((2, 64, 128, 1), device=cuda,
                                    generator=gen) * 60}
    assert state.generator.device.type == "cpu"
    _sync_free(lambda: step(state, batch))


# AnyNet's aggregator widths (Cin, Cout): init_guess 8 -> 16 and 16 -> 16,
# warp_level_8 4 -> 4, warp_level_4 2 -> 4 (float32 pads Ci to 4; bfloat16
# Ci to 16 and Co to 8)
ANYNET_WIDTHS = [(8, 16), (16, 16), (4, 4), (2, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci,co", ANYNET_WIDTHS)
def test_prenorm_unit_at_anynet_widths_on_card(cuda, ci, co, dtype, train):
    """AnyNet's pre-norm unit (BN -> ReLU -> conv + bias) runs its conv on
    the kernels: in eval one launch of K1 (float32) or K4's bfloat16
    route, with unit scale and the bias as the epilogue's shift; in
    training one of K4 at unit scale, then the bias. Against the unfused
    BN -> ReLU -> conv + bias on the same weights, the conv in float32 on
    the unit's rounded input: within 1e-4 of the largest output in
    float32 and one bfloat16 step besides in bfloat16."""
    from densematchingbenchmark_tpu_torch.models.layers import bn_relu_conv3d
    unit = draw_bn(bn_relu_conv3d(True, ci, co, dtype=dtype), ci + co)
    with torch.no_grad():
        unit.Conv_0.bias.copy_(torch.randn(co, generator=torch.Generator()
                                           .manual_seed(co)) * 0.5)
    unit = unit.to(cuda).train(train)
    assert unit.fusable and unit.pre_norm
    x = torch.randn((2, 5, 12, 20, ci), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(ci))
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = unit(x)
        torch.cuda.synchronize()
        counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
        name = ("fused_conv3d" if dtype == torch.float32 and not train
                else "conv3d_packed_s1")
        assert counts[name] == 1 and sum(counts.values()) == 1, counts
        assert bf16["conv3d_packed_s1"] == int(dtype == torch.bfloat16)
        bn = unit.BatchNorm_0
        xn = torch.relu(torch.nn.functional.batch_norm(
            x.movedim(-1, 1).to(dtype).float(), bn.running_mean,
            bn.running_var, bn.weight, bn.bias, train, 0.0, bn.eps)
            .to(dtype))
        want = torch.nn.functional.conv3d(
            xn.float(), unit.Conv_0.weight.to(dtype).float(),
            unit.Conv_0.bias, padding=1).movedim(1, -1)
    assert got.dtype == dtype and got.shape == want.shape
    tol = (1e-4 + (0 if dtype == torch.float32 else BF16_STEP)) * \
        want.abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol


def peak_anynet_costs(module, seed=1):
    """Draw an AnyNet's conv biases (0.1 N(0, 1)) and scale its stages'
    last units (Co = 1) by 30. At its seeded weights the costs are nearly
    flat, and each stage returns about the middle of its range whatever
    its units compute; these weights spread the stages over tens of
    pixels."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)) and \
                    m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
        for st in ("init_guess", "warp_level_8", "warp_level_4"):
            getattr(module, f"agg_{st}").ConvUnit_5.Conv_0.weight.mul_(30.0)
    return module


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tiny_anynet_on_card_matches_cpu(cuda, dtype):
    """AnyNet's shipped config (its full width) on a 64x128 pair, with
    weights that peak its costs: the eval forward on the card (the 15
    pre-norm aggregator units on K1 in float32 or K4's bfloat16 route, K2
    on each stage's cost, 3 launches) against the plain versions on the
    CPU, same weights; then one train step (K4 15, K2 3 forward and 3
    backward) against the CPU's losses."""
    from densematchingbenchmark_tpu_torch.apis import StereoModel
    name = f"AnyNet/scene_flow_{dtype}"
    cfg = get_config(name)
    cpu = peak_anynet_costs(draw_bn(build_model(
        cfg, torch.Generator().manual_seed(0)), 0))
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(1, 64, 128, 3), dtype=torch.float32)
    kernels.reset_launch_counts()
    got = StereoModel(cfg, card.eval(), cuda).forward(x.to(cuda), x.to(cuda))
    counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
    k1 = 15 if dtype == "f32" else 0
    assert counts == {"fused_conv3d": k1, "fused_soft_argmin": 3,
                      "fused_soft_argmin_backward": 0,
                      "fused_upsample_soft_argmin": 0,
                      "conv3d_packed_s1": 15 - k1,
                      "conv3d_packed_s1_v2": 0}, counts
    assert bf16["conv3d_packed_s1"] == 15 - k1
    want = StereoModel(cfg, cpu.eval(), torch.device("cpu")).forward(x, x)
    assert len(got["disps"]) == len(want["disps"]) == 4
    # the peaked costs spread the stages over the frame (at the seeded
    # weights: a std of 0.2-0.4 px)
    for d in want["disps"][1:]:
        assert d.std() >= 1.0, d.std()
    # float32: cuDNN vs the CPU's convolutions through three stages and the
    # refinement (the PSMNet slice's 1e-2 px). bfloat16: the stages'
    # disparities within the CPU tests' 0.05 px mean; the refined one
    # carries bfloat16's own error on each side at the scale of its
    # residual: within twice the CPU's own bfloat16-vs-float32 gap plus
    # 0.01 px, and the card's own gap between 0.8x and 1.25x the CPU's
    # (the rule of test_tiny_stereonet_on_card_matches_cpu)
    f32_cfg = get_config("AnyNet/scene_flow_f32")
    f32 = build_model(f32_cfg)
    f32.load_state_dict(cpu.state_dict())
    ref = StereoModel(cfg, f32.eval(), torch.device("cpu")).forward(x, x)
    card_ref = StereoModel(f32_cfg, copy.deepcopy(f32).to(cuda), cuda) \
        .forward(x.to(cuda), x.to(cuda))
    for i, (g, w) in enumerate(zip(got["disps"], want["disps"])):
        assert g.dtype == torch.float32
        diff = (g.cpu() - w).abs()
        if dtype == "f32":
            assert diff.max() <= 1e-2, (i, diff.max())
        elif i > 0:
            assert diff.mean() <= 0.05, (i, diff.mean())
        else:
            own = (w - ref["disps"][i]).abs().mean()
            card_own = (g - card_ref["disps"][i]).abs().mean().cpu()
            assert diff.mean() <= 2 * own + 0.01, (i, diff.mean(), own)
            assert 0.8 * own <= card_own <= 1.25 * own + 1e-3, (
                i, card_own, own)
    batch = {"leftImage": rng.randn(2, 64, 128, 3),
             "rightImage": rng.randn(2, 64, 128, 3),
             "leftDisp": rng.uniform(0, 120, (2, 64, 128, 1))}
    batch = {k: torch.tensor(v, dtype=torch.float32)
             for k, v in batch.items()}
    (card_m, cpu_m), counts = card_and_cpu_step(cfg, cpu, card, cuda, batch)
    assert counts["conv3d_packed_s1"] == 15, counts
    assert counts["fused_soft_argmin"] == 3, counts
    assert counts["fused_soft_argmin_backward"] == 3, counts
    assert sorted(card_m) == ["grad_norm"] + [
        f"l1_loss_lvl{i}" for i in range(4)] + ["loss"]
    for k, v in cpu_m.items():
        # float32: cuDNN vs the CPU (the PSMNet step's 1e-3); bfloat16:
        # the losses within 1 %, the gradients' norm within 10 %
        tol = 1e-3 if dtype == "f32" else 0.1 if k == "grad_norm" else 0.01
        assert abs(card_m[k] - v) <= tol * abs(v), (k, card_m[k], v)


# the tiny flow models of tests/flow_parity.py, and their frame sizes
TINY_FLOW = {
    "PWCFlow/flying_chairs": ({"model.chans": (8, 16, 16),
                               "model.radius": 2, "model.hidden": 16,
                               "model.losses.flow_l1_loss.weights":
                               (1.0, 1.0, 0.5, 0.25)}, (64, 96)),
    "RAFT/flying_chairs": ({"model.iters": 2, "model.hidden": 32,
                            "model.context": 16,
                            "model.losses.flow_l1_loss.weights":
                            (1.0, 1.0, 0.8)}, (64, 96)),
}


def peak_flow_scores(module, seed=1):
    """Draw a flow model's conv biases (0.1 N(0, 1)) and scale PWCFlow's
    score convs (each FlowEstimator's ConvUnit_2) by 8, as
    tests/flow_parity.py does. At its seeded weights PWCFlow's flows stay
    near 0, which a wrong level or dtype would not move; these weights
    move them by pixels."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
        for est in getattr(module, "FlowEstimator", ()):
            est.ConvUnit_2.Conv_0.weight.mul_(8.0)
    return module


def flow_pair(rng, b, h, w):
    ref = rng.randn(b, h, w, 3)
    tgt = np.roll(ref, (1, 2), axis=(1, 2)) + 0.1 * rng.randn(b, h, w, 3)
    return (torch.tensor(ref, dtype=torch.float32),
            torch.tensor(tgt, dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("family", sorted(TINY_FLOW))
def test_tiny_flow_model_on_card_matches_cpu(cuda, family, dtype):
    """A tiny PWCFlow and a tiny RAFT on a 64x96 pair, on weights that
    move the flows by pixels (the best flow's mean |flow| on the CPU at
    least 1 px): the eval forward on the card (cuDNN's 2-D convs, the
    plain correlation, warp, soft-argmax and lookup; none of the port's
    kernels) against the CPU, same weights: float32 every flow within
    1e-2 px max (cuDNN against the CPU's convolutions, TF32 off),
    bfloat16 within 0.05 px mean; then
    one train step against the CPU's losses (float32 1e-3, bfloat16 1 %)
    and gradient norm (float32 1e-3, bfloat16 10 %)."""
    from densematchingbenchmark_tpu_torch.apis import StereoModel
    from densematchingbenchmark_tpu_torch.trainer import make_flow_train_step
    over, (h, w) = TINY_FLOW[family]
    cfg = get_config(f"{family}_{dtype}", **over)
    cpu = peak_flow_scores(draw_bn(build_model(
        cfg, torch.Generator().manual_seed(0)), 0))
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.RandomState(0)
    ref, tgt = flow_pair(rng, 1, h, w)
    kernels.reset_launch_counts()
    got = StereoModel(cfg, card.eval(), cuda).forward(ref.to(cuda),
                                                    tgt.to(cuda))
    assert set(kernels.launch_counts().values()) == {0}
    want = StereoModel(cfg, cpu.eval(), torch.device("cpu")).forward(ref, tgt)
    n = 4 if family.startswith("PWC") else 3
    assert len(got["flows"]) == len(want["flows"]) == n
    assert want["flows"][0].abs().mean() >= 1.0
    for i, (g, wnt) in enumerate(zip(got["flows"], want["flows"])):
        assert g.dtype == torch.float32 and g.shape == wnt.shape
        diff = (g.cpu() - wnt).abs()
        if dtype == "f32":
            assert diff.max() <= 1e-2, (i, diff.max())
        else:
            assert diff.mean() <= 0.05, (i, diff.mean())
    batch = dict(zip(("leftImage", "rightImage"), flow_pair(rng, 2, h, w)))
    batch["flow"] = torch.tensor(rng.randn(2, h, w, 2) + (2.0, 1.0),
                                 dtype=torch.float32)
    weights = cfg["model"]["losses"]["flow_l1_loss"]["weights"]
    out = []
    for module, device in ((card, cuda), (cpu, torch.device("cpu"))):
        opt, _ = build_optimizer(cfg, module, 10)
        kernels.reset_launch_counts()
        _, metrics = make_flow_train_step(weights)(
            TrainState.create(module, opt, 1),
            {k: v.to(device) for k, v in batch.items()})
        out.append({k: float(v) for k, v in metrics.items()})
        assert set(kernels.launch_counts().values()) == {0}
    card_m, cpu_m = out
    assert sorted(card_m) == ["flow_loss_lvl%d" % i for i in range(n)] + [
        "grad_norm", "loss"]
    for k, v in cpu_m.items():
        tol = 1e-3 if dtype == "f32" else 0.1 if k == "grad_norm" else 0.01
        assert abs(card_m[k] - v) <= tol * abs(v), (k, card_m[k], v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_parallel_gloo_pair_on_one_card_matches_one_rank(cuda, dtype,
                                                         tmp_path):
    """Two gloo ranks on cuda:0 (train_matcher, a small PSMNet, 2 x 2
    samples, 2 steps; tests/torch_parallel_ranks.py 'card') against one
    rank at 4 on the same weights and data. The first step (the global
    batch's semantics, before any update): its loss within rtol 1e-4 in
    float32 (1 % in bfloat16); in float32 its BN statistics within 1e-4 of
    their largest value and each parameter's gradient's cosine above
    0.999. After RMSprop's first update (about 10 lr times the sign of
    every gradient element) float32 noise moves the parameters by whole
    updates, as a 1e-7 perturbation of the weights alone does: later
    steps are held finite. The ranks' gradients and parameters bitwise
    equal, K4 and K2 on both ranks."""
    from torch_parallel_ranks import (CARD_STEPS, RANKS, finish_ranks,
                                      free_port, start_ranks)
    out = str(tmp_path)
    port = free_port()
    finish_ranks(start_ranks(
        [[RANKS, "card", out, "0", "1", "0", dtype]]
        + [[RANKS, "card", out, str(r), "2", str(port), dtype]
           for r in range(2)]), timeout=600)
    load = lambda name: torch.load(f"{out}/{name}.pt",      # noqa: E731
                                   weights_only=False)
    one, two = load("card1_0"), [load(f"card2_{r}") for r in range(2)]
    for res in two:
        k = res["launches"]
        assert k["conv3d_packed_s1"] == 13 * CARD_STEPS, k
        assert k["fused_soft_argmin_backward"] == 3 * CARD_STEPS, k
        assert res["bf16_launches"]["conv3d_packed_s1"] == (
            13 * CARD_STEPS if dtype == "bf16" else 0)
        assert res["collectives"]["all_reduce"] > 0
    assert set(one["collectives"].values()) == {0}
    for n, p in two[0]["params"].items():
        assert torch.equal(p, two[1]["params"][n]), n
    for g, h in zip(two[0]["first"]["grads"], two[1]["first"]["grads"]):
        assert torch.equal(g, h)
    losses, want = two[0]["losses"], one["losses"]
    assert len(losses) == len(want) == CARD_STEPS
    assert np.isfinite(losses).all()
    rtol = 1e-4 if dtype == "f32" else 0.01
    assert abs(losses[0] - want[0]) <= rtol * abs(want[0]), (losses, want)
    if dtype == "f32":
        got, ref = two[0]["first"]["buffers"], one["first"]["buffers"]
        names = [n for n, t in ref.items() if t.is_floating_point()]
        top = max(float(ref[n].abs().max()) for n in names)
        for n in names:
            err = float((got[n] - ref[n]).abs().max())
            assert err <= 1e-4 * top, (n, err, top)
        grads = two[0]["first"]["grads"]
        ref = one["first"]["grads"]
        gtop = max(float(w.abs().max()) for w in ref)
        for g, w in zip(grads, ref):
            if float(w.abs().max()) > 1e-6 * gtop:    # not a bias before BN
                cos = float((g * w).sum() / (g.norm() * w.norm()))
                assert cos > 0.999, cos


@pytest.mark.cuda
def test_parallel_nccl_rank_runs_the_collectives_on_card(cuda, tmp_path,
                                                         monkeypatch):
    """tools/train.main --launcher env as the one rank of an NCCL group
    (WORLD_SIZE 1) on a small PSMNet: 2 steps and the per-epoch eval, each
    collective counted; the tool leaves the group at the end."""
    from densematchingbenchmark_tpu_torch.parallel import (
        collective_counts, reset_collective_counts)
    from densematchingbenchmark_tpu_torch.tools import train as ttrain
    from torch_parallel_ranks import CARD_SMALL, free_port
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    reset_collective_counts()
    state = ttrain.main(
        ["--config", "PSMNet/scene_flow_f32", "--work-dir", str(tmp_path),
         "--synthetic", "--synthetic-shape", "64", "128",
         "--synthetic-length", "2", "--synthetic-eval", "2",
         "--max-steps", "2", "--log-interval", "1", "--launcher", "env",
         "--override", *[f"{k}={v}" for k, v in CARD_SMALL.items()]])
    assert not torch.distributed.is_initialized()
    assert next(state.module.parameters()).device == torch.device("cuda", 0)
    # a step: 3 loss counts, the gradients, the metrics; the eval: keys
    # and sums; the broadcast of float32 and int64 tensors; the checkpoint
    assert collective_counts() == {"all_reduce": 11, "all_gather": 1,
                                   "broadcast": 2, "barrier": 1}



CORR = {"model.cost_processor.type": "Correlation"}
TINY_CORR = {"PSMNet": dict(TINY, **CORR), "AcfNet": dict(
    TINY, **CORR, **{"model.losses.focal_loss.max_disp": 64}),
    "GCNet": dict(TINY_GCNET, **CORR)}


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(TINY_CORR))
def test_correlation_model_on_card_matches_cpu(cuda, family):
    """PSMNet, AcfNet (uniform) and GCNet with the Correlation cost
    processor, small, on a 64x128 pair, in each dtype from one tree of
    weights: the eval forward on the card (the first trunk unit takes the
    one-channel volume, padded with zero channels to the kernels' widths:
    K1 in float32, K4's bfloat16 route in bfloat16) against the plain
    versions on the CPU. Float32: every disparity within 1e-2 px (cuDNN
    against the CPU's convolutions through the soft-argmin, the PSMNet
    slice's bound). Bfloat16: the correlation volume rounds sums of 32
    products, which makes this model's own bfloat16-vs-float32 gap about
    10 times the concatenation model's (on the CPU 0.13-0.19 px mean for
    PSMNet here, against 0.008-0.017); so each disparity is held by the
    CPU's own gap: within twice it plus 0.01 px of the CPU's, and the
    card's own gap at least half the CPU's (a model that ignored bfloat16
    would have none; the gap bound caps it above at three times the
    CPU's: measured 0.8-1.26 times)."""
    from densematchingbenchmark_tpu_torch.apis import StereoModel
    name = {"PSMNet": "PSMNet/scene_flow", "GCNet": "GCNet/scene_flow",
            "AcfNet": "AcfNet/scene_flow_uniform"}[family]
    x = torch.tensor(np.random.RandomState(0).randn(1, 64, 128, 3),
                     dtype=torch.float32)
    state = None
    disps = {}
    for dtype in ("f32", "bf16"):
        cfg = get_config(f"{name}_{dtype}", **TINY_CORR[family])
        cpu = build_model(cfg, torch.Generator().manual_seed(0))
        if state is None:
            state = draw_bn(cpu, 0).state_dict()
        cpu.load_state_dict(state)
        card = copy.deepcopy(cpu).to(cuda)
        assert card.cost_processor.aggregator.ConvUnit_0.in_features == 1
        units = {"PSMNet": 13, "AcfNet": 13,
                 "GCNet": 10 if dtype == "f32" else 12}[family]
        kernels.reset_launch_counts()
        got = StereoModel(cfg, card.eval(), cuda).forward(x.to(cuda),
                                                          x.to(cuda))
        counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
        assert counts["fused_conv3d"] == (units if dtype == "f32" else 0)
        assert bf16["conv3d_packed_s1"] == (0 if dtype == "f32" else units)
        want = StereoModel(cfg, cpu.eval(), torch.device("cpu")).forward(
            x, x)
        disps[dtype] = ([g.cpu() for g in got["disps"]], want["disps"])
        assert len(got["disps"]) == len(want["disps"])
    for (g, w), (g32, w32) in zip(zip(*disps["bf16"]), zip(*disps["f32"])):
        assert g.shape == w.shape == (1, 64, 128, 1)
        assert (g32 - w32).abs().max() <= 1e-2
        gap = (g - w).abs().mean()
        own, card_own = (w - w32).abs().mean(), (g - g32).abs().mean()
        assert gap <= 2 * own + 0.01, (gap, own)
        assert card_own >= 0.5 * own, (card_own, own)


@pytest.mark.cuda
def test_measurement_tools_on_card(cuda, tmp_path):
    """The zoo table, the train-step table, the profiler and the loader
    rate on the card at a few iterations on PSMNet: positive times, the
    parameter count the module's, GFLOPs, the device's kernels listed, the
    card's name on every row."""
    from densematchingbenchmark_tpu_torch.tools import (loader_throughput,
                                                        profile_model,
                                                        train_throughput)
    from densematchingbenchmark_tpu_torch.tools import benchmark as zoo
    name = torch.cuda.get_device_name(0)
    rows = zoo.main(["--models", "PSMNet/scene_flow", "--dtype", "bfloat16",
                     "--iters", "2", "--json"])
    module = build_model(get_config("PSMNet/scene_flow_bf16"))
    assert rows[0]["params"] == sum(p.numel() for p in module.parameters())
    assert rows[0]["latency_ms"] > 0 and rows[0]["gflops"] > 0
    assert rows[0]["device"] == name
    recs = train_throughput.main(["--only", "StereoNet/scene_flow_8x_2",
                                  "--iters", "2"])
    assert len(recs) == 1 and recs[0]["f32_ms"] > 0 and \
        recs[0]["bf16_ms"] > 0
    summary = profile_model.main(["--config", "PSMNet/scene_flow",
                                  "--height", "256", "--width", "512",
                                  "--iters", "1", "--out",
                                  str(tmp_path / "trace.json")])
    assert summary["busy_ms"] > 0 and summary["launches"] > 0
    assert any("conv3d_wgmma" in k for k, _, _ in summary["kernels"])
    rec = loader_throughput.main(["--n", "3", "--epochs", "1",
                                  "--workdir", str(tmp_path / "set")])
    assert rec["value"] > 0 and rec["device"] == name
