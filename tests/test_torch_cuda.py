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
def test_bf16_unit_at_an_unsupported_width_raises_on_card(cuda, train):
    """A bfloat16 trunk unit whose widths K4's wgmma route does not take
    (Cin 24) raises, in eval and in training: no unit falls back to
    float32 or to the plain version."""
    from densematchingbenchmark_tpu_torch.models.layers import ConvUnit
    unit = ConvUnit(24, 32, 3, 1, 1, dims=3, bias=False,
                    dtype=torch.bfloat16).to(cuda).train(train)
    x = torch.randn((1, 4, 6, 8, 24), device=cuda)
    before = kernels.conv3d_packed_s1.launches
    with pytest.raises(ValueError, match="bfloat16"):
        unit(x)
    assert kernels.conv3d_packed_s1.launches == before


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
