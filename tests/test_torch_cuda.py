"""The port's hand-written kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a GPU machine that has none; from the repository root:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the CPU suite.) Shapes
are small and ragged (edges that no block size divides). The kernels and
the plain versions both compute in float32 and differ in the order of their
sums; tolerances are stated per test.
"""

import numpy as np
import pytest
import torch

from densematchingbenchmark_tpu_torch.apis import init_model, inference_stereo
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.ops.cost_volume import (
    disp_sample_values)

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
