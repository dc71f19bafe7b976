"""The port's kernel modules (ops/cuda/) against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the Pallas kernel in interpret mode, as tests/ops/
test_pallas_kernels.py runs it, on the same numpy-seeded inputs. Both are
float32 and differ in the order of their sums (tolerances stated per test).
The kernels themselves are held against their plain versions on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.ops.pallas.conv3d_kernel import (
    fused_conv3d as pallas_conv3d)
from densematchingbenchmark_tpu.ops.pallas.soft_argmin_kernel import (
    fused_soft_argmin as pallas_soft_argmin)
from densematchingbenchmark_tpu.ops.pallas.upsample_argmin_kernel import (
    _interp_matrix, fused_upsample_soft_argmin as pallas_upsample_argmin)

from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.ops.cuda import _build
from densematchingbenchmark_tpu_torch.ops.interpolate import _axis_taps

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)


def conv_inputs(shape, cout, seed):
    rng = np.random.RandomState(seed)
    cin = shape[-1]
    return (rng.randn(*shape).astype(np.float32),
            (rng.randn(3, 3, 3, cin, cout) * 0.1).astype(np.float32),
            (rng.rand(cout) + 0.5).astype(np.float32),
            rng.randn(cout).astype(np.float32))


@pytest.mark.parametrize("relu", [True, False])
def test_conv3d_plain_matches_pallas(relu):
    x, k, scale, bias = conv_inputs((1, 4, 16, 24, 8), 16, seed=4)
    want = np.asarray(pallas_conv3d(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale),
        jnp.asarray(bias), relu=relu, interpret=True))
    before = kernels.fused_conv3d.launches
    got = kernels.fused_conv3d(*map(torch.from_numpy, (x, k, scale, bias)),
                               relu=relu)
    assert kernels.fused_conv3d.launches == before   # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (1, 4, 16, 24, 16)
    # 27 * 8 products summed in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,max_disp,start,dilation,alpha", [
    ((2, 16, 8, 128), 16, 0, 1, 1.0),
    ((1, 3, 8, 128), 6, -2, 2, 2.5),   # samples -2, 0.5, 3
])
def test_soft_argmin_plain_matches_pallas(shape, max_disp, start, dilation,
                                          alpha):
    cost = np.random.RandomState(shape[1]).randn(*shape).astype(
        np.float32) * 3
    want = np.asarray(pallas_soft_argmin(
        jnp.asarray(cost), max_disp=max_disp, start_disp=start,
        dilation=dilation, alpha=alpha, interpret=True))
    before = kernels.fused_soft_argmin.launches
    got = kernels.fused_soft_argmin(torch.from_numpy(cost), max_disp, start,
                                    dilation, alpha)
    assert kernels.fused_soft_argmin.launches == before
    assert got.shape == want.shape
    # softmax sums over D in another order: 1e-4 px
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_upsample_soft_argmin_plain_matches_pallas():
    low = np.random.RandomState(2).randn(1, 12, 8, 64).astype(np.float32)
    want = np.asarray(pallas_upsample_argmin(jnp.asarray(low), 48, 32, 256,
                                             interpret=True))
    before = kernels.fused_upsample_soft_argmin.launches
    got = kernels.fused_upsample_soft_argmin(torch.from_numpy(low), 48, 32,
                                             256)
    assert kernels.fused_upsample_soft_argmin.launches == before
    assert got.shape == want.shape == (1, 32, 256, 1)
    # lerps in another order (Pallas: matmuls against tap matrices), then
    # the softmax sums: 1e-3 px, as the JAX package's own test
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_upsample_soft_argmin_promotes_bf16():
    low = np.random.RandomState(3).randn(1, 6, 4, 64).astype(np.float32)
    got16 = kernels.fused_upsample_soft_argmin(
        torch.from_numpy(low).bfloat16(), 12, 8, 128)
    got32 = kernels.fused_upsample_soft_argmin(torch.from_numpy(low), 12, 8,
                                               128)
    assert got16.dtype == torch.float32
    np.testing.assert_allclose(got16.numpy(), got32.numpy(), atol=0.1)


@pytest.mark.parametrize("in_size,out_size", [(12, 48), (96, 384),
                                              (312, 1248), (7, 7), (1, 5),
                                              (5, 1), (3, 2)])
def test_axis_taps_match_pallas_interp_matrix(in_size, out_size):
    i0, i1, w1 = _axis_taps(in_size, out_size, align_corners=True)
    m = np.zeros((in_size, out_size), np.float32)
    cols = np.arange(out_size)
    np.add.at(m, (i0, cols), 1 - w1)
    np.add.at(m, (i1, cols), w1)
    np.testing.assert_allclose(m, _interp_matrix(in_size, out_size),
                               atol=1e-6)


def test_wrappers_refuse_other_devices():
    # a tensor on neither the CPU nor a GPU: raise, never fall back
    with pytest.raises(ValueError):
        kernels.fused_conv3d(torch.empty((1, 2, 3, 4, 4), device="meta"),
                             torch.empty((3, 3, 3, 4, 4), device="meta"))
    with pytest.raises(ValueError):
        kernels.fused_soft_argmin(torch.empty((1, 4, 2, 3), device="meta"),
                                  4)
    with pytest.raises(ValueError):
        kernels.fused_upsample_soft_argmin(
            torch.empty((1, 2, 2, 3), device="meta"), 4, 4, 6)


def test_every_cuda_source_is_built():
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.SOURCES) == sources
    for name in sources:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.suffix == ".so"


def test_reset_and_read_launch_counts():
    kernels.fused_conv3d.launches = 5
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {
        "fused_conv3d": 0, "fused_soft_argmin": 0,
        "fused_soft_argmin_backward": 0, "fused_upsample_soft_argmin": 0,
        "conv3d_packed_s1": 0}
