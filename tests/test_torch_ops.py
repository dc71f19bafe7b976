"""The PyTorch port's ops, layers, backbone, configs and transforms against
their JAX counterparts, on the CPU at small sizes.

Inputs come from numpy seeds and go to both sides; the JAX Flax variables
(with BatchNorm parameters and running statistics set to random,
non-trivial values, so that a wrong fold or a swapped mean/var shows) are
carried into the port by ``load_jax_variables``. Both sides compute in
float32 and differ only in the order of their sums, hence tolerances of
about 1e-4 relative.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu import configs as jconfigs
from densematchingbenchmark_tpu.data import transforms as jtransforms
from densematchingbenchmark_tpu.evaluation.metrics import (
    remove_padding as jremove_padding)
from densematchingbenchmark_tpu.models import layers as jlayers
from densematchingbenchmark_tpu.models.backbones.psmnet import (
    PSMNetBackbone as JBackbone)
from densematchingbenchmark_tpu.ops import cost_volume as jcv
from densematchingbenchmark_tpu.ops import interpolate as jinterp
from densematchingbenchmark_tpu.ops import pooling as jpool
from densematchingbenchmark_tpu.ops.soft_argmin import (
    soft_argmin as jsoft_argmin)

from densematchingbenchmark_tpu_torch import configs as tconfigs
from densematchingbenchmark_tpu_torch.data import transforms as ttransforms
from densematchingbenchmark_tpu_torch.evaluation.metrics import (
    remove_padding as tremove_padding)
from densematchingbenchmark_tpu_torch.models import layers as tlayers
from densematchingbenchmark_tpu_torch.models.backbones.psmnet import (
    PSMNetBackbone as TBackbone)
from densematchingbenchmark_tpu_torch.ops import cost_volume as tcv
from densematchingbenchmark_tpu_torch.ops import interpolate as tinterp
from densematchingbenchmark_tpu_torch.ops import pooling as tpool
from densematchingbenchmark_tpu_torch.ops.soft_argmin import (
    soft_argmin as tsoft_argmin)
from densematchingbenchmark_tpu_torch.utils import load_jax_variables

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)


def randomize_bn(variables, rng):
    """Numpy copy of ``variables`` with every BatchNorm's scale / bias /
    mean / var drawn at random (scale, var in [0.8, 1.25])."""
    def walk(tree, in_bn):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, in_bn or k == "BatchNorm_0")
            elif in_bn and k in ("scale", "var"):
                out[k] = rng.uniform(0.8, 1.25, v.shape).astype(np.float32)
            elif in_bn and k in ("bias", "mean"):
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.array(v)
        return out
    return walk(variables, False)


def jax_and_port(jmodule, tmodule, *inputs, seed=0, **kwargs):
    """Init ``jmodule`` on ``inputs``, randomize its BN, load the variables
    into ``tmodule`` (eval mode) and return both outputs as numpy."""
    jin = [jnp.asarray(x) if x is not None else None for x in inputs]
    variables = jmodule.init(jax.random.PRNGKey(seed), *jin, **kwargs)
    variables = randomize_bn(jax.tree.map(np.asarray, variables),
                             np.random.RandomState(seed))
    want = jmodule.apply(jax.tree.map(jnp.asarray, variables), *jin, **kwargs)
    load_jax_variables(tmodule, variables)
    tmodule.eval()
    with torch.no_grad():
        got = tmodule(*[torch.from_numpy(x) if x is not None else None
                        for x in inputs])
    as_np = lambda t: (tuple(np.asarray(a) for a in t)
                       if isinstance(t, tuple) else np.asarray(t))
    got = (tuple(g.numpy() for g in got) if isinstance(got, tuple)
           else got.numpy())
    return as_np(want), got


def test_disp_sample_values_is_a_linspace():
    # dilation > 1 gives a linspace, not start + i * dilation
    np.testing.assert_array_equal(tcv.disp_sample_values(6, -2, 2),
                                  np.float32([-2, 0.5, 3]))
    for args in ((48,), (192, 0, 1), (6, -2, 2), (7, 3, 3)):
        np.testing.assert_array_equal(tcv.disp_sample_values(*args),
                                      jcv.disp_sample_values(*args))


@pytest.mark.parametrize("max_disp,start,dilation",
                         [(8, 0, 1), (6, -2, 2), (5, 3, 1), (20, 0, 1)])
def test_cat_volume_matches_jax(max_disp, start, dilation):
    rng = np.random.RandomState(max_disp)
    ref = rng.randn(2, 5, 12, 3).astype(np.float32)
    tgt = rng.randn(2, 5, 12, 3).astype(np.float32)
    want = np.asarray(jcv.cat_volume(jnp.asarray(ref), jnp.asarray(tgt),
                                     max_disp, start, dilation))
    got = tcv.cat_volume(torch.from_numpy(ref), torch.from_numpy(tgt),
                         max_disp, start, dilation)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("in_shape,out_sizes", [
    ((1, 4, 6, 5, 2), (9, 13, 5)),   # up, up, same
    ((2, 7, 9, 8), (3, 4, 1)),       # down, down, to 1
    ((1, 1, 5, 3), (4, 5, 6)),       # from 1
])
def test_resize_linear_matches_jax(align_corners, in_shape, out_sizes):
    x = np.random.RandomState(7).randn(*in_shape).astype(np.float32)
    axes = (1, 2, 3)
    want = np.asarray(jinterp.resize_linear(jnp.asarray(x), out_sizes, axes,
                                            align_corners))
    got = tinterp.resize_linear(torch.from_numpy(x), out_sizes, axes,
                                align_corners).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("in_size,out_size,align_corners,dtype", [
    (12, 48, True, torch.float32), (96, 384, True, torch.float32),
    (7, 5, False, torch.float32), (5, 9, True, torch.float64)])
def test_axis_taps_tensors_are_exact_and_kept(in_size, out_size,
                                              align_corners, dtype):
    # made once per (sizes, dtype, device), bit for bit _axis_taps' values
    idx0, idx1, w1 = tinterp._axis_taps(in_size, out_size, align_corners)
    got = tinterp.axis_taps_tensors(in_size, out_size, align_corners, dtype,
                                    torch.device("cpu"))
    assert got[0].dtype == got[1].dtype == torch.int64
    assert got[2].dtype == dtype
    np.testing.assert_array_equal(got[0].numpy(), idx0)
    np.testing.assert_array_equal(got[1].numpy(), idx1)
    assert torch.equal(got[2], torch.as_tensor(w1, dtype=dtype))
    again = tinterp.axis_taps_tensors(in_size, out_size, align_corners,
                                      dtype, torch.device("cpu"))
    assert all(a is b for a, b in zip(got, again))


def test_resize_linear_result_is_unchanged_by_the_kept_taps():
    # the resize from kept taps equals, bit for bit, one from taps made
    # afresh, and taps first made under inference_mode serve autograd
    x = torch.from_numpy(np.random.RandomState(8).randn(2, 5, 6, 7, 3)
                         .astype(np.float32))
    sizes, axes = (11, 13, 9), (1, 2, 3)
    with torch.inference_mode():
        tinterp.resize_linear(x, (17, 19, 23), axes)
    want = x
    for axis, out_size in zip(axes, sizes):
        i0, i1, w1 = tinterp._axis_taps(want.shape[axis], out_size, True)
        shape = [1] * want.dim()
        shape[axis] = out_size
        w1 = torch.as_tensor(w1).reshape(shape)
        want = (want.index_select(axis, torch.as_tensor(i0)) * (1 - w1)
                + want.index_select(axis, torch.as_tensor(i1)) * w1)
    got = tinterp.resize_linear(x, sizes, axes)
    assert torch.equal(got, want)
    y = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(
        tinterp.resize_linear(y, (17, 19, 23), axes).sum(), y)
    assert torch.isfinite(grad).all()


def test_disp_sample_tensor_is_exact_and_kept():
    with torch.inference_mode():
        vals = tcv.disp_sample_tensor(12, -3, 2, torch.device("cpu"))
    assert not vals.is_inference() and vals.dtype == torch.float32
    np.testing.assert_array_equal(
        vals.numpy().view(np.int32),
        tcv.disp_sample_values(12, -3, 2).view(np.int32))
    assert tcv.disp_sample_tensor(12, -3, 2, torch.device("cpu")) is vals


@pytest.mark.parametrize("window", [1, 2, 3, 5])
def test_avg_pool2d_matches_jax(window):
    x = np.random.RandomState(window).randn(2, 11, 16, 3).astype(np.float32)
    want = np.asarray(jpool.avg_pool2d(jnp.asarray(x), window))
    got = tpool.avg_pool2d(torch.from_numpy(x), window).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["fused", "no_normalize", "disp_sample"])
def test_soft_argmin_matches_jax(case):
    rng = np.random.RandomState(3)
    cost = rng.randn(2, 6, 5, 7).astype(np.float32) * 3
    kwargs = dict(max_disp=12, start_disp=-2, dilation=2, alpha=1.5)
    sample = None
    if case == "no_normalize":
        cost = np.exp(cost) / np.exp(cost).sum(1, keepdims=True)
        kwargs["normalize"] = False
    if case == "disp_sample":
        sample = rng.rand(*cost.shape).astype(np.float32) * 10
    want = np.asarray(jsoft_argmin(
        jnp.asarray(cost), None if sample is None else jnp.asarray(sample),
        **kwargs))
    got = tsoft_argmin(
        torch.from_numpy(cost),
        None if sample is None else torch.from_numpy(sample), **kwargs)
    assert got.shape == (2, 5, 7, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# (in_features, ConvUnit kwargs shared by both sides, input spatial shape)
CONV_UNITS = {
    "2d_s2_bn_relu": (3, dict(features=8, kernel_size=3, stride=2,
                              padding=1, dims=2, bias=False), (9, 10)),
    "2d_dilated_bn": (4, dict(features=4, kernel_size=3, padding=1,
                              dilation=2, dims=2, relu=False), (8, 8)),
    "2d_1x1_no_bn": (4, dict(features=6, kernel_size=1, padding=0, dims=2,
                             batch_norm=False), (5, 7)),
    "2d_pre_norm": (4, dict(features=4, dims=2, pre_norm=True), (6, 6)),
    "3d_fused_relu": (8, dict(features=4, dims=3, bias=False), (4, 6, 5)),
    "3d_fused_no_relu": (4, dict(features=8, dims=3, relu=False),
                         (3, 5, 7)),
    "3d_s2": (4, dict(features=8, dims=3, stride=2, bias=False),
              (4, 6, 6)),
    "3d_transpose": (8, dict(features=4, dims=3, stride=2, transpose=True,
                             output_padding=1, relu=False, bias=False),
                     (2, 3, 4)),
}


@pytest.mark.parametrize("name", sorted(CONV_UNITS))
def test_conv_unit_matches_jax(name):
    cin, kw, spatial = CONV_UNITS[name]
    x = np.random.RandomState(1).randn(2, *spatial, cin).astype(np.float32)
    tkw = dict(kw)
    tkw["in_features"] = cin
    tmodule = tlayers.ConvUnit(**tkw)
    assert tmodule.fusable == name.startswith("3d_fused")
    want, got = jax_and_port(jlayers.ConvUnit(**kw), tmodule, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stride,dilation,cin,cout", [(1, 1, 4, 4),
                                                      (2, 1, 4, 8),
                                                      (1, 2, 8, 8)])
def test_basic_block_matches_jax(stride, dilation, cin, cout):
    x = np.random.RandomState(2).randn(1, 9, 8, cin).astype(np.float32)
    down = stride != 1 or cin != cout
    jm = jlayers.BasicBlock(cout, stride, dilation, dilation,
                            downsample=down)
    tm = tlayers.BasicBlock(cin, cout, stride, dilation, dilation,
                            downsample=down)
    want, got = jax_and_port(jm, tm, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("skips", [False, True])
def test_hourglass_matches_jax(skips):
    rng = np.random.RandomState(4)
    x = rng.randn(1, 4, 8, 12, 4).astype(np.float32)
    pre = post = None
    if skips:
        pre = rng.randn(1, 2, 4, 6, 8).astype(np.float32)
        post = rng.randn(1, 2, 4, 6, 8).astype(np.float32)
    want, got = jax_and_port(jlayers.Hourglass3D(4), tlayers.Hourglass3D(4),
                             x, pre, post)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_psmnet_backbone_matches_jax():
    # 16 x 24 features: the SPP windows clamp to 16 and floor-crop W
    hw = (64, 96)
    rng = np.random.RandomState(5)
    left = rng.randn(1, *hw, 3).astype(np.float32)
    right = rng.randn(1, *hw, 3).astype(np.float32)
    # the JAX side runs its shipped row-packed schedule (same parameters)
    want, got = jax_and_port(JBackbone(pack=4), TBackbone(), left, right)
    for w, g in zip(want, got):
        assert g.shape == (1, hw[0] // 4, hw[1] // 4, 32)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("name", ["PSMNet/scene_flow", "PSMNet/kitti_2015",
                                  "PSMNet/kitti_2012", "GCNet/scene_flow",
                                  "GCNet/kitti_2015", "GCNet/kitti_2012",
                                  "DeepPruner/scene_flow_4x",
                                  "DeepPruner/scene_flow_8x",
                                  "AnyNet/scene_flow"])
def test_configs_match_jax(name):
    over = {"model.max_disp": 96, "data.test.input_shape": (64, 64)}
    for suffix in ("", "_f32"):
        want = jconfigs.get_config(name + "_f32", **over)
        assert tconfigs.get_config(name + suffix, **over) == want


def test_config_bf16_and_unknown_raise():
    # the _bf16 names build since bf16 compute was ported (as JAX's), the
    # flow names since the flow models were (ROADMAP.md queue 1 item 11);
    # a family neither package has, or an unknown dtype suffix, raises
    assert tconfigs.get_config("PSMNet/scene_flow_bf16") == \
        jconfigs.get_config("PSMNet/scene_flow_bf16")
    assert tconfigs.get_config("PWCFlow/flying_chairs_bf16") == \
        jconfigs.get_config("PWCFlow/flying_chairs_bf16")
    for get_config in (tconfigs.get_config, jconfigs.get_config):
        with pytest.raises(KeyError):
            get_config("FlowNet/flying_chairs")
    with pytest.raises(KeyError):
        tconfigs.get_config("PSMNet/scene_flow_f16")


def test_transforms_and_remove_padding_match_jax():
    rng = np.random.RandomState(6)
    sample = {"leftImage": rng.rand(13, 17, 3).astype(np.float32) * 255,
              "rightImage": rng.rand(13, 17, 3).astype(np.float32) * 255,
              "leftDisp": rng.rand(13, 17, 1).astype(np.float32)}
    for fn, args in ((ttransforms.center_crop, ((8, 10),)),
                     (ttransforms.pad_to, ((16, 24),)),
                     (ttransforms.normalize, ((1.0, 2.0, 3.0),
                                              (4.0, 5.0, 6.0)))):
        got = fn(sample, *args)
        want = getattr(jtransforms, fn.__name__)(sample, *args)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    padded = rng.rand(1, 16, 24, 1).astype(np.float32)
    np.testing.assert_array_equal(tremove_padding(padded, 13, 17),
                                  np.asarray(jremove_padding(padded, 13, 17)))


def test_load_jax_variables_rejects_mismatches():
    jm = jlayers.ConvUnit(4, dims=3, bias=False)
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 3, 4, 4))))
    load_jax_variables(tlayers.ConvUnit(4, 4, dims=3, bias=False), variables)
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(tlayers.ConvUnit(8, 4, dims=3, bias=False),
                           variables)
    with pytest.raises(KeyError):
        load_jax_variables(tlayers.ConvUnit(4, 4, dims=3), variables)
    extra = {"params": dict(variables["params"], Dense_0={"kernel":
                                                          np.zeros(2)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="no module"):
        load_jax_variables(tlayers.ConvUnit(4, 4, dims=3, bias=False), extra)
