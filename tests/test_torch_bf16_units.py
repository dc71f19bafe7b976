"""bfloat16 ``ConvUnit``s of the port against the JAX package's, on the
CPU: the fusable 3x3x3 trunk unit (JAX at pack 1 and at pack 4), a strided
and a transposed 3-D unit and two 2-D backbone units, in eval and in
training, on the same weights with random BatchNorm.

The policy on both sides: float32 parameters and BN statistics, bfloat16
activations and convolutions (products summed in float32, one rounding),
BatchNorm computed in float32 from the bfloat16 input and rounded once.
Inputs are numpy arrays rounded to bfloat16 before they reach either side.
A unit's outputs are bfloat16 and are held to 2 bfloat16 steps (2 * 2^-7)
of their largest magnitude: the two sides round at other points (JAX's
unpacked unit rounds its conv to bfloat16 and then the BN result, its
packed eval fold rounds the conv and then the float32 epilogue; the port's
fused eval unit rounds once, after the epilogue), one step each, and the
library convolutions sum in another order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.models import layers as jlayers
from densematchingbenchmark_tpu.ops import conv3d as jconv3d

from densematchingbenchmark_tpu_torch.models import layers as tlayers
from densematchingbenchmark_tpu_torch.utils import load_jax_variables

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

BF16_STEP = 2.0 ** -7


def bf16_numpy(a):
    """float32 numpy array rounded to bfloat16 (round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16() \
        .float().numpy()


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


# kind -> (ConvUnit kwargs of both sides, input shape without its channels,
# input and output channels); every unit with BN
UNITS = {
    "fusable": (dict(kernel_size=3, stride=1, padding=1, dims=3, bias=False),
                (2, 8, 6, 10), 32, 32),
    "strided": (dict(kernel_size=3, stride=2, padding=1, dims=3, bias=False),
                (2, 8, 6, 10), 32, 64),
    "transposed": (dict(kernel_size=3, stride=2, padding=1, dims=3,
                        bias=False, transpose=True, output_padding=1),
                   (2, 4, 3, 5), 64, 32),
    "2d": (dict(kernel_size=3, stride=2, padding=1, dims=2, bias=False),
           (2, 12, 20), 3, 32),
    "2d_downsample": (dict(kernel_size=1, stride=2, padding=0, dims=2,
                           bias=True), (2, 12, 20), 32, 64),
}
UNIT_CASES = (
    [("fusable", pack, relu, train) for pack in (1, 4)
     for relu in (True, False) for train in (False, True)]
    + [(kind, 1, kind in ("strided", "2d"), train)
       for kind in ("strided", "transposed", "2d", "2d_downsample")
       for train in (False, True)])


def unit_pair(kind, pack, relu, seed):
    """The JAX bfloat16 unit, its random-BN variables, the port's unit
    with them loaded and the bfloat16-rounded input."""
    kw, shape, ci, co = UNITS[kind]
    rng = np.random.RandomState(seed)
    x = bf16_numpy(rng.randn(*shape, ci))
    jx = jnp.asarray(x)
    if pack > 1:
        jx = jconv3d.pack_volume(jx, pack)
    junit = jlayers.ConvUnit(co, relu=relu, dtype=jnp.bfloat16, pack=pack,
                             **kw)
    variables = junit.init(jax.random.PRNGKey(seed), jx, train=False)
    variables = randomize_bn(jax.tree.map(np.asarray, variables), rng)
    if kw["bias"]:
        variables["params"]["Conv_0"]["bias"] = (
            rng.randn(co) * 0.3).astype(np.float32)
    tunit = tlayers.ConvUnit(ci, co, relu=relu, dtype=torch.bfloat16, **kw)
    load_jax_variables(tunit, variables)
    return junit, variables, jx, tunit, x


@pytest.mark.parametrize("kind,pack,relu,train", UNIT_CASES)
def test_conv_unit_bf16_matches_jax(kind, pack, relu, train):
    """The port's bfloat16 unit (its kernel's plain version for the fusable
    one) against JAX's bfloat16 ConvUnit on the same weights and random
    BN: outputs within 2 bfloat16 steps of their largest magnitude; in
    training also the float32 running statistics, within 1e-4 of their
    largest magnitude (the batch mean and variance of bfloat16 conv
    outputs that differ by a rounding step here and there). Measured
    (tests/bf16_gap_study.py): the fusable unit 0.40 steps in eval at
    JAX's pack 1 and 4 (the rounding points differ), 0.10-0.20 in
    training; the strided and 2-D units equal in eval, within 0.03 steps
    in training; the transposed one 0.005 / 0.13 steps; the statistics
    4.4e-6."""
    junit, variables, jx, tunit, x = unit_pair(kind, pack, relu, seed=3)
    jvars = jax.tree.map(jnp.asarray, variables)
    if train:
        want, updates = junit.apply(jvars, jx, train=True,
                                    mutable=["batch_stats"])
        tunit.train()
    else:
        want = junit.apply(jvars, jx, train=False)
        tunit.eval()
    assert want.dtype == jnp.bfloat16
    if pack > 1:
        want = jconv3d.unpack_volume(want, pack)
    want = np.asarray(want.astype(jnp.float32))
    got = tunit(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tunit.parameters())
    assert all(b.dtype == torch.float32 for b in tunit.buffers()
               if b.is_floating_point())
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * BF16_STEP * np.abs(want).max())
    if train:
        bn = tunit.BatchNorm_0
        stats = updates["batch_stats"]["BatchNorm_0"]
        for name, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
            w = np.asarray(stats[name])
            np.testing.assert_allclose(buf.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)


def test_fusable_unit_routes_by_dtype(monkeypatch):
    """The fusable unit's kernels by dtype: float32 eval calls K1, bfloat16
    eval calls K4 at pack 1 with the folded [Co] epilogue and the unit's
    ReLU (weights and input in bfloat16), training calls K4 with unit
    scale in both dtypes."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
        monkeypatch.setattr(tlayers, name, wrapped)

    spy("fused_conv3d", tlayers.fused_conv3d)
    spy("conv3d_packed_s1", tlayers.conv3d_packed_s1)
    x = torch.randn(1, 4, 5, 6, 32)
    for dtype in (torch.float32, torch.bfloat16):
        unit = tlayers.ConvUnit(32, 32, 3, 1, 1, dims=3, bias=False,
                                relu=False, dtype=dtype)
        for train in (False, True):
            calls.clear()
            unit.train(train)
            assert unit(x).dtype == dtype
            (name, args, kwargs), = calls
            assert args[0].dtype == args[1].dtype == dtype
            if not train and dtype == torch.float32:
                assert name == "fused_conv3d"
            else:
                assert name == "conv3d_packed_s1" and kwargs["pack"] == 1
            if train:
                assert len(args) == 2 and "relu" not in kwargs
            else:
                scale, bias = args[2:4]
                assert scale.shape == bias.shape == (32,)
                assert scale.dtype == bias.dtype == torch.float32
                assert kwargs["relu"] is False
