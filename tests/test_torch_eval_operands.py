"""The fused eval unit's kept operands (models/layers.ConvUnit), on the CPU.

A 3x3x3 stride-1 conv + BN unit in eval keeps what its kernel takes (the
kernel in the compute dtype, the folded BN; on the card K4's prepared
bfloat16 image) while nothing needs a gradient, and rebuilds it only when
one of its sources changes: an optimizer step, ``load_state_dict``, an
in-place update, ``.to()``. Every result here is held bit for bit against a
unit built afresh with the same weights. No JAX.
"""

import pytest
import torch
from torch import nn

from densematchingbenchmark_tpu_torch.models.layers import ConvUnit

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]


def trunk(dtype, seed):
    """Two trunk units (16 -> 16 -> 16 channels, the second without ReLU
    and with a conv bias), BN with random parameters and statistics."""
    gen = torch.Generator().manual_seed(seed)
    net = nn.Sequential(
        ConvUnit(16, 16, 3, 1, 1, dims=3, bias=False, dtype=dtype),
        ConvUnit(16, 16, 3, 1, 1, dims=3, relu=False, dtype=dtype))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        for m in net.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.weight.add_(1.0)
                m.running_mean.copy_(torch.randn(16, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(16, generator=gen) + 0.5)
    assert all(u.fusable for u in net)
    return net.eval()


def inputs(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((1, 4, 6, 7, 16), generator=gen)


def run(net, x):
    with torch.inference_mode():
        return net(x)


def fresh(net, dtype):
    """A unit built afresh with ``net``'s parameters and statistics."""
    other = trunk(dtype, 99)
    other.load_state_dict(net.state_dict())
    return other.eval()


@pytest.mark.parametrize("dtype", DTYPES)
def test_second_eval_forward_builds_nothing(dtype):
    net, x = trunk(dtype, 0), inputs()
    before = ConvUnit.operand_builds
    first = run(net, x)
    assert ConvUnit.operand_builds == before + 2
    second = run(net, x)
    assert ConvUnit.operand_builds == before + 2
    assert torch.equal(first, second) and first.dtype == dtype
    # the operands were made outside inference mode: a call under no_grad
    # (grad mode on, nothing requiring grad) uses them too
    with torch.no_grad():
        assert torch.equal(net(x), first)
    assert ConvUnit.operand_builds == before + 2
    # with grad mode on and parameters that require grad, the unit is made
    # per call (differentiable) and gives the same result
    got = net(x)
    assert got.requires_grad and torch.equal(got.detach(), first)
    assert ConvUnit.operand_builds == before + 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_load_state_dict_is_picked_up(dtype):
    net, x = trunk(dtype, 0), inputs()
    run(net, x)
    net.load_state_dict(trunk(dtype, 1).state_dict())
    before = ConvUnit.operand_builds
    got = run(net, x)
    assert ConvUnit.operand_builds == before + 2
    assert torch.equal(got, run(fresh(net, dtype), x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("source", ["conv weight", "bn running_var",
                                    "bn running_mean", "conv bias"])
def test_in_place_update_is_picked_up(dtype, source):
    net, x = trunk(dtype, 0), inputs()
    old = run(net, x)
    unit = net[1]
    tensor = {"conv weight": unit.Conv_0.weight,
              "bn running_var": unit.BatchNorm_0.running_var,
              "bn running_mean": unit.BatchNorm_0.running_mean,
              "conv bias": unit.Conv_0.bias}[source]
    with torch.no_grad():
        tensor.mul_(1.5)
    before = ConvUnit.operand_builds
    got = run(net, x)
    assert ConvUnit.operand_builds == before + 1    # the changed unit only
    assert not torch.equal(got, old)
    assert torch.equal(got, run(fresh(net, dtype), x))


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_step_then_eval_is_picked_up(dtype):
    net, x = trunk(dtype, 0), inputs()
    run(net, x)
    assert all(u._operands is not None for u in net)
    net.train()
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    loss = net(inputs(1)).float().square().mean()
    # training keeps no operands
    assert all(u._operands is None for u in net)
    loss.backward()
    opt.step()
    net.eval()
    got = run(net, x)
    assert torch.equal(got, run(fresh(net, dtype), x))


@pytest.mark.parametrize("dtype", DTYPES)
def test_to_another_dtype_of_weights_is_picked_up(dtype):
    # .to() replaces the parameters: the operands follow them
    net, x = trunk(dtype, 0), inputs()
    run(net, x)
    net.double().float()
    before = ConvUnit.operand_builds
    got = run(net, x)
    assert ConvUnit.operand_builds == before + 2
    assert torch.equal(got, run(fresh(net, dtype), x))


@pytest.mark.parametrize("dtype", DTYPES)
def test_inference_tensor_sources_are_made_per_call(dtype):
    # a unit built under inference mode has sources without a version
    # counter: it keeps nothing and gives the same result
    x = inputs()
    want = run(trunk(dtype, 0), x)
    with torch.inference_mode():
        net = trunk(dtype, 0)
    got = run(net, x)
    assert all(u._operands is None for u in net)
    assert torch.equal(got, want)
