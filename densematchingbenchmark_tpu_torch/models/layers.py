"""Shared layers: conv/BN/ReLU unit (2-D and 3-D), residual block, PSMNet
3-D hourglass.

Counterpart of densematchingbenchmark_tpu/models/layers.py (:35-40,
:377-489, :492-553, :556-586, :624-676). Modules take and return the JAX
layouts ([B, H, W, C] maps, [B, D, H, W, C] volumes, contiguous), which is
channels_last storage for PyTorch's logical NCHW / NCDHW: each convolution
sees its input through ``movedim(-1, 1)`` without a copy.

Submodule names follow the Flax tree (``Conv_0``, ``BatchNorm_0``,
``ConvTransposeExact_0``, ``ConvUnit_<i>``, ``Hourglass3D_<i>``) so that
utils/jax_weights.py maps the two by path. BatchNorm is the port's own
``BatchNorm`` with Flax's semantics: momentum 0.9 (torch momentum 0.1), eps
1e-5, and in training the biased batch variance both to normalise and to
update ``running_var`` (torch's own BatchNorm updates it with the unbiased
one).

The TPU schedules of the JAX layers (trunk ``pack``, PackedBatchNorm,
DispatchConv2D row packing, remat, sharding constraints) have no
counterpart: their parameter trees equal the unpacked ones.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.conv3d_kernel import fused_conv3d
from ..ops.cuda.packed_conv3d_kernel import conv3d_packed_s1


def _tuple(x, n):
    if isinstance(x, (tuple, list)):
        assert len(x) == n
        return tuple(x)
    return (x,) * n


def consistent_padding_with_dilation(padding, dilation, dims):
    """padding[d] = dilation[d] when dilation > 1 (basic_layers.py:14-28)."""
    padding = _tuple(padding, dims)
    dilation = _tuple(dilation, dims)
    padding = tuple(d if d > 1 else p for p, d in zip(padding, dilation))
    return padding, dilation


def channels_first(x):
    """[B, *spatial, C] -> logical [B, C, *spatial] view (no copy)."""
    return x.movedim(-1, 1)


def channels_last(x):
    """Logical [B, C, *spatial] -> contiguous [B, *spatial, C]."""
    return x.movedim(1, -1).contiguous()


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over dim 1 of a logical [B, C, *spatial] tensor with the
    semantics of Flax ``nn.BatchNorm`` and ``PackedBatchNorm`` (JAX
    layers.py:89-101): in training it normalises with the biased batch
    variance and moves ``running_var`` toward that same biased variance
    (momentum 0.1 here is Flax's 0.9); in eval it uses the running
    statistics."""

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"BatchNorm: expected [B, C, ...], got "
                             f"{tuple(x.shape)}")

    def forward(self, x):
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # one pass: no running buffers given, so it normalises with the
        # batch statistics and returns the mean and 1 / sqrt(var + eps)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(invstd.pow(-2) - self.eps, self.momentum)
            self.num_batches_tracked += 1
        return y


class ConvUnit(nn.Module):
    """conv[Transpose] -> optional BN -> optional ReLU, order switchable.

    ``pre_norm=True`` gives the bn_relu_conv ordering. A 3x3x3 stride-1
    non-transposed unit with BN (``fusable``) runs its conv through a
    kernel: in eval one fused kernel, the running-stat BN folded into a
    per-channel (inv, bias - mean * inv) epilogue of ``fused_conv3d`` (the
    JAX layers.py:434-447 fold); in training ``conv3d_packed_s1`` with
    pack 1 (JAX layers.py:459-466, the trunk's ``DispatchConv3D``), then
    the conv bias, batch-statistics BN and ReLU (:486-488).
    """

    def __init__(self, in_features, features, kernel_size=3, stride=1,
                 padding=1, dilation=1, dims=2, batch_norm=True, relu=True,
                 pre_norm=False, bias=True, transpose=False,
                 output_padding=0):
        super().__init__()
        self.relu, self.pre_norm = relu, pre_norm
        ks = _tuple(kernel_size, dims)
        stride = _tuple(stride, dims)
        if transpose:
            cls = (nn.ConvTranspose2d, nn.ConvTranspose3d)[dims - 2]
            self.ConvTransposeExact_0 = cls(
                in_features, features, ks, stride, _tuple(padding, dims),
                output_padding=_tuple(output_padding, dims), bias=bias)
        else:
            padding, dilation = consistent_padding_with_dilation(
                padding, dilation, dims)
            cls = (nn.Conv2d, nn.Conv3d)[dims - 2]
            self.Conv_0 = cls(in_features, features, ks, stride, padding,
                              dilation, bias=bias)
        self.BatchNorm_0 = None
        if batch_norm:
            self.BatchNorm_0 = BatchNorm(in_features if pre_norm
                                         else features, eps=1e-5,
                                         momentum=0.1)
        conv = None if transpose else self.Conv_0
        self.fusable = (dims == 3 and batch_norm and not pre_norm
                        and conv is not None and conv.kernel_size == (3,) * 3
                        and conv.stride == (1,) * 3
                        and conv.padding == (1,) * 3
                        and conv.dilation == (1,) * 3)

    @property
    def conv(self):
        return getattr(self, "Conv_0", None) or self.ConvTransposeExact_0

    def _norm_act(self, x):
        if self.BatchNorm_0 is not None:
            x = channels_last(self.BatchNorm_0(channels_first(x)))
        return torch.relu(x) if self.relu else x

    def folded_bn(self):
        """Eval-mode BN (and conv bias) as a per-channel affine
        (scale, bias) with conv(x) -> conv(x) * scale + bias."""
        bn = self.BatchNorm_0
        inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        shift = bn.bias - bn.running_mean * inv
        if self.Conv_0.bias is not None:
            shift = self.Conv_0.bias * inv + shift
        return inv.float().contiguous(), shift.float().contiguous()

    def forward(self, x):
        if self.pre_norm:
            x = self._norm_act(x)
        if self.fusable:
            kernel = self.Conv_0.weight.permute(2, 3, 4, 1, 0).contiguous()
            if not self.training:
                scale, bias = self.folded_bn()
                return fused_conv3d(x.contiguous(), kernel, scale, bias,
                                    relu=self.relu)
            x = conv3d_packed_s1(x.contiguous(), kernel, pack=1)
            if self.Conv_0.bias is not None:
                x = x + self.Conv_0.bias
            return self._norm_act(x)
        x = channels_last(self.conv(channels_first(x)))
        return x if self.pre_norm else self._norm_act(x)


def conv_bn(batch_norm, in_features, features, kernel_size=3, stride=1,
            padding=1, dilation=1, bias=True):
    return ConvUnit(in_features, features, kernel_size, stride, padding,
                    dilation, dims=2, batch_norm=batch_norm, relu=False,
                    bias=bias)


def conv_bn_relu(batch_norm, in_features, features, kernel_size=3, stride=1,
                 padding=1, dilation=1, bias=True):
    return ConvUnit(in_features, features, kernel_size, stride, padding,
                    dilation, dims=2, batch_norm=batch_norm, relu=True,
                    bias=bias)


class BasicBlock(nn.Module):
    """ResNet basic block (basic_layers.py:217-243), expansion 1."""

    def __init__(self, in_features, features, stride=1, padding=1,
                 dilation=1, batch_norm=True, downsample=False):
        super().__init__()
        self.ConvUnit_0 = conv_bn_relu(batch_norm, in_features, features, 3,
                                       stride, padding, dilation, bias=False)
        self.ConvUnit_1 = conv_bn(batch_norm, features, features, 3, 1,
                                  padding, dilation, bias=False)
        self.ConvUnit_2 = (conv_bn(batch_norm, in_features, features, 1,
                                   stride, 0, 1) if downsample else None)

    def forward(self, x):
        out = self.ConvUnit_1(self.ConvUnit_0(x))
        if self.ConvUnit_2 is not None:
            x = self.ConvUnit_2(x)
        return out + x


class Hourglass3D(nn.Module):
    """PSMNet 3-D hourglass with pre/post skip wiring (hourglass.py:8-86).

    Input [B, D, H, W, C]; the stride-2 units halve D, H and W together.
    Returns (out, pre, post) so stacked hourglasses can cross-wire their
    skips.
    """

    def __init__(self, features, batch_norm=True):
        super().__init__()
        c2 = features * 2

        def unit(cin, cout, stride=1, relu=True, transpose=False):
            return ConvUnit(cin, cout, 3, stride, 1, dims=3,
                            batch_norm=batch_norm, relu=relu, bias=False,
                            transpose=transpose,
                            output_padding=1 if transpose else 0)

        self.ConvUnit_0 = unit(features, c2, stride=2)
        self.ConvUnit_1 = unit(c2, c2, relu=False)
        self.ConvUnit_2 = unit(c2, c2, stride=2)
        self.ConvUnit_3 = unit(c2, c2)
        self.ConvUnit_4 = unit(c2, c2, stride=2, relu=False, transpose=True)
        self.ConvUnit_5 = unit(c2, features, stride=2, relu=False,
                               transpose=True)

    def forward(self, x, presqu=None, postsqu=None):
        out = self.ConvUnit_0(x)                                   # 1/2
        pre = self.ConvUnit_1(out)
        pre = torch.relu(pre + postsqu if postsqu is not None else pre)
        out = self.ConvUnit_3(self.ConvUnit_2(pre))                # 1/4
        post = torch.relu(self.ConvUnit_4(out)
                          + (presqu if presqu is not None else pre))  # 1/2
        out = self.ConvUnit_5(post)                                # 1/1
        return out, pre, post


def init_parameters(module, generator):
    """Initialise every parameter of ``module`` from ``generator``, with the
    JAX package's initialisers: convs lecun_normal, transposed convs
    he_normal (both truncated at 2 std), biases 0, BN scale 1 / bias 0 and
    running mean 0 / var 1."""
    trunc_std = 0.87962566103423978   # std of a unit normal cut at +-2
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                          nn.ConvTranspose3d)):
            transposed = isinstance(m, (nn.ConvTranspose2d,
                                        nn.ConvTranspose3d))
            in_ch = m.in_channels // m.groups
            fan_in = in_ch * math.prod(m.kernel_size)
            gain = 2.0 if transposed else 1.0
            std = math.sqrt(gain / fan_in) / trunc_std
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
