"""Shared layers: conv/BN/ReLU unit (2-D and 3-D), residual block, PSMNet
3-D hourglass, DeepPruner's H/W hourglass.

Counterpart of densematchingbenchmark_tpu/models/layers.py (:35-40,
:377-489, :492-553, :556-586, :589-620, :624-676; the pre-norm factories
:506-529). Modules take and return the JAX layouts ([B, H, W, C] maps,
[B, D, H, W, C] volumes, contiguous), which is channels_last storage for
PyTorch's logical NCHW / NCDHW: each convolution sees its input through
``movedim(-1, 1)`` without a copy.

Submodule names follow the Flax tree (``Conv_0``, ``BatchNorm_0``,
``ConvTransposeExact_0``, ``ConvUnit_<i>``, ``Hourglass3D_<i>``) so that
utils/jax_weights.py maps the two by path. BatchNorm is the port's own
``BatchNorm`` with Flax's semantics: momentum 0.9 (torch momentum 0.1), eps
1e-5, and in training the biased batch variance both to normalise and to
update ``running_var`` (torch's own BatchNorm updates it with the unbiased
one).

Every module takes the compute ``dtype`` (JAX's ``dtype`` field): float32,
or bfloat16 with float32 parameters, as JAX's ``ConvUnit`` (:377-489). A
unit casts its input and its weights to the compute dtype at use, adds the
conv bias in that dtype, and runs BatchNorm in float32 (the running
statistics stay float32) with one rounding back.

The TPU schedules of the JAX layers (trunk ``pack``, PackedBatchNorm,
DispatchConv2D row packing, remat) have no counterpart: their parameter
trees equal the unpacked ones. JAX's sharding constraints on a D-split
cost volume (the hourglass's ``pin``, :634-672) become ``DAxis``: an
aggregator's stride-1 units run on a rank's planes of D with a halo, and
its strided stages, the hourglasses, on the whole D after a gather, as
JAX's pins place them; ``Hourglass3D`` itself needs no collective.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.conv3d_kernel import fused_conv3d
from ..ops.cuda.packed_conv3d_kernel import (WgmmaOperands,
                                             conv3d_packed_s1,
                                             conv3d_packed_s1_prepared,
                                             route_widths, wgmma_operands)
from ..parallel import collectives
from ..parallel.collectives import gather_d, halo_exchange, shard_d


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


def library_conv(conv, x, dtype):
    """``conv`` (an ``nn.Conv2d`` / ``Conv3d`` or ``nn.ConvTranspose2d`` /
    ``3d``: Flax's ``nn.Conv`` with ``dtype``) on the library (cuDNN, or the
    CPU's) on a channels-last map: the input and the weights cast to the
    compute ``dtype``, then the conv bias added in that dtype; the result
    contiguous channels-last."""
    weight = conv.weight.to(dtype)
    x = channels_first(x.to(dtype))
    if isinstance(conv, nn.modules.conv._ConvTransposeNd):
        fn = (F.conv_transpose2d, F.conv_transpose3d)[x.dim() - 4]
        y = fn(x, weight, None, conv.stride, conv.padding,
               conv.output_padding, conv.groups, conv.dilation)
    else:
        fn = (F.conv2d, F.conv3d)[x.dim() - 4]
        y = fn(x, weight, None, conv.stride, conv.padding, conv.dilation,
               conv.groups)
    y = channels_last(y)
    return y if conv.bias is None else y + conv.bias.to(dtype)


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over dim 1 of a logical [B, C, *spatial] tensor with the
    semantics of Flax ``nn.BatchNorm`` and ``PackedBatchNorm`` (JAX
    layers.py:89-101): in training it normalises with the biased batch
    variance and moves ``running_var`` toward that same biased variance
    (momentum 0.1 here is Flax's 0.9); in eval it uses the running
    statistics. A bfloat16 input is normalised in float32 (``nn.BatchNorm``
    with ``dtype=float32``, JAX layers.py:414-423) and the result rounded
    once to bfloat16. In training inside a group of more than one process
    the statistics are the global batch's (``_global_batch_norm``); never
    ``torch.nn.SyncBatchNorm``, which moves ``running_var`` toward the
    unbiased variance."""

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"BatchNorm: expected [B, C, ...], got "
                             f"{tuple(x.shape)}")

    def forward(self, x):
        self._check_input_dim(x)
        dtype, x = x.dtype, x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(dtype)
        if collectives.world_size() > 1:
            return self._global_batch_norm(x).to(dtype)
        # one pass: no running buffers given, so it normalises with the
        # batch statistics and returns the mean and 1 / sqrt(var + eps)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(invstd.pow(-2) - self.eps, self.momentum)
            self.num_batches_tracked += 1
        return y.to(dtype)

    def _global_batch_norm(self, x):
        """Training inside a group of processes: the statistics of the
        global batch, as JAX takes them over a sharded batch. Every rank
        all-reduces its per-channel sum and count, then its sum of squares
        about the global mean, each in a differentiable ``global_sum``
        (its shard may be smaller: the collectives run all the same); the
        variance is the biased one, as Flax's. Flax computes it as
        mean(x^2) - mean(x)^2; the centred sum is the one-process path's
        (``native_batch_norm``) arithmetic, whose float32 results it keeps
        (the one-pass form differs from them by cancellation that the
        tiny test models amplify to 3.7e-3 of their largest gradient:
        tests/parallel_noise_study.py).
        Normalises and moves the running statistics."""
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = (1, c) + (1,) * (x.dim() - 2)
        stats = collectives.global_sum(torch.cat([
            x.sum(dims), x.new_full((1,), x.numel() // c)]))
        count = stats[c:].detach()
        mean = stats[:c] / count
        centred = x - mean.view(shape)
        var = collectives.global_sum(centred.square().sum(dims)) / count
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = centred * inv.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
            self.num_batches_tracked += 1
        return y


class ConvUnit(nn.Module):
    """conv[Transpose] -> optional BN -> optional ReLU, order switchable.

    ``pre_norm=True`` gives the bn_relu_conv ordering. A 3x3x3 stride-1
    non-transposed unit with Co > 1 and BN, or pre-norm with or without BN
    (``fusable``: the geometry of JAX's Pallas eligibility,
    densematchingbenchmark_tpu/ops/conv3d.py:87-100), runs its conv
    through a kernel: in eval one fused kernel, the
    running-stat BN folded into a per-channel (inv, bias - mean * inv)
    epilogue (the JAX layers.py:429-447 fold), ``fused_conv3d`` in float32
    and ``conv3d_packed_s1`` at pack 1 in bfloat16 (its tensor-core route);
    in training ``conv3d_packed_s1`` with pack 1 and unit scale (JAX
    layers.py:459-466, the trunk's ``DispatchConv3D``), then the conv bias,
    batch-statistics BN and ReLU (:486-488). In bfloat16 the fused eval
    unit rounds once, after the epilogue, where JAX's unpacked unit rounds
    the conv and then the BN: the two differ by at most one bfloat16 step.

    A pre-norm unit (AnyNet's ``bn_relu_conv3d``) runs its BN (float32,
    on an upcast copy) and ReLU before the kernel, and its kernel's
    epilogue is unit scale with the conv bias as the shift and no ReLU,
    in eval and in training alike: its BN is never folded and its eval
    operands are keyed on the conv's weight and bias only. The padding to
    ``widths`` comes after the BN and ReLU, which run at ``in_features``.

    Every width runs on the kernels, as JAX's take any: the unit runs its
    conv at ``route_widths`` (``widths``), its input and weights padded
    with zero channels to the block's multiples and the padding sliced off
    the output; a bfloat16 Ci wider than the block takes (GCNet's 128)
    runs in slices, one launch each with unit scale, their sums added in
    float32, then the epilogue and one rounding (each slice's sum rounded
    to bfloat16 first: within a bfloat16 step of one rounding).

    When nothing needs a gradient, the fused eval unit keeps what its
    kernel takes (``eval_operands``: the kernel in the compute dtype and
    the folded scale and bias, in bfloat16 on the card as K4's prepared
    operands, one launch a slice of Ci), keyed on each source tensor's
    ``data_ptr()`` and ``_version`` and on the dtype and device: an
    optimizer step, ``load_state_dict``, an in-place update or ``.to()``
    rebuilds them, and nothing else does. Training keeps none.
    """

    # eval operands built, over all units (read by tests and chip_smoke.py)
    operand_builds = 0

    def __init__(self, in_features, features, kernel_size=3, stride=1,
                 padding=1, dilation=1, dims=2, batch_norm=True, relu=True,
                 pre_norm=False, bias=True, transpose=False,
                 output_padding=0, dtype=torch.float32):
        super().__init__()
        self.relu, self.pre_norm, self.dtype = relu, pre_norm, dtype
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
        self.fusable = (dims == 3 and (batch_norm or pre_norm)
                        and features > 1 and conv is not None
                        and conv.kernel_size == (3,) * 3
                        and conv.stride == (1,) * 3
                        and conv.padding == (1,) * 3
                        and conv.dilation == (1,) * 3)
        self.in_features, self.features = in_features, features
        self.widths = (route_widths(dtype, in_features, features)
                       if self.fusable else None)
        self.padded = self.fusable and self.widths[:2] != (in_features,
                                                           features)
        self._operands = None

    @property
    def conv(self):
        return getattr(self, "Conv_0", None) or self.ConvTransposeExact_0

    def _norm_act(self, x):
        if self.BatchNorm_0 is not None:
            x = channels_last(self.BatchNorm_0(channels_first(x)))
        return torch.relu(x) if self.relu else x

    def folded_bn(self):
        """Eval-mode BN (and conv bias) as a per-channel affine
        (scale, bias) with conv(x) -> conv(x) * scale + bias. A pre-norm
        unit's BN stays outside the kernel: unit scale, the conv bias (or
        zero) as the shift."""
        if self.pre_norm:
            weight, bias = self.Conv_0.weight, self.Conv_0.bias
            scale = torch.ones(self.features, device=weight.device)
            return scale, (torch.zeros_like(scale) if bias is None
                           else bias.float().clone())
        bn = self.BatchNorm_0
        inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        shift = bn.bias - bn.running_mean * inv
        if self.Conv_0.bias is not None:
            shift = self.Conv_0.bias * inv + shift
        return inv.float().contiguous(), shift.float().contiguous()

    def _sources(self):
        """The tensors the fused eval unit's operands are made from, read
        from the modules' dicts (``nn.Module.__getattr__`` costs about a
        microsecond a name, on every eval call)."""
        conv = self._modules["Conv_0"]
        bias = conv._parameters["bias"]
        if self.pre_norm:
            return (conv._parameters["weight"],) + (() if bias is None else
                                                    (bias,))
        bn = self._modules["BatchNorm_0"]
        return (conv._parameters["weight"], bn._parameters["weight"],
                bn._parameters["bias"], bn._buffers["running_mean"],
                bn._buffers["running_var"]) + (() if bias is None else
                                               (bias,))

    def _kernel(self):
        """The weights as the kernels take them: [3, 3, 3, Ci, Co] in the
        compute dtype, zero past the unit's widths up to ``widths``."""
        kernel = self.Conv_0.weight.permute(2, 3, 4, 1, 0).to(self.dtype)
        if self.padded:
            ci, co, _ = self.widths
            kernel = F.pad(kernel, (0, co - self.features,
                                    0, ci - self.in_features))
        return kernel.contiguous()

    def _parts(self, kernel):
        """The kernel of each slice of Ci (``widths``)."""
        slices = self.widths.slices
        if len(slices) == 1:
            return (kernel,)
        return tuple(kernel[..., lo:hi, :].contiguous() for lo, hi in slices)

    def _eval_tensors(self):
        """(the parts of the kernel, scale, bias) of the fused eval unit,
        the folded BN zero past Co up to ``widths``."""
        pad = self.widths.co - self.features
        return (self._parts(self._kernel()),
                *(F.pad(v, (0, pad)) if pad else v for v in self.folded_bn()))

    def eval_operands(self, device, sources=None):
        """What the fused eval unit's kernels take, kept while its sources
        are unchanged: (parts, scale, bias), the folded BN in float32 and
        the parts the kernel of each slice of Ci in the compute dtype, in
        bfloat16 on the card K4's ``WgmmaOperands`` (the weight image, with
        the folded BN for a single slice, else with unit scale). Built
        outside inference mode, so that a later call with grad mode on can
        use them too. None when a source is an inference tensor (it has no
        version counter to key on)."""
        sources = sources or self._sources()
        try:
            key = (self.dtype, device, *((t.data_ptr(), t._version)
                                         for t in sources))
        except RuntimeError:
            return None
        if self._operands is None or self._operands[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                parts, scale, bias = self._eval_tensors()
                if self.dtype == torch.bfloat16 and device.type == "cuda":
                    epilogue = (scale, bias) if len(parts) == 1 else ()
                    parts = tuple(wgmma_operands(k, *epilogue)
                                  for k in parts)
                # the sources' storage is held with the key, so that no
                # other tensor takes one of their addresses meanwhile
                self._operands = (key, tuple(t.detach() for t in sources),
                                  (parts, scale, bias))
            ConvUnit.operand_builds += 1
        return self._operands[2]

    def _conv(self, x, parts, scale=None, bias=None, relu=False):
        """The conv of ``x`` [..., Ci] (padded) through ``parts``: one
        launch with the epilogue, or (``scale`` None) unit scale, as
        training runs; with several parts one launch a slice of Ci with
        unit scale, summed in float32, then the epilogue and one
        rounding."""
        if len(parts) > 1:
            y = sum(self._conv(x[..., lo:hi].contiguous(), (part,)).float()
                    for (lo, hi), part in zip(self.widths.slices, parts))
            if scale is not None:
                y = y * scale + bias
            return (y.clamp_min(0.0) if relu else y).to(self.dtype)
        part = parts[0]
        if isinstance(part, WgmmaOperands):
            return conv3d_packed_s1_prepared(x, part, relu=relu)
        if scale is None:
            return conv3d_packed_s1(x, part, pack=1)
        if self.dtype == torch.float32:
            return fused_conv3d(x, part, scale, bias, relu=relu)
        return conv3d_packed_s1(x, part, scale, bias, pack=1, relu=relu)

    def _fused_eval(self, x):
        sources = self._sources()
        operands = None
        if not (torch.is_grad_enabled() and (x.requires_grad or any(
                t.requires_grad for t in sources))):
            operands = self.eval_operands(x.device, sources)
        # differentiable, or sources without a version counter: made per
        # call
        parts, scale, bias = operands or self._eval_tensors()
        return self._conv(x, parts, scale, bias,
                          self.relu and not self.pre_norm)

    def forward(self, x, extended=False):
        """``extended``: ``x`` [B, d + 2, ...] is a fusable unit's planes
        of a D split with one halo plane on each side (DAxis); its kernel
        runs on all d + 2 and the halo's output planes are dropped before
        the bias and a training BN, so that the output is the unit's on
        its d planes."""
        if extended and (self.pre_norm or not self.fusable):
            raise ValueError("only a fusable post-norm unit runs on a D "
                             "shard with its halo")
        x = x.to(self.dtype)
        if self.pre_norm:
            x = self._norm_act(x)
        if not self.fusable:
            x = library_conv(self.conv, x, self.dtype)
            return x if self.pre_norm else self._norm_act(x)
        x = x.contiguous()
        if self.padded:
            x = F.pad(x, (0, self.widths.ci - self.in_features))
        if not self.training:
            x = self._fused_eval(x)
            if extended:
                x = x[:, 1:-1]
            return x[..., :self.features].contiguous() if self.padded or \
                extended else x
        self._operands = None
        x = self._conv(x, self._parts(self._kernel()))
        if extended:
            x = x[:, 1:-1]
        if self.padded:
            x = x[..., :self.features]
        if self.Conv_0.bias is not None:
            x = x + self.Conv_0.bias.to(self.dtype)
        return x if self.pre_norm else self._norm_act(x)


class DAxis:
    """An aggregator's steps along D of its [B, D, ...] volumes under a
    ``volume_sharding`` (parallel/mesh.py): on this rank's planes of D
    when the sharding splits D over a model axis, each stride-1 window
    over D reading one halo plane from each neighbour; the plain calls
    otherwise. ``size``: the whole D."""

    def __init__(self, sharding, size=None):
        self.mesh = sharding.mesh if sharding is not None and \
            sharding.splits_d else None
        self.size = size

    def unit(self, unit, x):
        """A fusable stride-1 ``ConvUnit`` on this rank's planes."""
        if self.mesh is None:
            return unit(x)
        return unit(halo_exchange(x, self.mesh), extended=True)

    def shard_unit(self, unit, x):
        """The unit on this rank's planes of a whole-D ``x``, its halo
        taken from ``x``."""
        if self.mesh is None:
            return unit(x)
        return unit(shard_d(x, self.mesh, 1), extended=True)

    def conv(self, conv, x, dtype):
        """A 3x3x3 stride-1 library conv (``library_conv``: the Co = 1
        heads) on this rank's planes."""
        if self.mesh is None:
            return library_conv(conv, x, dtype)
        return library_conv(conv, halo_exchange(x, self.mesh),
                            dtype)[:, 1:-1]

    def whole(self, x):
        """The whole D on every model rank, from each rank's planes."""
        return gather_d(x, self.mesh, self.size)


def conv_bn(batch_norm, in_features, features, kernel_size=3, stride=1,
            padding=1, dilation=1, bias=True, dtype=torch.float32):
    return ConvUnit(in_features, features, kernel_size, stride, padding,
                    dilation, dims=2, batch_norm=batch_norm, relu=False,
                    bias=bias, dtype=dtype)


def conv_bn_relu(batch_norm, in_features, features, kernel_size=3, stride=1,
                 padding=1, dilation=1, bias=True, dtype=torch.float32):
    return ConvUnit(in_features, features, kernel_size, stride, padding,
                    dilation, dims=2, batch_norm=batch_norm, relu=True,
                    bias=bias, dtype=dtype)


def bn_relu_conv(batch_norm, in_features, features, kernel_size=3, stride=1,
                 padding=1, dilation=1, bias=True, dtype=torch.float32):
    return ConvUnit(in_features, features, kernel_size, stride, padding,
                    dilation, dims=2, batch_norm=batch_norm, relu=True,
                    pre_norm=True, bias=bias, dtype=dtype)


def bn_relu_conv3d(batch_norm, in_features, features, kernel_size=3,
                   stride=1, padding=1, dilation=1, bias=True,
                   dtype=torch.float32):
    return ConvUnit(in_features, features, kernel_size, stride, padding,
                    dilation, dims=3, batch_norm=batch_norm, relu=True,
                    pre_norm=True, bias=bias, dtype=dtype)


class BasicBlock(nn.Module):
    """ResNet basic block (basic_layers.py:217-243), expansion 1."""

    def __init__(self, in_features, features, stride=1, padding=1,
                 dilation=1, batch_norm=True, downsample=False,
                 dtype=torch.float32):
        super().__init__()
        self.ConvUnit_0 = conv_bn_relu(batch_norm, in_features, features, 3,
                                       stride, padding, dilation, bias=False,
                                       dtype=dtype)
        self.ConvUnit_1 = conv_bn(batch_norm, features, features, 3, 1,
                                  padding, dilation, bias=False, dtype=dtype)
        self.ConvUnit_2 = (conv_bn(batch_norm, in_features, features, 1,
                                   stride, 0, 1, dtype=dtype)
                           if downsample else None)

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

    dims = 3   # the volume's spatial axes (layers_extra.Hourglass2D: 2)

    def __init__(self, features, batch_norm=True, dtype=torch.float32):
        super().__init__()
        c2 = features * 2

        def unit(cin, cout, stride=1, relu=True, transpose=False):
            return ConvUnit(cin, cout, 3, stride, 1, dims=self.dims,
                            batch_norm=batch_norm, relu=relu, bias=False,
                            transpose=transpose,
                            output_padding=1 if transpose else 0,
                            dtype=dtype)

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


class HWHourglass(nn.Module):
    """DeepPruner's 3-D hourglass striding only H and W (JAX
    layers.py:589-620): three down stages, each a stride-(1, 2, 2) unit
    (library conv) plus a stride-1 unit on its output (fusable: the trunk
    kernels) added to it, and three transposed stride-(1, 2, 2) units
    (output padding (0, 1, 1), no ReLU) with additive skips.

    Input [B, D, H, W, C] with C = ``features``; output the same shape.
    """

    def __init__(self, features, batch_norm=True, dtype=torch.float32):
        super().__init__()
        c = features

        def unit(cin, cout, stride, relu=True, transpose=False):
            return ConvUnit(cin, cout, 3, stride, 1, dims=3,
                            batch_norm=batch_norm, relu=relu, bias=False,
                            transpose=transpose,
                            output_padding=(0, 1, 1) if transpose else 0,
                            dtype=dtype)

        downs = [(c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c)]
        for i, (cin, cout) in enumerate(downs):
            setattr(self, f"ConvUnit_{2 * i}", unit(cin, cout, (1, 2, 2)))
            setattr(self, f"ConvUnit_{2 * i + 1}", unit(cout, cout, 1))
        ups = [(8 * c, 4 * c), (4 * c, 2 * c), (2 * c, c)]
        for i, (cin, cout) in enumerate(ups, 6):
            setattr(self, f"ConvUnit_{i}", unit(cin, cout, (1, 2, 2),
                                                relu=False, transpose=True))

    def forward(self, x):
        outs = []
        for i in range(3):
            a = getattr(self, f"ConvUnit_{2 * i}")(x)
            x = a + getattr(self, f"ConvUnit_{2 * i + 1}")(a)
            outs.append(x)
        out1, out2, out3 = outs
        u3 = self.ConvUnit_6(out3) + out2
        u2 = self.ConvUnit_7(u3) + out1
        return self.ConvUnit_8(u2)


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
