"""3x3x3 stride-1 SAME conv3d + scale/bias (+ReLU) on the D-packed layout:
K4 (differentiable) and K5 (forward only), float32 or bfloat16 operands.

``conv3d_packed_s1`` (K4) replaces the TPU kernel densematchingbenchmark_tpu/
ops/pallas/packed_conv3d_kernel.py::conv3d_packed_s1_pallas (forward
``_forward`` / ``_kernel``, custom VJP ``_pallas_vjp``): the stride-1 conv of
the 13 trunk units of PSMNet's aggregator in training (pack 1, float32, 13
launches per train step) and the v1 row of the packed-conv microbench
(tools/microbench_packed.py, pack 4). Hopper kernels
(``csrc/packed_conv3d_kernel.cu``, CUDA C++, sm_90a), the packed layout as
addressing in both: float32 on the CUDA cores through the float32 block K1
runs too (``csrc/conv3d_tile.cuh``: a TMA ring, a register window along W,
all of Cout <= 64 in one block), bfloat16 on the tensor cores (``wgmma``
fed by a TMA ring, ``csrc/conv3d_wgmma_persistent.cuh``), each staged
input plane feeding the three output depths it touches. The float32 block
takes the wrapper's image of the kernel (``conv3d_f32_weights``, built per
call) and a launch plan per shape (``conv3d_f32_plan``: Cout tile, rows a
block, ring stages, grid) chosen with each candidate's blocks per SM as
the built kernel reports them. The bfloat16 block runs a persistent grid:
about one block per SM for each Cout tile, each loading its weights once
and walking a contiguous share of the output (depth fastest), each input
plane of a run of depths staged once (``wgmma_plan``).

``conv3d_packed_s1_v2`` (K5) replaces ``conv3d_packed_s1_pallas_v2`` (body
``_kernel_v2``, the rolling-DMA ring): the same function, forward only, as
in JAX; its only caller is the microbench. Hopper kernels
(``csrc/packed_conv3d_v2_kernel.cu``) walk depth inside the block so that
each input plane is staged once per H / W tile: float32 on the CUDA cores,
fed by a TMA ring whose weights are the wrapper's image of the kernel
(``packed_v2_weights``, built per call), bfloat16 on the ``wgmma`` block
K4's is reshaped from (``csrc/conv3d_wgmma.cuh``: a 4 x 64 tile on two
warpgroups, a chunk of depths a block), with three accumulators.

The route is picked by dtype alone. The bfloat16 block needs Ci % 16 == 0
and Co % 8 == 0 (``wgmma``'s k16 steps, 8-channel core matrices) and
Ci <= 112 (its weights and two ring stages in shared memory), the float32
one Ci % 4 == 0 and Co % 4 == 0; a CUDA tensor of another width raises.
Both rules are one function, ``route_width_fault``, which the checks raise
on. JAX's kernels take any widths: ``route_widths`` says how a conv of
any Ci -> Co meets the rule (zero channels up to the block's multiples,
and in bfloat16 a wider Ci in slices whose sums are added), and the trunk
unit (``models/layers.ConvUnit``) runs its conv so.

The bfloat16 route's kernel operand is the weights' shared-memory image
(``wgmma_weights``): built per call by ``conv3d_packed_s1``, or once by
``wgmma_operands`` for ``conv3d_packed_s1_prepared``, the entry of the
eval trunk, whose weights do not change between calls
(``models/layers.ConvUnit`` keeps the image).
``wgmma_plan`` computes its launch (channel slice, ring stages, depth
chunk, grid, shared memory) from the shapes and the kernel's registers a
thread, which the library reports as ptxas gave them; the wrapper keeps a
plan per (card, order, shape) and reads the SM count once per device.
The kernel refuses a plan whose shared memory is short of its layout.

Both take float32 or bfloat16 ``xp`` and return ``xp.dtype``, as JAX's
contract: the kernel is cast to ``xp.dtype`` first (weights rounded once, as
JAX's ``wmat.astype(xp.dtype)``), products are summed in float32, the
epilogue (float32 scale and bias) runs in float32 and the result is rounded
once to ``xp.dtype``. Neither takes ``h_tile``: that is a TPU schedule knob,
and the kernels mask ragged H and W.

K4's gradient is, as JAX's ``_bwd``, the VJP of the plain convolution and no
hand-written kernel: the TPU package computes it in XLA outside any Pallas
kernel (``_xla_reference``, in ``xp.dtype``), and here cuDNN's convolution
gradients run on the unpacked view in the same dtype, with the epilogue and
ReLU terms in float32.

``conv3d_packed_s1_plain`` is the function of both in plain PyTorch: unpack,
``conv3d_plain`` (K1's plain version, float32), pack, epilogue, one rounding
to ``xp.dtype``; on the CPU it is differentiable by plain autograd.
"""

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..conv3d import pack_volume, unpack_volume
from . import _build
from .conv3d_kernel import conv3d_plain

_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the launch plan's ints after the shapes and ReLU: K4 in bfloat16 (one
# array, csrc/conv3d_wgmma_persistent.cuh enum Dim) and K5 in bfloat16
_PLAN_ARGS = {"K4": ("ck", "stages", "tiles_h", "tiles_w", "blocks", "smem"),
              "K5": ("ck", "stages", "dc", "chunks", "tiles_h", "tiles_w",
                     "blocks", "smem")}
# ... and the float32 block's (K1, and K4 in float32)
F32_PLAN_ARGS = ("cob", "th", "tiles_h", "tiles_w", "stages", "blocks",
                 "smem")
_POINTERS = [ctypes.c_void_p] * 5
_SHAPES = [ctypes.c_int] * 8
# wrapper name -> (library, symbol prefix, order of the bfloat16 block)
_LIBRARIES = {"conv3d_packed_s1": ("packed_conv3d_kernel", "packed_conv3d",
                                   "K4"),
              "conv3d_packed_s1_v2": ("packed_conv3d_v2_kernel",
                                      "packed_conv3d_v2", "K5")}

# The bfloat16 blocks, K4's (csrc/conv3d_wgmma_persistent.cuh) and K5's
# (csrc/conv3d_wgmma.cuh): output rows, columns and threads a block (four
# warpgroups of one 2 x 32 M tile, or two of two 1 x 64 ones), output
# channels a block (both), the dynamic shared memory a block may have, what
# an SM has (1 KB of it kept per resident block), and K5's depth chunks.
WGMMA_TILES = {"K4": (8, 32, 512), "K5": (4, 64, 256)}
WGMMA_N = 32
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472
DEPTH_CHUNKS = (16, 12, 8, 6, 4)
# K5's float32 block (csrc/packed_conv3d_v2_kernel.cu): input channels a
# stage and output channels a block
V2_CK, V2_CO_B = 16, 32
# The float32 block of K1 and K4 (csrc/conv3d_tile.cuh): output columns a
# block and a thread, output channels a thread, input channels a stage,
# halo columns staged, the most threads a block, its Cout tiles
F32_TW, F32_CW, F32_CO_T, F32_CK, F32_HC = 32, 16, 4, 8, 34
F32_MAX_THREADS = 256
# warps an SM needs before the plan counts its FMA rate as full
F32_FULL_WARPS = 16
F32_COUT_TILES = (32, 64)
# (symbol prefix, channel slice) -> registers a thread of that bf16 kernel
_REGISTERS = {}


def _round_up(v, m):
    return -(-v // m) * m


def route_width_fault(dtype, ci, co):
    """Why the block of compute ``dtype`` refuses Ci and Co, or None where
    it takes them: the bfloat16 (``wgmma``) block Ci % 16 == 0, Co % 8 == 0
    and Ci <= 112, the float32 one (K1, and K4 / K5 in float32) Ci % 4 ==
    0 and Co % 4 == 0. The one rule of the kernels' checks and of
    ``route_widths``."""
    if dtype != torch.bfloat16:
        if ci % 4 or co % 4:
            return (f"Cin {ci} and Cout {co} must be multiples of 4 (16-byte "
                    "vector loads)")
        return None
    if ci % 16 or co % 8:
        return (f"Cin {ci} must be a multiple of 16 and Cout {co} a "
                "multiple of 8 (wgmma k16 steps, 8-channel core matrices)")
    if max(_wgmma_smem(ci, 2, o) for o in WGMMA_TILES) > SMEM_PER_BLOCK:
        return (f"Cin {ci} above 112 (the weights and two ring stages "
                "exceed shared memory)")
    return None


def check_wgmma_widths(ci, co, what="bfloat16 route"):
    """Raise unless the bfloat16 (``wgmma``) block takes Ci and Co."""
    fault = route_width_fault(torch.bfloat16, ci, co)
    if fault:
        raise ValueError(f"{what}: {fault}")


class RouteWidths(NamedTuple):
    """How a conv of Ci -> Co runs on a block (``route_widths``): Ci and Co
    padded with zero channels, and the slices [lo, hi) of the padded Ci
    that one launch each takes."""
    ci: int
    co: int
    slices: tuple


@functools.lru_cache(maxsize=256)
def route_widths(dtype, ci, co):
    """``RouteWidths`` of a conv of any Ci -> Co on the block of compute
    ``dtype``, as JAX's kernels take any widths: Ci and Co padded up to the
    block's multiples (4 and 4 in float32, 16 and 8 in bfloat16); one slice
    in float32, in bfloat16 the fewest slices of one width (a multiple of
    16, the last one narrower) that the block takes, 128 as two of 64. The
    padded channels are zero, so they add nothing."""
    if dtype != torch.bfloat16:
        ci, co = _round_up(ci, 4), _round_up(co, 4)
        return RouteWidths(ci, co, ((0, ci),))
    ci, co = _round_up(ci, 16), _round_up(co, 8)
    n = 1
    while route_width_fault(dtype, _round_up(-(-ci // n), 16), co):
        n += 1
    step = _round_up(-(-ci // n), 16)
    return RouteWidths(ci, co, tuple((lo, min(lo + step, ci))
                                     for lo in range(0, ci, step)))


def _wgmma_ck(ci):
    """Input channels per ring stage: one TMA box of 32, 64 or 128 bytes."""
    return 64 if ci % 64 == 0 else 32 if ci % 32 == 0 else 16


def _wgmma_smem(ci, stages, order):
    """Dynamic shared memory of ``order``'s block, as the kernel lays it
    out (``smem_bytes`` in its header, which refuses less): 1 KB of
    alignment slack, the weights (27 * Ci x N bf16), ``stages`` halo tiles
    of (TH + 2) x (TW + 2) x CK bf16, each 1 KB aligned, two mbarriers a
    stage and the weights' one."""
    th, tw, _ = WGMMA_TILES[order]
    stage = (th + 2) * (tw + 2) * _wgmma_ck(ci) * 2
    return (1024 + _round_up(27 * ci * WGMMA_N * 2, 1024)
            + stages * _round_up(stage, 1024) + 16 * stages + 8)


def wgmma_weights(kernel, cout_tiles):
    """The kernel [3, 3, 3, Ci, Co] as the bfloat16 block's shared-memory
    image of its weights, one per Cout tile of N channels: [cout_tiles, 27
    taps, Ci / 16 slabs, N / 8, 2, 8, 8], a slab being the 16 input
    channels of one tap as N / 8 x 2 core matrices (8 output channels x 8
    input channels, input channel fastest), the wgmma B operand's no-swizzle
    K-major layout; channels past Co are zero."""
    ci, co = kernel.shape[-2:]
    k = F.pad(kernel.reshape(27, ci, co), (0, cout_tiles * WGMMA_N - co))
    return k.view(27, ci // 16, 2, 8, cout_tiles, WGMMA_N // 8, 8).permute(
        4, 0, 1, 5, 2, 6, 3).contiguous()


class WgmmaOperands(NamedTuple):
    """K4's bfloat16 operands, made and checked once for calls whose
    weights and epilogue do not change (the eval trunk): the kernel's image
    (``wgmma_weights``), its Cout tiles, Ci, Co and pack, and the float32
    [pack*Co] scale and bias, all on one device."""
    image: torch.Tensor
    cout_tiles: int
    ci: int
    co: int
    pack: int
    scale: torch.Tensor
    bias: torch.Tensor


def wgmma_operands(kernel, scale=1.0, bias=0.0, pack=1):
    """``WgmmaOperands`` of a kernel [3, 3, 3, Ci, Co] (rounded to
    bfloat16) and a scalar, [Co] or [pack*Co] epilogue, on the kernel's
    device, for ``conv3d_packed_s1_prepared``; raises at a width the
    bfloat16 route does not take."""
    ci, co = kernel.shape[-2:]
    check_wgmma_widths(ci, co)
    tiles = -(-co // WGMMA_N)
    device = kernel.device
    scale, bias = (full_epilogue(v, pack, co, device).contiguous()
                   for v in (scale, bias))
    if scale.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("wgmma_operands: scale and bias must be 16-byte "
                         "aligned")
    return WgmmaOperands(wgmma_weights(kernel.to(torch.bfloat16), tiles),
                         tiles, ci, co, pack, scale, bias)


def packed_v2_weights(kernel):
    """The float32 kernel [3, 3, 3, Ci, Co] as K5's float32 block fetches
    it, one bulk copy a stage: [ceil(Co / 32) Cout tiles, ceil(Ci / 16)
    input-channel slices, 27 taps, 16 input channels, 32 output channels],
    zero past Ci and Co."""
    ci, co = kernel.shape[-2:]
    slices, tiles = -(-ci // V2_CK), -(-co // V2_CO_B)
    k = F.pad(kernel.reshape(27, ci, co),
              (0, tiles * V2_CO_B - co, 0, slices * V2_CK - ci))
    return k.view(27, slices, V2_CK, tiles, V2_CO_B).permute(
        3, 1, 0, 2, 4).contiguous()


def conv3d_f32_weights(kernel, cob):
    """The float32 kernel [3, 3, 3, Ci, Co] as the float32 block fetches
    it, one bulk copy a stage: [ceil(Co / cob) Cout tiles, 3 depth taps,
    ceil(Ci / 8) input-channel slices, 9 (dh, dw) taps, 8 input channels,
    cob output channels], zero past Ci and Co."""
    ci, co = kernel.shape[-2:]
    slices, tiles = -(-ci // F32_CK), -(-co // cob)
    k = kernel.reshape(3, 9, ci, co)
    if ci % F32_CK or co % cob:
        k = F.pad(k, (0, tiles * cob - co, 0, slices * F32_CK - ci))
    return k.view(3, 9, slices, F32_CK, tiles, cob).permute(
        4, 0, 2, 1, 3, 5).contiguous()


def f32_threads(cob, th):
    """Threads of a float32 block: cob / 4 channel groups x 2 column groups
    x th rows."""
    return cob // F32_CO_T * (F32_TW // F32_CW) * th


def f32_smem(cob, th, stages):
    """Dynamic shared memory of a float32 block, as the kernel lays it out
    (``smem_bytes`` in csrc/conv3d_tile.cuh, which refuses less): 128 bytes
    of alignment slack, then per stage the weights (9 taps x 8 x cob
    float32) and the halo box ((th + 2) x 34 x 8 float32, rounded up to 128
    bytes), then a full mbarrier and a release counter a stage."""
    weights = 9 * F32_CK * cob * 4
    halo = _round_up((th + 2) * F32_HC * F32_CK * 4, 128)
    return 128 + stages * (weights + halo) + 16 * stages


def conv3d_f32_plan(b, r, pack, h, w, ci, co, sms, residency):
    """Launch plan of the float32 block on xp [b, r, h, w, pack*ci] ->
    pack*co channels, on a card of ``sms`` SMs, where ``residency(cob, th,
    smem)`` is the blocks of that kernel an SM holds (on the card, the
    built kernel's cudaOccupancyMaxActiveBlocksPerMultiprocessor).

    The Cout tile cob: 32 for Co <= 32, else 64 (one block covers all of
    Co <= 64, so its halo is staged once). Rows a block th (from the most
    that 256 threads allow down to 2) and ring stages (3 or 2): the pair
    that minimises the busiest SM's time, ceil(blocks / sms) blocks run
    ``residency`` at a time, each taking time in proportion to its rows
    plus two (its halo rows; a block's weights and prologue cost the same
    at any th), and longer while its SM holds fewer than F32_FULL_WARPS
    warps; on a tie more stages, then more rows. The grid is 1-D, blocks
    ordered output depth fastest, then batch, W tile, H tile, Cout tile.
    Returns {cob, th, stages, tiles_h, tiles_w, cout_tiles, threads,
    blocks, smem}.
    """
    cob = F32_COUT_TILES[0] if co <= F32_COUT_TILES[0] else F32_COUT_TILES[1]
    cout_tiles, tiles_w = -(-co // cob), -(-w // F32_TW)
    best, best_key = None, None
    th = F32_MAX_THREADS // f32_threads(cob, 1)
    while th >= 2:
        threads = f32_threads(cob, th)
        tiles_h = -(-h // th)
        blocks = cout_tiles * tiles_h * tiles_w * b * r * pack
        for stages in (3, 2):
            smem = f32_smem(cob, th, stages)
            per_sm = residency(cob, th, smem) if smem <= SMEM_PER_BLOCK else 0
            if per_sm < 1:
                continue
            load = -(-blocks // sms)             # blocks of the busiest SM
            live = min(load, per_sm)
            warps = min(1.0, live * threads / (32 * F32_FULL_WARPS))
            cost = -(-load // per_sm) * live * (th + 2) / warps
            key = (cost, -stages, -th)
            if best_key is None or key < best_key:
                best_key = key
                best = {"cob": cob, "th": th, "stages": stages,
                        "tiles_h": tiles_h, "tiles_w": tiles_w,
                        "cout_tiles": cout_tiles, "threads": threads,
                        "blocks": blocks, "smem": smem}
        th //= 2
    if best is None:
        raise RuntimeError("float32 conv block: no launch plan fits an SM")
    if best["blocks"] >= 2 ** 31:
        raise ValueError(f"float32 conv block: {best['blocks']} blocks "
                         "exceed the grid")
    return best


@functools.lru_cache(maxsize=256)
def f32_plan(lib, prefix, device_index, b, r, pack, h, w, ci, co):
    """``conv3d_f32_plan`` for one call shape on a device, its residency
    read from library ``lib``'s built kernel (``<prefix>_f32_residency``)
    on that device; kept per (library, device, shape). Call it with that
    device current."""
    def residency(cob, th, smem):
        n = getattr(lib, f"{prefix}_f32_residency")(cob, th, smem)
        if n < 0:
            raise RuntimeError(f"{prefix}_f32: CUDA error {-n} reading the "
                               "kernel's residency")
        return n
    sms = torch.cuda.get_device_properties(
        device_index).multi_processor_count
    return conv3d_f32_plan(b, r, pack, h, w, ci, co, sms, residency)


def wgmma_plan(order, b, r, pack, h, w, ci, co, sms, regs):
    """Launch plan of ``order``'s bfloat16 block, "K4" (a persistent grid)
    or "K5" (a chunk of output depths a block), on xp [b, r, h, w, pack*ci]
    -> pack*co channels, on a card of ``sms`` SMs, for a kernel of ``regs``
    registers a thread.

    The output of one Cout tile is ``items`` work items of one output depth
    of one tile (WGMMA_TILES: 8 x 32 for K4, 4 x 64 for K5), numbered depth
    fastest, then batch, W tile, H tile; each Cout tile has ``per_tile``
    blocks, ``blocks`` = per_tile x cout_tiles in all, block index = Cout
    tile x per_tile + j. Both orders walk, in a block, runs of consecutive
    depths of one tile, staging each input plane of a run once. K4:
    per_tile = the blocks resident on the card (estimated from shared
    memory, threads and registers) over the Cout tiles, at most items;
    block j walks items
    [j * items // per_tile, (j + 1) * items // per_tile), loading its Cout
    tile's weights once (``dc`` 0). K5: a block is one chunk of ``dc``
    depths of one tile (per_tile = tiles x chunks), the chunk, of
    DEPTH_CHUNKS, that minimises waves x (3 * chunk + 2) depth taps (its two
    halo planes run one tap each), a wave being the resident blocks; on a
    tie the larger chunk.

    Ring stages: as many (2 to 4) as keep the blocks resident per SM that
    two stages allow. Returns {ck, stages, dc, chunks, tiles_h, tiles_w,
    cout_tiles, items, per_tile, blocks, smem}.
    """
    check_wgmma_widths(ci, co)
    th, tw, threads = WGMMA_TILES[order]
    smem = functools.partial(_wgmma_smem, ci, order=order)
    # registers are allocated to a warp in units of 256: 8 a thread
    per_sm = min(2048 // threads, 65536 // (threads * _round_up(regs, 8)),
                 SMEM_PER_SM // (smem(2) + 1024))
    stages = max(s for s in (2, 3, 4) if smem(s) <= SMEM_PER_BLOCK
                 and SMEM_PER_SM // (smem(s) + 1024) >= per_sm)
    tiles_h, tiles_w = -(-h // th), -(-w // tw)
    cout_tiles = -(-co // WGMMA_N)
    tiles = b * tiles_h * tiles_w
    d = r * pack
    items = tiles * d
    slots = sms * per_sm
    if order == "K4":
        dc = chunks = 0
        per_tile = min(items, max(1, slots // cout_tiles))
    else:
        dc = min(DEPTH_CHUNKS, key=lambda c: (
            -(-tiles * cout_tiles * -(-d // c) // slots)
            * (3 * min(c, d) + 2), -c))
        chunks = -(-d // dc)
        per_tile = tiles * chunks
    blocks = per_tile * cout_tiles
    if blocks >= 2 ** 31 or items >= 2 ** 31:
        raise ValueError(f"bfloat16 route: {blocks} blocks or {items} work "
                         "items exceed the grid")
    return {"ck": _wgmma_ck(ci), "stages": stages, "dc": dc,
            "chunks": chunks, "tiles_h": tiles_h, "tiles_w": tiles_w,
            "cout_tiles": cout_tiles, "items": items, "per_tile": per_tile,
            "blocks": blocks, "smem": smem(stages)}


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


@functools.lru_cache(maxsize=256)
def bf16_plan(plan, lib, prefix, order, sms, b, r, pack, h, w, ci, co):
    """``plan`` (``wgmma_plan``) for one call shape on a card of ``sms``
    SMs, with the registers of library ``lib``'s built kernel (symbol
    prefix ``prefix``); kept per (plan function, library, SMs, shape), so
    that a plan function put in its place is never served another's
    plans."""
    regs = _registers(lib, prefix, _wgmma_ck(ci))
    return plan(order, b, r, pack, h, w, ci, co, sms, regs)


@functools.lru_cache(maxsize=512)
def wgmma_dims(plan, lib, prefix, sms, b, r, pack, h, w, ci, co, relu):
    """The ints of K4's bfloat16 launch (csrc/conv3d_wgmma_persistent.cuh,
    enum Dim): the shapes, ReLU and ``bf16_plan``'s plan, packed once per
    call shape into a ctypes array (twenty ints through ctypes cost the
    eval trunk's launch more host time than one pointer)."""
    p = bf16_plan(plan, lib, prefix, "K4", sms, b, r, pack, h, w, ci, co)
    return (ctypes.c_int * (8 + len(_PLAN_ARGS["K4"])))(
        b, r, pack, h, w, ci, co, relu, *(p[k] for k in _PLAN_ARGS["K4"]))


@functools.lru_cache(maxsize=64)
def _filled(value, n, device):
    """float32 [n] of ``value`` on ``device``, made once per key and kept
    (usable under autograd; callers must not write to it)."""
    with torch.inference_mode(False):
        return torch.full((n,), value, dtype=torch.float32, device=device)


def full_epilogue(v, pack, co, device):
    """A scalar, [Co] or [pack*Co] epilogue term -> float32 [pack*Co], as
    JAX's ``_full_epilogue``; differentiable in ``v`` when it is a tensor
    (at pack 1 a [Co] tensor is returned as a view of itself). A Python
    number is filled on ``device`` once per (value, size, device)
    and kept: a copy from the host would make every launch wait for the
    work queued before it, and a fill per call costs a launch."""
    if isinstance(v, (int, float)):
        return _filled(float(v), pack * co, torch.device(device))
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    if v.numel() == 1 and v.dim() <= 1:
        return v.reshape(()).expand(pack * co)
    if v.numel() == co:
        return v.reshape(co) if pack == 1 else v.reshape(co).repeat(pack)
    if v.numel() == pack * co:
        return v.reshape(pack * co)
    raise ValueError(f"epilogue term of shape {tuple(v.shape)} is neither a "
                     f"scalar, [{co}] nor [{pack * co}]")


def conv3d_packed_s1_plain(xp, kernel, scale=1.0, bias=0.0, pack=4,
                           relu=False):
    """Plain PyTorch version: xp [B, R, H, W, pack*Ci] float32 or bfloat16,
    kernel [3, 3, 3, Ci, Co] -> [B, R, H, W, pack*Co] in xp.dtype (kernel
    rounded to xp.dtype, float32 sums and epilogue, one rounding)."""
    co = kernel.shape[-1]
    ones = kernel.new_ones(co, dtype=torch.float32)
    y = conv3d_plain(unpack_volume(xp, pack), kernel.to(xp.dtype), ones,
                     0 * ones, False)
    y = pack_volume(y, pack) * full_epilogue(scale, pack, co, xp.device) \
        + full_epilogue(bias, pack, co, xp.device)
    return (y.clamp_min(0.0) if relu else y).to(xp.dtype)


def _check_volume(name, xp, cin, co, pack):
    """Check the input volume of a launch: on the card, [B, R, H, W,
    pack*Ci], contiguous, 16-byte aligned. Its size is free: the blocks
    address the output in 64-bit offsets and read the input through TMA
    maps of 64-bit strides, and the plans refuse a grid of 2^31 blocks or
    more."""
    if xp.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xp.device}")
    if xp.dim() != 5 or xp.shape[-1] != pack * cin:
        raise ValueError(f"{name}: xp {tuple(xp.shape)} is not "
                         f"[B,R,H,W,{pack}*{cin}]")
    if not xp.is_contiguous() or xp.data_ptr() % 16:
        raise ValueError(f"{name}: operands must be contiguous and 16-byte "
                         "aligned")


def _checked(name, xp, kernel, scale, bias, pack):
    """Check the operands of a launch; returns (kernel in xp.dtype, scale,
    bias) as the kernel takes them."""
    cin, co = kernel.shape[-2:]
    _check_volume(name, xp, cin, co, pack)
    if tuple(kernel.shape) != (3, 3, 3, cin, co):
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} is not "
                         "[3,3,3,Ci,Co]")
    if xp.dtype not in _TYPES or kernel.dtype not in _TYPES:
        raise ValueError(f"{name}: xp and kernel must be float32 or "
                         f"bfloat16, not {xp.dtype} and {kernel.dtype}")
    if xp.dtype == torch.bfloat16:
        check_wgmma_widths(cin, co, f"{name} in bfloat16")
    elif (fault := route_width_fault(xp.dtype, cin, co)) is not None:
        raise ValueError(f"{name}: {fault}")
    kernel = kernel.to(xp.dtype)
    scale, bias = scale.contiguous(), bias.contiguous()
    for t in (kernel, scale, bias):
        if t.device != xp.device:
            raise ValueError(f"{name}: all operands must be on {xp.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             "16-byte aligned")
    return kernel, scale, bias


def _registers(lib, prefix, ck):
    """Registers a thread of the library's bfloat16 kernel of channel slice
    ``ck``, read once from the built kernel."""
    if (prefix, ck) not in _REGISTERS:
        n = getattr(lib, f"{prefix}_bf16_regs")(ck)
        if n <= 0:
            raise RuntimeError(f"{prefix}_bf16: CUDA error {-n} reading the "
                               "kernel's registers")
        _REGISTERS[prefix, ck] = n
    return _REGISTERS[prefix, ck]


@functools.cache
def library(name):
    """ctypes handle of wrapper ``name``'s library, built at first use (kept:
    the signatures are declared once)."""
    library_name, prefix, order = _LIBRARIES[name]
    f32_plan_ints = [ctypes.c_int] * len(F32_PLAN_ARGS) if order == "K4" \
        else []
    signatures = {
        f"{prefix}_f32": (_POINTERS + _SHAPES + f32_plan_ints
                          + [ctypes.c_void_p], ctypes.c_int),
        f"{prefix}_bf16": (_POINTERS + ([ctypes.POINTER(ctypes.c_int)]
                                        if order == "K4" else _SHAPES + [
                                            ctypes.c_int] * len(
                                                _PLAN_ARGS["K5"]))
                           + [ctypes.c_void_p], ctypes.c_int),
        f"{prefix}_bf16_regs": ([ctypes.c_int], ctypes.c_int)}
    if order == "K5":
        signatures[f"{prefix}_f32_residency"] = ([], ctypes.c_int)
    else:
        signatures[f"{prefix}_f32_residency"] = ([ctypes.c_int] * 3,
                                                 ctypes.c_int)
        signatures[f"{prefix}_f32_regs"] = ([ctypes.c_int], ctypes.c_int)
    return _build.load(library_name, signatures)


def _launch(wrapper, xp, kernel, scale, bias, pack, relu):
    """Launch ``wrapper``'s kernel on checked operands, on their device and
    its current stream; counts the launch on ``wrapper``. A bfloat16
    ``kernel`` may be K4's prepared ``WgmmaOperands``."""
    b, r, h, w, _ = xp.shape
    prepared = isinstance(kernel, WgmmaOperands)
    cin, cout = (kernel.ci, kernel.co) if prepared else kernel.shape[-2:]
    out = torch.empty((b, r, h, w, pack * cout), dtype=xp.dtype,
                      device=xp.device)
    if out.numel() == 0:
        return out
    index = xp.device.index
    # the operand's device made current only where it is not (the context
    # costs the eval trunk's launch a few microseconds)
    with (contextlib.nullcontext() if torch._C._cuda_getDevice() == index
          else torch.cuda.device(index)):
        lib = library(wrapper.__name__)
        _, prefix, order = _LIBRARIES[wrapper.__name__]
        stream = _build.current_stream(xp.device)
        if xp.dtype == torch.bfloat16:
            image = (kernel if prepared else wgmma_operands(kernel)).image
            pointers = (xp.data_ptr(), image.data_ptr(), scale.data_ptr(),
                        bias.data_ptr(), out.data_ptr())
            sms, relu = _sm_count(index), int(bool(relu))
            if order == "K4":
                ints = (wgmma_dims(wgmma_plan, lib, prefix, sms, b, r, pack,
                                   h, w, cin, cout, relu),)
            else:
                p = bf16_plan(wgmma_plan, lib, prefix, order, sms, b, r,
                              pack, h, w, cin, cout)
                ints = (b, r, pack, h, w, cin, cout, relu,
                        *(p[k] for k in _PLAN_ARGS[order]))
            err = getattr(lib, f"{prefix}_bf16")(*pointers, *ints, stream)
        else:
            plan = []
            if order == "K5":
                kernel = packed_v2_weights(kernel)
            else:
                p = f32_plan(lib, prefix, index, b, r, pack, h, w, cin, cout)
                plan = [p[k] for k in F32_PLAN_ARGS]
                kernel = conv3d_f32_weights(kernel, p["cob"])
            err = getattr(lib, f"{prefix}_f32")(
                xp.data_ptr(), kernel.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), out.data_ptr(), b, r, pack, h, w, cin, cout,
                int(bool(relu)), *plan, stream)
    _build.check_launch(err, wrapper.__name__)
    wrapper.launches += 1
    if xp.dtype == torch.bfloat16:
        wrapper.bf16_launches += 1
    return out


class _PackedConv3dS1(torch.autograd.Function):
    """Forward: the kernel. Backward: the VJP of the plain conv (cuDNN on
    the unpacked view) through the epilogue and ReLU; for a unit scale and
    no ReLU, the two cuDNN gradient convolutions alone."""

    @staticmethod
    def forward(ctx, xp, kernel, scale, bias, pack, relu, unit_scale):
        out = _launch(conv3d_packed_s1, xp, kernel, scale, bias, pack, relu)
        ctx.pack, ctx.relu, ctx.unit_scale = pack, relu, unit_scale
        ctx.save_for_backward(xp, kernel, scale, out if relu else None)
        return out

    @staticmethod
    def backward(ctx, g):
        xp, kernel, scale, out = ctx.saved_tensors
        pack = ctx.pack
        need_x, need_k, need_s, need_b = ctx.needs_input_grad[:4]
        if ctx.relu:
            g = g * (out > 0)
        g32 = g.float()     # the epilogue's terms, in float32 as its forward
        sums = tuple(range(g.dim() - 1))
        grad_x = grad_k = grad_s = grad_b = None
        if need_b:
            grad_b = g32.sum(sums)
        # logical NCDHW views of the NDHWC volumes (channels_last_3d storage)
        x = unpack_volume(xp, pack).movedim(-1, 1)
        weight = kernel.permute(4, 3, 0, 1, 2).contiguous()
        if need_x or need_k:
            g_conv = unpack_volume(
                g if ctx.unit_scale else (g32 * scale).to(g.dtype),
                pack).movedim(-1, 1)
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g_conv, x, weight, None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
                False, [0, 0, 0], 1, [need_x, need_k, False])
            if need_x:
                grad_x = pack_volume(gx.movedim(1, -1), pack).contiguous()
            if need_k:
                grad_k = gw.permute(2, 3, 4, 1, 0)
        if need_s:
            raw = F.conv3d(x, weight, padding=1).movedim(1, -1)
            grad_s = (g32 * pack_volume(raw, pack).float()).sum(sums)
        return grad_x, grad_k, grad_s, grad_b, None, None, None


def conv3d_packed_s1(xp, kernel, scale=1.0, bias=0.0, pack=4, relu=False):
    """Stride-1 3x3x3 SAME conv (+scale/bias/ReLU) on a packed volume (K4).

    Args:
      xp: [B, R, H, W, pack*Ci] float32 or bfloat16, contiguous
        (``pack_volume`` layout; pack 1 is plain NDHWC).
      kernel: [3, 3, 3, Ci, Co] true (unpacked) kernel, float32 or
        bfloat16; rounded to xp.dtype.
      scale, bias: scalar, [Co] or [pack*Co] epilogue, float32.
      relu: apply max(0, .) after the epilogue.

    Returns [B, R, H, W, pack*Co] in xp.dtype, differentiable in xp, kernel,
    scale and bias. A CPU tensor runs ``conv3d_packed_s1_plain``; a CUDA
    tensor launches the kernel or raises, through the autograd Function
    only when grad mode is on and an operand requires grad.
    """
    co = kernel.shape[-1]
    unit_scale = isinstance(scale, (int, float)) and scale == 1
    scale = full_epilogue(scale, pack, co, xp.device)
    bias = full_epilogue(bias, pack, co, xp.device)
    if xp.device.type == "cpu":
        return conv3d_packed_s1_plain(xp, kernel, scale, bias, pack, relu)
    kernel, scale, bias = _checked("conv3d_packed_s1", xp, kernel, scale,
                                   bias, pack)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (
            xp, kernel, scale, bias)):
        return _PackedConv3dS1.apply(xp, kernel, scale, bias, pack, relu,
                                     unit_scale)
    return _launch(conv3d_packed_s1, xp, kernel, scale, bias, pack, relu)


def conv3d_packed_s1_prepared(xp, operands, relu=False):
    """K4's bfloat16 launch on prepared operands, forward only.

    ``operands`` is ``wgmma_operands(kernel, scale, bias, pack)``: the same
    result as ``conv3d_packed_s1(xp, kernel, scale, bias, pack, relu)`` on a
    bfloat16 CUDA ``xp``, with only ``xp`` checked and nothing built; the
    eval trunk's entry (``models/layers.ConvUnit``). It has no gradient, so
    with grad mode on and an ``xp`` that requires grad it raises; a CPU
    tensor raises too (the plain version takes the kernel: call
    ``conv3d_packed_s1``). Counted on ``conv3d_packed_s1``.
    """
    name = "conv3d_packed_s1_prepared"
    if torch.is_grad_enabled() and xp.requires_grad:
        raise RuntimeError(f"{name} is forward only; differentiate through "
                           "conv3d_packed_s1")
    _check_volume(name, xp, operands.ci, operands.co, operands.pack)
    if xp.dtype != torch.bfloat16 or xp.device != operands.image.device:
        raise ValueError(f"{name}: the prepared operands take a bfloat16 xp "
                         f"on {operands.image.device}, not {xp.dtype} on "
                         f"{xp.device}")
    return _launch(conv3d_packed_s1, xp, operands, operands.scale,
                   operands.bias, operands.pack, relu)


def conv3d_packed_s1_v2(xp, kernel, scale=1.0, bias=0.0, pack=4,
                        relu=False):
    """K5: the function of ``conv3d_packed_s1``, forward only.

    Same arguments and result as ``conv3d_packed_s1``. JAX's
    ``conv3d_packed_s1_pallas_v2`` has no VJP, so with grad mode on and an
    operand that requires grad this raises, on every device, rather than
    return a result without a gradient. A CPU tensor runs
    ``conv3d_packed_s1_plain``; a CUDA tensor launches the kernel or raises.
    """
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (xp, kernel, scale, bias)):
        raise RuntimeError("conv3d_packed_s1_v2 is forward only (no VJP, as "
                           "JAX's conv3d_packed_s1_pallas_v2); differentiate "
                           "through conv3d_packed_s1")
    co = kernel.shape[-1]
    scale = full_epilogue(scale, pack, co, xp.device)
    bias = full_epilogue(bias, pack, co, xp.device)
    if xp.device.type == "cpu":
        return conv3d_packed_s1_plain(xp, kernel, scale, bias, pack, relu)
    kernel, scale, bias = _checked("conv3d_packed_s1_v2", xp, kernel, scale,
                                   bias, pack)
    # the grid's y axis holds B x the depth chunks
    if xp.shape[0] * xp.shape[1] * pack > 65535:
        raise ValueError(f"conv3d_packed_s1_v2: volume {tuple(xp.shape)} "
                         "too large for the grid (B x depth > 65535)")
    return _launch(conv3d_packed_s1_v2, xp, kernel, scale, bias, pack, relu)


conv3d_packed_s1.launches = conv3d_packed_s1.bf16_launches = 0
conv3d_packed_s1_v2.launches = conv3d_packed_s1_v2.bf16_launches = 0
