"""Microbench: the packed stride-1 conv3d kernels K4 and K5 against cuDNN.

    python -m densematchingbenchmark_tpu_torch.tools.microbench_packed \\
        [--iters 20] [--pack 4] [--dtype bfloat16|float32] [--device cuda|cpu]

The port's counterpart of the JAX package's tools/microbench_pallas_packed.py,
with its three cases (the PSMNet trunk at 384x1248, D = 192 / 4): 32->32 and
64->32 at 1x48x96x312, 64->64 at 1x24x48x156, packed ``--pack`` depth slices
to the channel axis, and its data: numpy ``RandomState(0)``, x = randn * 0.1,
then kernel = randn * 0.05, cast to ``--dtype``. Per case, four rows, each
timed over ``--iters`` chained iterations (each conv takes the previous
output, its channels projected back to Ci by ``rechain``, as the JAX tool):

  dense packed    F.conv3d (cuDNN on the card) of the packed volume with
                  ``dpack_kernel``: pack x the true MACs; the JAX tool's
                  "XLA packed" row
  K4              ``conv3d_packed_s1``
  K5              ``conv3d_packed_s1_v2``
  unpacked        F.conv3d on the unpacked volume: the one library call for
                  the true function, a yardstick the port does not call

Each row gives ms per iteration (CUDA events on the card; ``perf_counter``
on the CPU, where the kernels run their plain versions), true TFLOP/s
(2 * 27 * Ci * Co per voxel over that time) and the dense-packed row's time
over the row's (above 1: faster than dense packed). There is no ``--h_tiles``
axis: the H tile is a TPU schedule knob, and the port's kernels tile H and W
themselves. TF32 is off, so the float32 cuDNN rows compute in float32. With
no GPU and no ``--device cpu`` it raises; it never falls back to the CPU.
"""

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..apis import resolve_device
from ..ops.conv3d import dpack_kernel, pack_volume, unpack_volume
from ..ops.cuda import conv3d_packed_s1, conv3d_packed_s1_v2

# (name, (B, D, H, W), Ci, Co)
CASES = (("32->32 full-res", (1, 48, 96, 312), 32, 32),
         ("64->32 full-res", (1, 48, 96, 312), 64, 32),
         ("64->64 half-res", (1, 24, 48, 156), 64, 64))
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ROWS = ("dense packed", "K4", "K5", "unpacked")


def case_data(shape, ci, co, seed=0):
    """The JAX tool's inputs: x [B, D, H, W, Ci] and kernel [3, 3, 3, Ci,
    Co], float32 numpy arrays from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape, ci) * 0.1).astype(np.float32)
    k = (rng.randn(3, 3, 3, ci, co) * 0.05).astype(np.float32)
    return x, k


def rechain(y, c):
    """Project the last (channel) axis of ``y`` to ``c`` channels by
    repeating it and slicing, as the JAX tool's ``rechain``."""
    if y.shape[-1] == c:
        return y
    reps = -(-c // y.shape[-1])
    return torch.cat([y] * reps, -1)[..., :c].contiguous()


def library_conv(v, weight):
    """F.conv3d (cuDNN on the card) of a channels-last volume v [B, D, H, W,
    C] with an OIDHW weight, SAME padding; channels-last result."""
    return F.conv3d(v.movedim(-1, 1), weight, padding=1).movedim(1, -1)


def time_chain(fn, x, iters, device):
    """ms per iteration of ``iters`` chained calls y = fn(y) from x, after
    the same chain once outside the timing (a single call left the first
    row of a fresh process several times slower on the card)."""
    def chain():
        y = x
        for _ in range(iters):
            y = fn(y)

    chain()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chain()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    chain()
    return (time.perf_counter() - t0) * 1e3 / iters


def run(cases=CASES, dtype=torch.bfloat16, pack=4, iters=20, device=None):
    """Time the four rows of every case; returns one dict per row: case,
    row, dtype, pack, device, ms, tflops (true) and vs_dense (the dense
    packed row's ms over this row's)."""
    device = resolve_device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("microbench_packed: no CUDA device; pass "
                               "device='cpu' to time the plain versions")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    with torch.no_grad():
        for name, shape, ci, co in cases:
            x, k = case_data(shape, ci, co)
            x = torch.from_numpy(x).to(device, dtype)
            k = torch.from_numpy(k).to(device, dtype)
            xp = pack_volume(x, pack).contiguous()
            dense_w = dpack_kernel(k, pack).permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            true_w = k.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            fns = {
                "dense packed": (lambda v: rechain(library_conv(v, dense_w),
                                                   pack * ci), xp),
                "K4": (lambda v: rechain(conv3d_packed_s1(v, k, pack=pack),
                                         pack * ci), xp),
                "K5": (lambda v: rechain(conv3d_packed_s1_v2(v, k, pack=pack),
                                         pack * ci), xp),
                "unpacked": (lambda v: rechain(library_conv(v, true_w), ci),
                             unpack_volume(xp, pack).contiguous()),
            }
            flops = 2 * 27 * ci * co * int(np.prod(shape))
            times = {row: time_chain(fn, v, iters, device)
                     for row, (fn, v) in fns.items()}
            for row in ROWS:
                rows.append({"case": name, "row": row,
                             "dtype": str(dtype).replace("torch.", ""),
                             "pack": pack, "device": device.type,
                             "ms": times[row],
                             "tflops": flops / times[row] / 1e9,
                             "vs_dense": times["dense packed"] / times[row]})
            del x, xp, fns
    return rows


def format_row(r):
    return (f"{r['case']}: {r['row']:<14} {r['ms']:9.3f} ms "
            f"({r['tflops']:7.2f} true-TF/s)  {r['vs_dense']:5.2f}x")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--pack", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rows = run(dtype=DTYPES[args.dtype], pack=args.pack, iters=args.iters,
               device=args.device)
    where = rows[0]["device"]
    if where == "cuda":
        where = torch.cuda.get_device_name(0)
    else:
        where += " (plain versions; no device time)"
    print(f"device={where} dtype={args.dtype} pack={args.pack} "
          f"iters={args.iters}")
    for r in rows:
        print(format_row(r))


if __name__ == "__main__":
    main()
