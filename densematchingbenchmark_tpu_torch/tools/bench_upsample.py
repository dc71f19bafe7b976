"""AcfNet's learned upsample on the card: cuDNN's transposed conv against
the same function as a conv at the input's resolution.

    python -m densematchingbenchmark_tpu_torch.tools.bench_upsample \\
        [--batches 1 4] [--out FILE]

AcfNet upsamples each classified cost [B, 1, D/4, H/4, W/4] with
ConvTranspose3d(1, 1, 8, stride 4, padding 2) to [B, 1, D, H, W]
(models/aggregators/acfnet.py); the port calls F.conv_transpose3d, as the
JAX package leaves it to XLA. Each output voxel 4q + r (per axis) takes
two of the eight taps, from inputs q - 1, q and q + 1, so the same function
is a 3x3x3 conv (padding 1) with 64 output channels, one per output phase
r, at the input's resolution, then a 3-D pixel shuffle (``phase_form``).
This tool is a yardstick for that rewrite, which the port does not call:
at 384x1248 (a cost of [B, 1, 48, 96, 312]) in float32 and bfloat16 it
holds the phase form against F.conv_transpose3d, then times both by one
call (median of 5) and chained (20 in a row), the forward and the forward
with its backward (the input's and the weight's gradients), with CUDA
events. Needs a GPU; prints the card's name and power limit and one JSON
line of the results last.
"""

import argparse
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

LOW = (48, 96, 312)     # the classified cost of a 384x1248 frame
CHAIN = 20


def phase_weight(weight):
    """ConvTranspose3d(1, 1, 8, stride 4, padding 2)'s weight [1, 1, 8, 8,
    8] -> the conv weight [64, 1, 3, 3, 3] of its 64 output phases: phase
    r, window j takes tap k = r + 6 - 4j where 0 <= k < 8 (output 4q + r
    reads input q + j - 1 through tap 4q + r + 2 - 4(q + j - 1))."""
    r = torch.arange(4, device=weight.device)
    j = torch.arange(3, device=weight.device)
    k = r[:, None] + 6 - 4 * j[None, :]                  # [4, 3]
    valid = (k >= 0) & (k < 8)
    k = k.clamp(0, 7)
    w = weight[0, 0]
    taps = w[k[:, :, None, None, None, None], k[None, None, :, :, None, None],
             k[None, None, None, None, :, :]]           # [4, 3, 4, 3, 4, 3]
    mask = (valid[:, :, None, None, None, None]
            & valid[None, None, :, :, None, None]
            & valid[None, None, None, None, :, :])
    taps = taps * mask
    return taps.permute(0, 2, 4, 1, 3, 5).reshape(64, 1, 3, 3, 3)


def phase_form(x, weight):
    """F.conv_transpose3d(x, weight, stride=4, padding=2) for x [B, 1, d, h,
    w]: the 64-phase conv, then the 3-D pixel shuffle."""
    b, _, d, h, w = x.shape
    y = F.conv3d(x, phase_weight(weight).to(x.dtype), padding=1)
    y = y.reshape(b, 4, 4, 4, d, h, w).permute(0, 4, 1, 5, 2, 6, 3)
    return y.reshape(b, 1, 4 * d, 4 * h, 4 * w)


def transposed(x, weight):
    return F.conv_transpose3d(x, weight.to(x.dtype), stride=4, padding=2)


def time_ms(fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def chained_ms(fn, n=CHAIN):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def measure(batch, dtype, gen):
    """One shape and dtype: the phase form's largest error against cuDNN's
    transposed conv (forward and both gradients) and the times."""
    x = torch.randn((batch, 1, *LOW), device="cuda", generator=gen)
    x = x.to(dtype).requires_grad_()
    weight = (torch.randn((1, 1, 8, 8, 8), device="cuda", generator=gen)
              * 0.1).requires_grad_()
    ct = torch.randn((batch, 1, *(4 * s for s in LOW)), device="cuda",
                     generator=gen).to(dtype)
    row = {"batch": batch, "dtype": str(dtype).replace("torch.", "")}
    for name, fn in (("transposed", transposed), ("phase", phase_form)):
        y = fn(x, weight)
        grads = torch.autograd.grad(y, (x, weight), ct)
        row[name] = (y, grads)

        def train(fn=fn):
            torch.autograd.grad(fn(x, weight), (x, weight), ct)

        with torch.no_grad():
            row[f"{name}_ms"] = time_ms(lambda: fn(x, weight))
            row[f"{name}_chained_ms"] = chained_ms(lambda: fn(x, weight))
        row[f"{name}_fwd_bwd_ms"] = time_ms(train)
    (ya, ga), (yb, gb) = row.pop("transposed"), row.pop("phase")
    for key, a, b in (("y", ya, yb), ("dx", ga[0], gb[0]),
                      ("dw", ga[1], gb[1])):
        top = a.float().abs().max().item()
        row[f"{key}_rel_err"] = (a.float() - b.float()).abs().max().item() \
            / top
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batches", type=int, nargs="+", default=[1, 4])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_upsample needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for batch in args.batches:
            row = measure(batch, dtype, gen)
            rows.append(row)
            print(f"upsample {row['dtype']} batch {batch} "
                  f"[{batch}, 1, {'x'.join(map(str, LOW))}] -> x4: "
                  f"transposed {row['transposed_ms']:.3f} ms (chained "
                  f"{row['transposed_chained_ms']:.3f}, with backward "
                  f"{row['transposed_fwd_bwd_ms']:.3f}); phase form "
                  f"{row['phase_ms']:.3f} (chained "
                  f"{row['phase_chained_ms']:.3f}, with backward "
                  f"{row['phase_fwd_bwd_ms']:.3f}); largest error of the "
                  f"phase form / max|transposed|: y {row['y_rel_err']:.2e}, "
                  f"dx {row['dx_rel_err']:.2e}, dw {row['dw_rel_err']:.2e}; "
                  f"{smi}")
            torch.cuda.empty_cache()
    line = json.dumps({"device": smi, "rows": rows})
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
