"""Pieces the port's command-line tools share: dotted config overrides,
the compute dtype flag, and the measurement tools' device (the GPU unless
--cpu) and timer (the multi-process flags are
parallel.distributed.add_distributed_args)."""

import ast
import time

import torch

from ..apis import resolve_device


def parse_overrides(items):
    """['model.max_disp=96', ...] -> {'model.max_disp': 96, ...}; a value
    that is not a Python literal stays a string."""
    overrides = {}
    for item in items:
        key, val = item.split("=", 1)
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        overrides[key] = val
    return overrides


def add_dtype_arg(parser):
    parser.add_argument(
        "--dtype", default=None, choices=["float32", "bfloat16"],
        help="compute dtype (model.dtype), over the config name's: "
             "bfloat16 computes with float32 parameters and BN statistics "
             "and a float32 soft-argmin; a name without _bf16 / _f32 means "
             "bfloat16 on a machine with a GPU and float32 without one")
    return parser


def config_overrides(args):
    """The tool's --override items, with --dtype as model.dtype."""
    overrides = parse_overrides(args.override)
    if args.dtype:
        overrides["model.dtype"] = args.dtype
    return overrides


def add_cpu_arg(parser):
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch versions on the CPU "
                             "(host times, not the card's)")
    return parser


def tool_device(args):
    """The measurement tools' device: the GPU, or the CPU with --cpu;
    without a GPU and without --cpu it raises (no fall-back). On the GPU
    TF32 is turned off, as init_model turns it off: float32 configs
    compute in float32."""
    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def device_label(device):
    """The name a measurement carries: the card's, or 'cpu'."""
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def timed_ms(fn, device):
    """(result of fn(), its milliseconds): CUDA events around the call on a
    GPU (the device's time from the first launch to the last, the host's
    work overlapped), the host clock on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    with torch.cuda.device(device):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
    return out, start.elapsed_time(end)
