"""Pieces the port's command-line tools share: dotted config overrides and
the compute dtype flag (the multi-process flags are
parallel.distributed.add_distributed_args)."""

import ast


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
