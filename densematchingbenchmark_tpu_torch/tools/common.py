"""Pieces the port's command-line tools share: dotted config overrides and
the JAX tools' ``--launcher`` flag, of which only the one-process value is
ported."""

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


def add_distributed_args(parser):
    parser.add_argument("--launcher", default="none",
                        choices=["none", "env", "slurm"],
                        help="multi-process init source; only 'none' (one "
                             "process) is ported")
    return parser


def check_launcher(args):
    if args.launcher != "none":
        raise NotImplementedError(
            f"--launcher {args.launcher}: multi-process runs are not ported "
            "yet (ROADMAP.md queue 1 item 5)")
