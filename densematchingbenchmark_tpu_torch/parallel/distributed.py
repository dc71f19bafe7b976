"""Multi-process launch: one process per device, joined by
``torch.distributed``.

Counterpart of densematchingbenchmark_tpu/parallel/distributed.py:32-125.
The launcher only decides where the rendezvous address, the process count
and the process's rank come from:

  'env'   -- MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, as ``torchrun``
             sets them;
  'slurm' -- SLURM_PROCID / SLURM_NTASKS / SLURM_STEP_NODELIST, the
             rendezvous on the first node of the allocation;
  'none'  -- one process (the default): no process group.

The explicit ``--coordinator`` / ``--num-processes`` / ``--process-id``
flags override what the launcher gives. JAX's 'tpu' launcher (Cloud TPU
metadata) has no meaning on a GPU and is not offered.

Each rank runs on one device: ``cuda:<local rank>`` (LOCAL_RANK, else
SLURM_LOCALID, else the rank) unless the caller names one, over NCCL on a
GPU and over gloo on the CPU. ``backend`` overrides that choice (gloo with
CUDA tensors runs several ranks on one card, which NCCL refuses). Nothing
falls back: a local rank past the visible GPUs, or a CUDA device without
CUDA, raises.
"""

import logging
import os
import re

import torch
import torch.distributed as dist

from .mesh import forget_mesh

log = logging.getLogger("dmb_torch")

_device = None       # the rank's device, while this module's group is up


def _first_slurm_node(node_list):
    """First hostname of a SLURM nodelist without scontrol: 'host1,host2',
    'prefix[003-007,010]' and a plain 'host'."""
    m = re.match(r"([^,\[]+)(\[([^\]]+)\])?", node_list)
    prefix, bracket = m.group(1), m.group(3)
    if not bracket:
        return prefix
    return prefix + re.split(r"[,-]", bracket)[0]


def resolve_launcher(launcher, coordinator=None, num_processes=None,
                     process_id=None, port=29500):
    """``init_process_group`` arguments (init_method 'tcp://HOST:PORT',
    world_size, rank) of the launcher, or None when no process group
    should start (launcher 'none' and one process)."""
    kw = {}
    if launcher in ("none", None):
        if coordinator is None and num_processes is None:
            return None
    elif launcher == "env":
        addr = os.environ["MASTER_ADDR"]
        env_port = os.environ.get("MASTER_PORT", str(port))
        kw = dict(address=f"{addr}:{env_port}",
                  world_size=int(os.environ["WORLD_SIZE"]),
                  rank=int(os.environ["RANK"]))
    elif launcher == "slurm":
        node_list = os.environ.get("SLURM_STEP_NODELIST",
                                   os.environ.get("SLURM_NODELIST"))
        kw = dict(address=f"{_first_slurm_node(node_list)}:{port}",
                  world_size=int(os.environ["SLURM_NTASKS"]),
                  rank=int(os.environ["SLURM_PROCID"]))
    else:
        raise ValueError(f"invalid launcher {launcher!r} "
                         "(expected none|env|slurm)")
    if coordinator is not None:
        kw["address"] = coordinator
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    if launcher in ("none", None) and kw.get("world_size", 1) == 1:
        return None
    missing = {"address", "world_size", "rank"} - set(kw)
    if missing:
        raise ValueError(f"launcher {launcher!r} lacks "
                         f"{', '.join(sorted(missing))}: pass --coordinator "
                         "HOST:PORT, --num-processes and --process-id")
    return dict(init_method="tcp://" + kw.pop("address"), **kw)


def _local_rank(rank):
    for var in ("LOCAL_RANK", "SLURM_LOCALID"):
        if var in os.environ:
            return int(os.environ[var])
    return rank


def init_distributed(launcher="none", coordinator=None, num_processes=None,
                     process_id=None, port=29500, device=None, backend=None):
    """Join this process to its group; returns (rank, world_size), (0, 1)
    when the launcher starts none.

    ``device``: the rank's device ('cpu', 'cuda:1', ...), by default
    ``cuda:<local rank>``. ``backend``: by default 'nccl' for a CUDA device
    and 'gloo' for the CPU. The device is made current before the first
    collective, and ``rank_device()`` gives it to the entry points."""
    global _device
    kw = resolve_launcher(launcher, coordinator, num_processes, process_id,
                          port)
    if kw is None:
        return 0, 1
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    if device is None:
        device = torch.device("cuda", _local_rank(kw["rank"]))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --cpu to run the "
                               "ranks on the CPU over gloo")
        index = 0 if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {kw['rank']}: local rank {index} but only "
                f"{torch.cuda.device_count()} visible GPU(s)")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        kw["device_id"] = device      # NCCL's collectives bind to it
    dist.init_process_group(backend, **kw)
    _device = device
    log.info("process group: rank %d of %d on %s over %s", kw["rank"],
             kw["world_size"], device, backend)
    return dist.get_rank(), dist.get_world_size()


def rank_device():
    """The device ``init_distributed`` gave this rank, or None outside a
    group it started."""
    return _device if dist.is_available() and dist.is_initialized() \
        else None


def shutdown_distributed():
    """Leave the process group, if any (so that a later run in the same
    process can start its own)."""
    global _device
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _device = None
    forget_mesh()


def add_distributed_args(parser):
    """The multi-process flags of the command-line tools."""
    g = parser.add_argument_group("distributed")
    g.add_argument("--launcher", default="none",
                   choices=["none", "env", "slurm"],
                   help="where the process group's address, size and rank "
                        "come from: torchrun's environment ('env'), SLURM "
                        "('slurm') or one process ('none')")
    g.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address (overrides the launcher's)")
    g.add_argument("--num-processes", type=int, default=None)
    g.add_argument("--process-id", type=int, default=None)
    return parser


def init_from_args(args):
    """``init_distributed`` from a tool's parsed flags, on the CPU over
    gloo with ``--cpu``: returns (rank, world_size)."""
    return init_distributed(args.launcher, args.coordinator,
                            args.num_processes, args.process_id,
                            device="cpu" if args.cpu else None)
