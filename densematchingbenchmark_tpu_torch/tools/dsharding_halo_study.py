"""The D-sharded cost volume's collective bytes against the compute it
saves: a model at a stated link rate, not a measured multi-GPU speed.

    python -m densematchingbenchmark_tpu_torch.tools.dsharding_halo_study \\
        [--n-model 4] [--max-disp 192] [--height 96 --width 312] \\
        [--compute-ms MS] [--link-gbps 450] [--cpu]

Counterpart of the repository's tools/dsharding_halo_study.py:1-124, for
PSMNet's aggregator (PSMAggregator, 64 raw channels, float32, its low
resolution costs) at the feature shape of a 384x1248 frame, [1, max_disp
/ 4, 96, 312, 64], with its volume split along D over a (1, n_model)
grid:

1. the collectives a forward runs, read from a real forward on each rank
   of the grid (parallel/collectives: ``collective_counts()``,
   ``collective_bytes()``, ``d_axis_counts()``), where JAX reads them from
   the compiled HLO. The ranks are gloo processes sharing the GPU (NCCL
   refuses two ranks on one GPU), or on the CPU with ``--cpu``;
2. the one-process forward of the same aggregator on the whole volume,
   measured here (CUDA events, the median of 5 after a warm-up; the host
   clock with ``--cpu``), unless ``--compute-ms`` gives it;
3. the bytes a rank receives, (n_model - 1) times the bytes it hands each
   all-gather (every rank hands the same), over ``--link-gbps``.

D-sharding pays where the compute a rank saves, compute_ms * (1 - 1 /
n_model), exceeds that transfer time; the break-even link rate is the
bytes over the saved time. The port's trunk layout has no ``pack``, a TPU
schedule (JAX's ``--pack``). The card's name and power limit print first,
JAX's JSON keys on the last line (``break_even_link_gbps`` for its
``break_even_ici_gbps``). ``main(argv)`` returns the record.
"""

import argparse
import json
import os
import socket
import tempfile

import numpy as np
import torch

from ..utils.collect_env import card_line
from .common import add_cpu_arg, device_label, timed_ms, tool_device

# H100 SXM: NVLink 4, 900 GB/s a GPU in both directions together (NVIDIA's
# H100 Tensor Core GPU data sheet), 450 GB/s in one
NVLINK_GBPS = 450.0
CHANNELS = 64          # the concatenation volume's: 2 x 32 features


def aggregator(max_disp, mesh=None):
    """PSMNet's aggregator (low resolution costs), seeded, in eval; its
    volume split along D over ``mesh``'s model axis when given."""
    from ..models.aggregators.psmnet import PSMAggregator
    from ..models.layers import init_parameters
    from ..parallel.mesh import (batch_only_volume_sharding,
                                 cost_volume_sharding)
    kw = {}
    if mesh is not None:
        kw = dict(volume_sharding=cost_volume_sharding(mesh),
                  strided_sharding=batch_only_volume_sharding(mesh))
    agg = PSMAggregator(CHANNELS, max_disp, return_low_res=True, **kw)
    init_parameters(agg, torch.Generator().manual_seed(0))
    return agg.eval()


def raw_volume(max_disp, height, width):
    """The seeded raw volume [1, max_disp / 4, H, W, 64], on the host."""
    g = torch.Generator().manual_seed(1)
    return torch.randn((1, max_disp // 4, height, width, CHANNELS),
                       generator=g)


def _rank(rank, world, port, max_disp, height, width, device, out_dir):
    """One rank of the (1, world) grid: a forward on its planes of D;
    writes its collectives."""
    from ..parallel import (collective_bytes, collective_counts,
                            d_axis_counts, init_distributed, make_mesh,
                            reset_collective_counts, shutdown_distributed)
    from ..parallel.collectives import d_planes
    torch.set_num_threads(1)
    init_distributed(coordinator=f"localhost:{port}", num_processes=world,
                     process_id=rank, device=device, backend="gloo")
    mesh = make_mesh((1, world))
    raw = raw_volume(max_disp, height, width)
    lo, hi = d_planes(raw.shape[1], mesh)
    planes = raw[:, lo:hi].contiguous().to(device)
    agg = aggregator(max_disp, mesh).to(device)
    reset_collective_counts()
    with torch.inference_mode():
        agg(planes, size=raw.shape[1])
    torch.save({"counts": collective_counts(), "bytes": collective_bytes(),
                "d_axis": d_axis_counts()},
               os.path.join(out_dir, f"rank{rank}.pt"))
    shutdown_distributed()


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def grid_collectives(n, max_disp, height, width, device):
    """Each rank's {'counts', 'bytes', 'd_axis'} of one forward on a (1, n)
    grid of gloo processes on ``device``."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out:
        mp.start_processes(_rank, args=(n, free_port(), max_disp, height,
                                        width, str(device), out),
                           nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(out, f"rank{r}.pt"))
                for r in range(n)]


def compute_ms(max_disp, height, width, device, reps=5):
    """The one-process forward on the whole volume, ms: the median of
    ``reps`` after a warm-up."""
    agg = aggregator(max_disp).to(device)
    raw = raw_volume(max_disp, height, width).to(device)
    with torch.inference_mode():
        agg(raw)
        times = [timed_ms(lambda: agg(raw), device)[1] for _ in range(reps)]
    return float(np.median(times))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-model", type=int, default=4)
    p.add_argument("--max-disp", type=int, default=192)
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--width", type=int, default=312,
                   help="feature-scale H, W (384x1248 image -> 96x312)")
    p.add_argument("--compute-ms", type=float, default=None,
                   help="the one-process aggregator forward, ms (default: "
                        "measured here)")
    p.add_argument("--link-gbps", type=float, default=NVLINK_GBPS,
                   help="GB/s one way between two GPUs (default: H100 SXM "
                        "NVLink 4, 900 GB/s both ways, NVIDIA's H100 data "
                        "sheet)")
    add_cpu_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args)
    print(card_line())
    n = args.n_model
    if n < 2:
        raise ValueError("--n-model must be 2 or more: D splits over the "
                         "model ranks")
    ranks = grid_collectives(n, args.max_disp, args.height, args.width,
                             device)
    if any(r != ranks[0] for r in ranks[1:]):
        raise RuntimeError(f"the ranks ran different collectives: {ranks}")
    counts, handed, d_axis = (ranks[0][k] for k in ("counts", "bytes",
                                                    "d_axis"))
    print(f"a forward's collectives a rank: {counts}; bytes handed "
          f"{handed}; D-axis {d_axis}")
    measured = args.compute_ms is None
    single = (compute_ms(args.max_disp, args.height, args.width, device)
              if measured else args.compute_ms)
    received = (n - 1) * handed["all_gather"]
    xfer_ms = received / (args.link_gbps * 1e9) * 1e3
    saved_ms = single * (1 - 1 / n)
    out = {
        "n_model": n,
        "shape": [1, args.max_disp // 4, args.height, args.width, CHANNELS],
        "collective_counts": counts,
        "collective_bytes": handed,
        "d_axis_counts": d_axis,
        "gather_bytes_mib": received / 2 ** 20,
        "link_gbps": args.link_gbps,
        "modeled_transfer_ms": xfer_ms,
        "single_chip_compute_ms": single,
        "compute_measured_on": device_label(device) if measured else None,
        "compute_saved_ms": saved_ms,
        "d_sharding_wins": bool(saved_ms > xfer_ms),
        "break_even_link_gbps": (received / (saved_ms * 1e-3) / 1e9
                                 if saved_ms > 0 else None),
        "note": "a model at the stated link rate, not a measured "
                "multi-GPU speed",
    }
    print(f"model, not a measured multi-GPU speed: a rank receives "
          f"{received / 2 ** 20:.1f} MiB a forward, {xfer_ms:.3f} ms at "
          f"{args.link_gbps} GB/s; the one-process forward "
          f"{single:.3f} ms ({'measured on ' + device_label(device) if measured else 'given'}), "
          f"{saved_ms:.3f} ms saved on {n} ranks; break-even at "
          f"{out['break_even_link_gbps']} GB/s")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
