"""The float32 floor under the D-sharded grid's CPU test, and the float64
run that the test holds instead (a script, not a test):

    python tests/dsharding_noise_study.py [FAMILY ...]

For each family of tests/torch_dsharding_ranks.py (all by default), the
gradients of one train step at the global batch (the rank's 'grads'),
each against the one process's in the same dtype, as the largest
difference over the largest gradient and the relative L2 norm of the
difference:

- float32, one process from weights scaled by (1 + 1e-7 N(0, 1)), three
  draws: the floor that float32 reordering alone reaches;
- float32 and float64, the (2, 1), (1, 2) and (2, 2) grids of gloo
  processes (tests/test_torch_dsharding.py's grid is (2, 2)).

Also runnable as one rank of a grid:

    python tests/dsharding_noise_study.py rank OUT_DIR RANK WORLD PORT N_DATA N_MODEL DTYPE FAMILY ...
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dsharding_ranks as ranks  # noqa: E402
from torch_parallel_ranks import (finish_ranks, free_port,  # noqa: E402
                                  start_ranks)
from densematchingbenchmark_tpu_torch.parallel import (  # noqa: E402
    init_distributed, make_mesh, shutdown_distributed)

DTYPES = {"float32": torch.float32, "float64": torch.float64}
GRIDS = ((2, 1), (1, 2), (2, 2))


def rank_main(out_dir, rank, world, port, n_data, n_model, dtype, families):
    if world > 1:
        init_distributed(coordinator=f"localhost:{port}",
                         num_processes=world, process_id=rank, device="cpu")
    mesh = make_mesh((n_data, n_model))
    grads = {f: ranks.family_case(f, mesh, DTYPES[dtype])["grads"]
             for f in families}
    shutdown_distributed()
    torch.save(grads, os.path.join(out_dir, f"r{rank}.pt"))


def errors(got, want):
    top = max(float(g.abs().max()) for g in want.values())
    norm = sum(float(g.double().square().sum()) for g in want.values())
    diff = {n: got[n].double() - g.double() for n, g in want.items()}
    return (max(float(d.abs().max()) for d in diff.values()) / top,
            (sum(float(d.square().sum()) for d in diff.values())
             / norm) ** 0.5)


def grid_grads(out_dir, shape, dtype, families):
    world = shape[0] * shape[1]
    port = free_port()
    finish_ranks(start_ranks([[os.path.abspath(__file__), "rank", out_dir,
                               str(r), str(world), str(port),
                               str(shape[0]), str(shape[1]), dtype,
                               *families] for r in range(world)]))
    return torch.load(os.path.join(out_dir, "r0.pt"), weights_only=False)


def main(families):
    import tempfile
    torch.set_num_threads(1)
    one_mesh = make_mesh()
    for family in families:
        ref = {d: ranks.family_case(family, one_mesh, t)["grads"]
               for d, t in DTYPES.items()}
        for seed in range(3):
            got = ranks.family_case(family, one_mesh, torch.float32,
                                    perturb_seed=seed)["grads"]
            print(f"{family} float32 weights x (1 + 1e-7 N), draw {seed}: "
                  "max/top %.3g, rel L2 %.3g" % errors(got, ref["float32"]))
        for dtype in DTYPES:
            for shape in GRIDS:
                with tempfile.TemporaryDirectory() as out:
                    got = grid_grads(out, shape, dtype, [family])[family]
                print(f"{family} {dtype} grid {shape} vs one process: "
                      "max/top %.3g, rel L2 %.3g" % errors(got, ref[dtype]))


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank"]:
        out, rank, world, port, nd, nm, dtype = sys.argv[2:9]
        torch.set_num_threads(1)
        rank_main(out, int(rank), int(world), int(port), int(nd), int(nm),
                  dtype, sys.argv[9:])
    else:
        main(sys.argv[1:] or list(ranks.FAMILIES))
