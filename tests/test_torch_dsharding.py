"""The D-sharded cost volume on a (data, model) grid of gloo processes on
the CPU (tests/torch_dsharding_ranks.py runs the ranks):

(a) the port's PSMAggregator with its raw volume split along D over a
    (2, 2) grid against JAX's, sharded the same way on a (2, 2) mesh of
    virtual CPU devices (JAX's test_packed_psm_aggregator_under_d_sharding
    at pack 0), on the same weights, in eval: JAX's tolerance, 1e-4;
(b) four ranks as a (2, 2) grid against the port's one process at the
    global batch: one eval forward and one train step of PSMNet, AcfNet,
    GCNet and StereoNet (their volumes split along D) and AnyNet (run
    whole on every model rank), in float64; the raw volume's planes each
    rank builds; train_matcher with ``use_volume_sharding`` (float32).
    The cases run in two groups of four ranks side by side (GRID_PARTS);
(c) halo_exchange, gather_d and shard_d over three ranks, D = 8 split
    3, 3, 2, against their dense counterparts, forward and backward.

(b) runs in float64 because float32 cannot tell a fault from noise at
these sizes: the tiny models amplify float32's reordering noise (a BN
sum over other planes, the group's two-pass BN) to 1e-3 - 2e-2 of their
largest gradient, as a 1e-7 perturbation of their weights does
(tests/dsharding_noise_study.py). In float64 the grid's gradients,
losses and statistics agree with the one process's to about 1e-13, far
inside test_torch_parallel_train.py's GRAD_TOL, which is why they are
held to F64_TOL; a factor of n_model, a lost halo gradient or a mean
over the wrong count is off by orders more.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.models.aggregators.psmnet import (
    PSMAggregator as JPSMAggregator)
from densematchingbenchmark_tpu.parallel import make_mesh as jmake_mesh
from densematchingbenchmark_tpu.parallel import replicated as jreplicated
from densematchingbenchmark_tpu.parallel.mesh import (
    batch_only_volume_sharding as jbatch_only,
    cost_volume_sharding as jcost_volume)

from densematchingbenchmark_tpu_torch.ops.cost_volume import (
    cat_volume, correlation1d_volume, dif_volume)
from densematchingbenchmark_tpu_torch.parallel.collectives import d_bounds

from torch_dsharding_ranks import (AGG_MAX_DISP, EVAL_LEN, FAMILIES, GRID,
                                   agg_input, psm_aggregator)
from torch_parallel_ranks import finish_ranks, free_port, start_ranks

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dsharding_ranks.py")
WORLD = GRID[0] * GRID[1]
# float64: the grid against the one process, of the largest value
# (measured: gradients within 2e-13 of the largest, GCNet's; the others
# 3e-15 - 2.5e-14)
F64_TOL = 1e-10
# the D-axis collectives a train step and an eval forward run on a rank:
# PSMNet and AcfNet a halo for each of the 4 dres units and the 3 Co=1
# classify convs, a gather of the dres output and one of the three costs;
# GCNet a gather of the raw volume; StereoNet a halo for each of its 4
# units and its Co=1 conv, a gather of the cost; AnyNet none
D_OPS = {"psmnet": (7, 2), "acfnet": (7, 2), "gcnet": (0, 1),
         "stereonet": (5, 1), "anynet": (0, 0)}


def jax_sharded_costs():
    """JAX's PSMAggregator (pack 0, low-res costs) on the (2, 2) mesh with
    the two shardings models/builder.py wires, jitted once, on the port's
    weights."""
    _, variables = psm_aggregator()
    mesh = jmake_mesh(GRID)
    agg = JPSMAggregator(max_disp=AGG_MAX_DISP, batch_norm=True, pack=0,
                         return_low_res=True,
                         strided_sharding=jbatch_only(mesh),
                         volume_sharding=jcost_volume(mesh))
    sharding = jcost_volume(mesh)

    @jax.jit
    def sharded(v, x):
        x = jax.lax.with_sharding_constraint(x, sharding)
        return agg.apply(v, x, train=False)

    got = sharded(jax.device_put(variables, jreplicated(mesh)),
                  jnp.asarray(agg_input()))
    return [np.asarray(c) for c in got]


# the grid's cases in two groups of four ranks, run side by side: a rank
# waits on gloo's latency (a BatchNorm in training runs four collectives)
# far longer than it computes
GRID_PARTS = (("aggregator", "planes", "psmnet", "gcnet", "anynet"),
              ("acfnet", "stereonet", "train_matcher"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn at once (the grid's two groups, its one-process
    reference, the collectives' three ranks), JAX's sharded aggregator
    meanwhile."""
    out = {k: str(tmp_path_factory.mktemp(k))
           for k in ("grid0", "grid1", "one", "coll")}
    argvs = [[SCRIPT, "grid", out["one"], "0", "1", "0"]]
    for i, cases in enumerate(GRID_PARTS):
        port = free_port()
        argvs += [[SCRIPT, "grid", out[f"grid{i}"], str(r), str(WORLD),
                   str(port), *cases] for r in range(WORLD)]
    port = free_port()
    argvs += [[SCRIPT, "collectives", out["coll"], str(r), "3", str(port)]
              for r in range(3)]
    procs = start_ranks(argvs)
    try:
        jax_costs = jax_sharded_costs()
    finally:
        finish_ranks(procs, timeout=240)
    load = lambda d, name: torch.load(os.path.join(d, name),  # noqa: E731
                                      weights_only=False)
    grid = [load(out["grid0"], f"grid{r}.pt") for r in range(WORLD)]
    for r in range(WORLD):
        grid[r].update(load(out["grid1"], f"grid{r}.pt"))
    return {"jax": jax_costs, "grid": grid,
            "one": load(out["one"], "grid0.pt"),
            "coll": [load(out["coll"], f"coll{r}.pt") for r in range(3)]}


def rows(x, data_index):
    per = x.shape[0] // GRID[0]
    return x[data_index * per:(data_index + 1) * per]


def test_sharded_psm_aggregator_matches_jax(runs):
    for r, res in enumerate(runs["grid"]):
        d, m = res["mesh"]
        assert (d, m) == divmod(r, GRID[1])
        got = res["aggregator"]
        assert len(got["costs"]) == len(runs["jax"]) == 3
        for c, want in zip(got["costs"], runs["jax"]):
            np.testing.assert_allclose(c.numpy(), rows(want, d), rtol=1e-4,
                                       atol=1e-4)
        # the 4 dres halos and 3 classify-conv halos, 2 gathers
        assert got["counts"]["d_axis"] == {
            "halo_exchange": 7, "halo_exchange_backward": 0,
            "gather_d": 2, "gather_d_backward": 0}, got["counts"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_grid_matches_one_process(runs, family):
    one, grid = runs["one"][family], [r[family] for r in runs["grid"]]
    losses = [k for k in one["metrics"] if k != "grad_norm"]
    assert "loss" in losses and len(losses) > 1
    top = max(float(g.abs().max()) for g in one["grads"].values())
    for r, res in enumerate(grid):
        d = r // GRID[1]
        assert sorted(res["metrics"]) == sorted(one["metrics"])
        # every rank logs the global batch's values
        for k in losses:
            np.testing.assert_allclose(res["metrics"][k], one["metrics"][k],
                                       rtol=F64_TOL, err_msg=k)
        # the world's summed gradient is the global loss's
        for k, g in one["grads"].items():
            err = float((res["grads"][k] - g).abs().max())
            assert err <= F64_TOL * top, (k, err / top)
        for k, b in one["buffers"].items():
            if b.is_floating_point():
                scale = float(b.abs().max()) or 1.0
                torch.testing.assert_close(res["buffers"][k], b, rtol=0,
                                           atol=F64_TOL * scale, msg=k)
            else:
                assert torch.equal(res["buffers"][k], b), k
        for got, want in zip(res["disps"], one["disps"], strict=True):
            torch.testing.assert_close(got, rows(want, d), rtol=0,
                                       atol=F64_TOL * float(want.abs().max()))
    # the optimizer stepped identically on all four ranks
    for res in grid[1:]:
        for k, p in grid[0]["params"].items():
            assert torch.equal(p, res["params"][k]), k
    # the same collectives on every rank; the D-axis ones as laid out
    halos, gathers = D_OPS[family]
    for res in grid:
        assert res["train_counts"] == grid[0]["train_counts"]
        assert res["eval_counts"] == grid[0]["eval_counts"]
        assert res["train_counts"]["d_axis"] == {
            "halo_exchange": halos, "halo_exchange_backward": halos,
            "gather_d": gathers, "gather_d_backward": gathers}
        assert res["eval_counts"]["d_axis"] == {
            "halo_exchange": halos, "halo_exchange_backward": 0,
            "gather_d": gathers, "gather_d_backward": 0}
        assert res["train_counts"]["kinds"]["all_gather"] == 2 * halos \
            + gathers
        assert res["eval_counts"]["kinds"] == {
            "all_reduce": 0, "broadcast": 0, "all_gather": halos + gathers,
            "barrier": 0}
    assert set(runs["one"][family]["train_counts"]["kinds"].values()) == {0}


def test_each_model_rank_builds_its_planes(runs):
    """The cost processor builds only the rank's planes of the raw volume
    (a model's train and eval forwards; ranges that start away from 0,
    one dilated), the same planes as the whole volume's."""
    for family in ("psmnet", "acfnet", "gcnet", "stereonet"):
        whole = runs["one"][family]["raw_shapes"]
        assert len(whole) == 2       # the train and the eval forward
        for r, res in enumerate(runs["grid"]):
            lo, hi = d_bounds(whole[0][1], GRID[1])[r % GRID[1]]
            for got, want in zip(res[family]["raw_shapes"], whole,
                                 strict=True):
                assert got == (want[0] // GRID[0], hi - lo, *want[2:])
    assert runs["grid"][0]["anynet"]["raw_shapes"] == []
    g = torch.Generator().manual_seed(5)
    ref, tgt = torch.randn(2, 1, 3, 12, 4, generator=g)
    volumes = {"concatenation": cat_volume, "difference": dif_volume,
               "correlation": lambda *a: correlation1d_volume(*a)[..., None]}
    for r, res in enumerate(runs["grid"]):
        for (kind, rng), (raw, size) in res["planes"].items():
            full = volumes[kind](ref, tgt, *rng)
            assert size == full.shape[1]
            lo, hi = d_bounds(size, GRID[1])[r % GRID[1]]
            assert torch.equal(raw, full[:, lo:hi]), (kind, rng)


def test_train_matcher_on_the_grid(runs):
    one = runs["one"]["train_matcher"]
    grid = [r["train_matcher"] for r in runs["grid"]]
    assert grid[0]["mesh_logged"] and one["mesh_logged"]
    # each eval sample counted once, not once a model rank
    assert grid[0]["eval_samples"] == one["eval_samples"] == [EVAL_LEN]
    got, want = grid[0]["records"], one["records"]
    assert len(got) == len(want) == 2      # the step, the eval
    for k, v in want[0].items():
        if k.startswith("train/") and "loss" in k:
            np.testing.assert_allclose(got[0][k], v, rtol=1e-5, err_msg=k)
    evals = [k for k in want[1] if k.startswith("eval/")]
    assert evals
    for k in evals:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for r, res in enumerate(grid):
        # the model ranks of a data index run the same collectives (the
        # data indices' eval shards may hold different batches); the
        # step's backward once
        partner = grid[r ^ 1]["counts"]["d_axis"]
        assert res["counts"]["d_axis"] == partner
        assert res["counts"]["d_axis"]["gather_d_backward"] == 1
        assert res["counts"]["d_axis"]["halo_exchange_backward"] == 5


@pytest.mark.parametrize("case", ["halo1", "halo2", "gather", "shard"])
def test_d_collectives_on_an_uneven_split(runs, case):
    for r, res in enumerate(runs["coll"]):
        assert res["bounds"] == [(0, 3), (3, 6), (6, 8)]
        y, dense_y, gx, dense_gx = res[case]
        torch.testing.assert_close(y, dense_y, rtol=0, atol=0)
        torch.testing.assert_close(gx, dense_gx, rtol=1e-6, atol=1e-6)
        d_axis = res["counts"]["d_axis"]
        assert d_axis == {"halo_exchange": 2, "halo_exchange_backward": 2,
                          "gather_d": 1, "gather_d_backward": 1}
        # halos: 2 width planes of [2, 3, 2, 4] float32 sent each way per
        # call; the gather 3 planes (padded); its backward the whole
        plane = 2 * 3 * 2 * 4 * 4
        assert res["counts"]["bytes"]["all_gather"] == \
            2 * (2 * 1 + 2 * 2) * plane + 3 * plane
        assert res["counts"]["bytes"]["all_reduce"] == 8 * plane


def test_mesh_outside_a_group():
    """One process is the grid (1, 1), whose shardings split nothing; a
    shape that does not cover the group raises."""
    from densematchingbenchmark_tpu_torch.parallel import (
        batch_only_volume_sharding, cost_volume_sharding, make_mesh)
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert (mesh.data_index, mesh.model_index) == (0, 0)
    assert mesh.model_group is None and mesh.data_group is None
    assert not cost_volume_sharding(mesh).splits_d
    assert not batch_only_volume_sharding(mesh).splits_d
    with pytest.raises(ValueError, match="cover the group"):
        make_mesh((2, 1))


@pytest.mark.parametrize("rank", range(4))
def test_shard_batch_and_shardings_on_a_grid(rank):
    """Rank r of a (2, 2) grid: data index r // 2, model index r % 2 (JAX's
    row-major reshape); its rows of a batch are its data index's; the
    cost-volume sharding splits D, the others do not."""
    from densematchingbenchmark_tpu_torch.parallel.mesh import (
        Mesh, batch_only_volume_sharding, batch_sharding,
        cost_volume_sharding, replicated, shard_batch)
    mesh = Mesh(2, 2, rank)
    assert (mesh.data_index, mesh.model_index) == divmod(rank, 2)
    batch = {"x": np.arange(8).reshape(4, 2), "y": torch.arange(4)}
    got = shard_batch(mesh, batch)
    d = rank // 2
    np.testing.assert_array_equal(got["x"], batch["x"][2 * d:2 * d + 2])
    assert torch.equal(got["y"], batch["y"][2 * d:2 * d + 2])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(mesh, {"x": np.zeros(3)})
    assert cost_volume_sharding(mesh).splits_d
    assert cost_volume_sharding(mesh).spec == ("data", "model")
    assert not batch_only_volume_sharding(mesh).splits_d
    assert batch_sharding(mesh).spec == ("data",)
    assert replicated(mesh).spec == ()


@pytest.mark.parametrize("size,n", [(8, 3), (48, 2), (7, 4), (5, 5)])
def test_d_bounds_split_as_tensor_split(size, n):
    parts = torch.tensor_split(torch.arange(size), n)
    assert d_bounds(size, n) == [(int(p[0]), int(p[-1]) + 1) for p in parts]


def test_d_bounds_refuse_a_rank_without_planes():
    with pytest.raises(ValueError, match="leaves a rank no plane"):
        d_bounds(2, 3)
