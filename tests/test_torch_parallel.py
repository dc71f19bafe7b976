"""The port's data-parallel pieces against the JAX package's, on the CPU:
the launcher resolution, the sharded samplers and, in one 2-process gloo
group spawned here (tests/torch_parallel_ranks.py 'checks'), the
combination of eval shards (an empty shard included) through
tools/test.main, the differentiable ``global_sum``, a BatchNorm in
training over the global batch (biased running variance, gradients equal
to the one-process batch norm's), the PatchMatch training noise, and the
gradient all-reduce and module broadcast. Beside that group,
tools/train.main over two processes (``--launcher env``) against one
process at the doubled batch: StereoNet 8x 2-stage at full width in
float32 on 64x128 frames, 2 steps and a synthetic eval of 4 samples (the
counterpart of tests/parallel/test_multihost_cli.py).
"""

import json
import os

import numpy as np
import pytest
import torch

from densematchingbenchmark_tpu.data import sampler as jsampler
from densematchingbenchmark_tpu.parallel import distributed as jdist

from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.data import (SyntheticStereoDataset,
                                                   sampler, transforms)
from densematchingbenchmark_tpu_torch.evaluation import evaluate
from densematchingbenchmark_tpu_torch.evaluation.format import (
    combine_shard_metrics)
from densematchingbenchmark_tpu_torch.ops.patch_match import train_noise
from densematchingbenchmark_tpu_torch.parallel import (collectives,
                                                       distributed)
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.tools import test as ttest
from densematchingbenchmark_tpu_torch.utils.checkpoint import (
    CheckpointManager)

from test_torch_eval import SIZES, write_kitti_dataset
from torch_parallel_ranks import (RANKS, finish_ranks, free_port,
                                  start_ranks, tool_test_args)

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

TRAIN = ["-m", "densematchingbenchmark_tpu_torch.tools.train",
         "--config", "StereoNet/scene_flow_8x_2stage", "--cpu",
         "--synthetic", "--synthetic-shape", "64", "128",
         "--synthetic-length", "8", "--max-steps", "2",
         "--synthetic-eval", "4", "--log-interval", "1", "--seed", "0"]

# --- launcher resolution ---------------------------------------------------

LAUNCH_CASES = {
    "none": ("none", {}, {}),
    "none_flags": ("none", {}, dict(coordinator="h0:1234", num_processes=4,
                                    process_id=2)),
    "none_one_process": ("none", {}, dict(coordinator="h0:1234",
                                          num_processes=1, process_id=0)),
    "env": ("env", {"MASTER_ADDR": "worker-0", "MASTER_PORT": "29501",
                    "WORLD_SIZE": "8", "RANK": "3"}, {}),
    "env_one_process": ("env", {"MASTER_ADDR": "localhost",
                                "MASTER_PORT": "29501", "WORLD_SIZE": "1",
                                "RANK": "0"}, {}),
    "env_default_port": ("env", {"MASTER_ADDR": "w", "WORLD_SIZE": "2",
                                 "RANK": "1"}, {}),
    "env_flags": ("env", {"MASTER_ADDR": "worker-0", "WORLD_SIZE": "8",
                          "RANK": "3"},
                  dict(coordinator="elsewhere:1", process_id=0)),
    "slurm_range": ("slurm", {"SLURM_STEP_NODELIST": "host[003-007,010]",
                              "SLURM_NTASKS": "5", "SLURM_PROCID": "4"}, {}),
    "slurm_list": ("slurm", {"SLURM_NODELIST": "a,b", "SLURM_NTASKS": "2",
                             "SLURM_PROCID": "1"}, {}),
    "slurm_one_host": ("slurm", {"SLURM_STEP_NODELIST": "h",
                                 "SLURM_NTASKS": "1", "SLURM_PROCID": "0"},
                       dict(num_processes=2, process_id=1)),
}


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_resolve_launcher_matches_jax(case, monkeypatch):
    launcher, env, flags = LAUNCH_CASES[case]
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "SLURM_STEP_NODELIST", "SLURM_NODELIST", "SLURM_NTASKS",
                "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = jdist.resolve_launcher(launcher, port=29500, **flags)
    got = distributed.resolve_launcher(launcher, port=29500, **flags)
    if want is None:
        assert got is None
        return
    assert got == {"init_method": "tcp://" + want["coordinator_address"],
                   "world_size": want["num_processes"],
                   "rank": want["process_id"]}


@pytest.mark.parametrize("nodes", ["host[003-007,010]", "a,b", "h",
                                   "gpu[12,15-17]"])
def test_first_slurm_node_matches_jax(nodes):
    assert distributed._first_slurm_node(nodes) == \
        jdist._first_slurm_node(nodes)


def test_launcher_refusals(monkeypatch):
    with pytest.raises(ValueError, match="invalid launcher"):
        distributed.resolve_launcher("tpu")
    with pytest.raises(ValueError, match="rank"):       # no --process-id
        distributed.resolve_launcher("none", coordinator="h:1",
                                     num_processes=2)
    # a local rank past the visible GPUs raises, with no fall-back (and
    # before any process group starts)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(RuntimeError, match="local rank 3"):
        distributed.init_distributed(coordinator="localhost:1",
                                     num_processes=4, process_id=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.init_distributed(coordinator="localhost:1",
                                     num_processes=2, process_id=0)
    assert not collectives.in_group()
    assert distributed.init_distributed() == (0, 1)     # 'none': no group


def test_outside_a_group_every_collective_is_the_identity():
    collectives.reset_collective_counts()
    t = torch.arange(3.0)
    assert collectives.global_sum(t) is t
    assert collectives.global_count(t) is t
    grads = [t]
    assert collectives.all_reduce_grads(grads) is grads
    res = {"disp_0/epe": 1.5}
    assert combine_shard_metrics(res, 4) == (res, 4)
    g = torch.Generator().manual_seed(3)
    want = torch.rand((2, 3, 4, 5), generator=torch.Generator().manual_seed(3))
    assert torch.equal(train_noise(2, 3, 4, 5, g), want)
    assert set(collectives.collective_counts().values()) == {0}


# --- samplers --------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("grouped", [False, True])
def test_sharded_samplers_match_jax(shards, grouped):
    n, batch = 23, 8
    flags = (np.arange(n) % 3 == 0).astype(np.int64)
    whole = None
    for shard in range(shards):
        kw = dict(num_shards=shards, shard_id=shard, seed=5)
        if grouped:
            ours = sampler.GroupedEpochSampler(n, batch, flags, **kw)
            ref = jsampler.GroupedEpochSampler(n, batch, flags, **kw)
        else:
            ours = sampler.EpochSampler(n, batch, **kw)
            ref = jsampler.EpochSampler(n, batch, **kw)
        assert ours.steps_per_epoch() == ref.steps_per_epoch()
        for epoch in range(2):
            got = ours.epoch_indices(epoch)
            np.testing.assert_array_equal(got, ref.epoch_indices(epoch))
            assert got.shape == (ref.steps_per_epoch(), batch // shards)
        part = ours.epoch_indices(1)
        whole = part if whole is None else np.concatenate([whole, part], 1)
    # the shards of a step are the one-process batch of that step
    one = (sampler.GroupedEpochSampler(n, batch, flags, seed=5) if grouped
           else sampler.EpochSampler(n, batch, seed=5))
    np.testing.assert_array_equal(whole, one.epoch_indices(1))
    with pytest.raises(ValueError):
        sampler.EpochSampler(n, batch, num_shards=3)


# --- the 2-process group ---------------------------------------------------

@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The two ranks' check results, and tools/test.main's one-process
    results over the same three- and one-sample KITTI-layout sets."""
    root = str(tmp_path_factory.mktemp("kitti"))
    out = str(tmp_path_factory.mktemp("ranks"))
    ann3 = write_kitti_dataset(root, SIZES[:3])
    with open(ann3) as fp:
        items = json.load(fp)
    ann1 = os.path.join(root, "one.json")
    with open(ann1, "w") as fp:
        json.dump(items[:1], fp)
    port, train_port = free_port(3), free_port()
    argvs = [[RANKS, "checks", out, str(r), "2", str(port), root, ann1,
              ann3] for r in range(2)]
    envs = [None, None]
    # tools/train.main: one process at 2 samples, two at 1 each
    work = {k: str(tmp_path_factory.mktemp(k)) for k in ("one", "r0", "r1")}
    argvs.append(TRAIN + ["--work-dir", work["one"], "--override",
                          "model.dtype=float32",
                          "data.batch_size_per_device=2"])
    envs.append(None)
    for r in range(2):
        argvs.append(TRAIN + ["--work-dir", work[f"r{r}"], "--launcher",
                              "env", "--override", "model.dtype=float32"])
        envs.append({"MASTER_ADDR": "localhost",
                     "MASTER_PORT": str(train_port), "WORLD_SIZE": "2",
                     "RANK": str(r)})
    procs = start_ranks(argvs, envs)
    try:
        one = {name: ttest.main(tool_test_args(root, ann, str(
            tmp_path_factory.mktemp("work"))))
            for name, ann in (("three", ann3), ("one", ann1))}
    finally:
        finish_ranks(procs)
    ranks = [torch.load(os.path.join(out, f"checks{r}.pt"),
                        weights_only=False) for r in range(2)]
    return ranks, one, work


@pytest.mark.parametrize("name", ["three", "one"])
def test_test_tool_under_a_launcher_gives_the_one_process_table(group, name):
    """tools/test.main over two ranks: every rank returns the whole set's
    metrics (rank 1's shard of the one-sample set is empty), equal to the
    one-process run's up to float32 sums in another grouping."""
    ranks, one, _ = group
    want, n = one[name]
    assert n == {"three": 3, "one": 1}[name]
    for r in ranks:
        got, m = r[name]
        assert m == n and sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_combine_shard_metrics_over_two_ranks(group):
    ranks, _, _ = group
    for r in ranks:
        # rank 1's shard is empty ({}, 0): the union of keys, rank 0's
        # averages
        got, n = r["combined_empty"]
        assert n == 3 and got == pytest.approx(
            {"disp_0/epe": 2.0, "disp_0/3px": 10.0}, rel=1e-12)
        # (1 x 1.0 + 2 x 2.0) / 3 and 5.0
        got, n = r["combined"]
        assert n == 3 and got == pytest.approx(
            {"disp_0/epe": 5.0 / 3.0, "disp_1/epe": 5.0}, rel=1e-12)


def test_global_sum_and_its_gradient(group):
    ranks, _, _ = group
    for r in ranks:
        s, g = r["global_sum"]
        # [1, 2] + [1, 4]; the gradient of each rank's input is the sum of
        # both ranks' output gradients [1, 3]
        assert s.tolist() == [2.0, 6.0] and g.tolist() == [2.0, 6.0]


def test_batch_norm_takes_the_global_batch_statistics(group):
    """Over two ranks the port's BatchNorm normalises with the global
    batch's statistics, its gradients equal the one-process batch norm's
    of the global batch, and its running variance moves toward the biased
    variance (Flax's), not the unbiased one (torch.nn.SyncBatchNorm's)."""
    ranks, _, _ = group
    x = ranks[0]["bn"]["x"]
    dims = (0, 2, 3)
    biased = x.var(dims, unbiased=False)
    unbiased = x.var(dims, unbiased=True)
    for r in ranks:
        bn = r["bn"]
        torch.testing.assert_close(bn["y"], bn["ref_y"], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(bn["grad_x"], bn["ref_grad_x"],
                                   rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(bn["grad_w"], bn["ref_grad_w"],
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(bn["running_mean"],
                                   0.1 * x.mean(dims), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(bn["running_var"], 0.9 + 0.1 * biased,
                                   rtol=1e-6, atol=1e-6)
        # 120 values a channel: the unbiased variance is 1/119 larger
        assert (bn["running_var"] - (0.9 + 0.1 * unbiased)).abs().min() \
            > 1e-4


def test_training_noise_is_the_global_draws_rows(group):
    """Each rank keeps its rows of the global batch's draw, as JAX shards
    one global array drawn from one key."""
    ranks, _, _ = group
    want = torch.rand((4, 3, 4, 5),
                      generator=torch.Generator().manual_seed(3))
    for r, res in enumerate(ranks):
        assert torch.equal(res["noise"], want[2 * r:2 * r + 2])


def test_gradient_all_reduce_and_broadcast(group):
    ranks, _, _ = group
    for r in ranks:
        assert torch.equal(r["broadcast"], torch.zeros(2, 3))   # rank 0's
        a, b = r["grads"]
        assert torch.equal(a, torch.full((2, 2), 3.0))
        assert torch.equal(b, torch.full((3,), 2.0))
    # the same collectives, in the same number, on both ranks: 2 for the
    # combinations (all_gather of keys, all_reduce of sums), 1 for
    # global_sum, 1 its backward, 4 in the BatchNorm (2 forward, 2
    # backward), 1 for the BN weight's gradient, 1 for all_reduce_grads;
    # one broadcast a dtype of the module
    counts = [r["collectives"] for r in ranks]
    assert counts[0] == counts[1] == {"all_reduce": 10, "broadcast": 1,
                                      "all_gather": 2, "barrier": 0}


def records(work_dir):
    with open(os.path.join(work_dir, "metrics.log.json")) as fp:
        return [json.loads(line) for line in fp if line.strip()]


def test_train_tool_over_two_processes_matches_one(group):
    """tools/train.main over two processes at one sample each against one
    process at two. The first step's loss (the same weights; the global
    batch's BN statistics and masked means) within rtol 1e-5. The combined
    eval after the last step within rtol 1e-4 of one process's
    ``evaluate`` of the same weights (rank 0's checkpoint). Against the
    one-process run after RMSprop's first update: the last loss within
    rtol 1e-3 and the eval EPEs within rtol 1e-2, since there the one
    process's own float32 noise moves them by up to 1.8e-4 and 3.6e-3
    (the same run at 1, 2, 3 and 4 threads: tests/parallel_noise_study.py
    --cli). Rank 1 writes no metrics log."""
    work = group[2]
    one, two = records(work["one"]), records(work["r0"])
    assert not os.path.exists(os.path.join(work["r1"], "metrics.log.json"))
    losses = [[r["train/loss"] for r in recs if "train/loss" in r]
              for recs in (one, two)]
    assert len(losses[0]) == len(losses[1]) == 2
    np.testing.assert_allclose(losses[1][0], losses[0][0], rtol=1e-5)
    np.testing.assert_allclose(losses[1][1], losses[0][1], rtol=1e-3)
    evals = [{k[len("eval/"):]: v for k, v in
              [r for r in recs if "eval/disp_0/epe" in r][-1].items()
              if k.startswith("eval/")} for recs in (one, two)]
    assert sorted(evals[0]) == sorted(evals[1])

    # rank 0's weights after the last step, evaluated in this process
    cfg = get_config("StereoNet/scene_flow_8x_2stage_f32")
    maxd = cfg["model"]["max_disp"]
    data = cfg["data"]
    eval_ds = SyntheticStereoDataset(
        length=4, height=64, width=128, max_disp=min(maxd, 64), seed=7,
        transform=transforms.make_eval_transform((64, 128), data["mean"],
                                                 data["std"]))
    module = build_model(cfg)
    saved, meta = CheckpointManager(work["r0"]).restore()
    assert meta == {"epoch": 0, "batch_in_epoch": 2}
    module.load_state_dict(saved["module"])
    want, n = evaluate(module, eval_ds, cfg["model"].get(
        "eval", dict(lower_bound=0, upper_bound=maxd)),
        cfg["eval_disparity_id"])
    assert n == 4 and sorted(want) == sorted(evals[1])
    for k, v in want.items():
        np.testing.assert_allclose(evals[1][k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
        if k.endswith("epe"):
            np.testing.assert_allclose(evals[1][k], evals[0][k], rtol=1e-2,
                                       err_msg=k)
