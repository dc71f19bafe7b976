"""The port's evaluation slice against the JAX package, on the CPU: warps,
metrics, the evaluation loop on a file dataset, and the test, train and
demo tools end to end.

The evaluation loop runs PSMNet at a tiny config (max_disp 16) over a tiny
KITTI-2015-layout dataset of mixed frame sizes padded to 32x64, written
with the port's own PNG writers, on weights carried from JAX (every
BatchNorm's statistics random) by ``load_jax_variables``. The JAX side
compiles once per batch shape in one module-scoped fixture. Tolerances:
1e-5 on warps and metrics of the same inputs (float32, another order of
sums); 1e-3 px on EPE through the model (float32 rounding amplified by
soft-argmin), and n-px shares exactly equal at the same batch size (1e-6
relative between batch sizes, whose float32 per-batch sums group the
samples differently).
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.configs import get_config as jget_config
from densematchingbenchmark_tpu.data import build_dataset as jbuild_dataset
from densematchingbenchmark_tpu.data import transforms as jtransforms
from densematchingbenchmark_tpu.evaluation import eval_loop as jeval_loop
from densematchingbenchmark_tpu.evaluation import metrics as jmetrics
from densematchingbenchmark_tpu.models import build_model as jbuild_model
from densematchingbenchmark_tpu.ops import warp as jwarp

from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.data import (SyntheticStereoDataset,
                                                   build_dataset, io,
                                                   transforms)
from densematchingbenchmark_tpu_torch.evaluation import eval_loop, metrics
from densematchingbenchmark_tpu_torch.evaluation.format import (
    combine_shard_metrics)
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.ops import warp
from densematchingbenchmark_tpu_torch.tools import demo as tdemo
from densematchingbenchmark_tpu_torch.tools import test as ttest
from densematchingbenchmark_tpu_torch.tools import train as ttrain
from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

M = 16
TINY = {"model.max_disp": M,
        "model.cost_processor.cost_computation.max_disp": M // 4,
        "model.cost_processor.cost_aggregator.max_disp": M,
        "model.disp_predictor.max_disp": M,
        "model.losses.l1_loss.max_disp": M,
        "model.eval.upper_bound": M}
PAD = (32, 64)
# KITTI-style mixed frame sizes, all padded to PAD
SIZES = ((30, 60), (32, 64), (28, 50), (31, 62))


def write_kitti_dataset(root, sizes, max_disp=12):
    """KITTI-2015-layout files (RGB PNGs, uint16 disparity PNGs, right
    disparities, an annotation JSON) from SyntheticStereoDataset, written
    with the port's writers, each pair with another PNG row filter.
    Returns the annotation file's path."""
    items = []
    for i, (h, w) in enumerate(sizes):
        s = SyntheticStereoDataset(length=1, height=h, width=w,
                                   max_disp=max_disp, seed=i,
                                   with_right_disp=True).load(0)
        item = {"height": h, "width": w}
        for key, sub, kind in (("leftImage", "image_2", "left_image_path"),
                               ("rightImage", "image_3", "right_image_path"),
                               ("leftDisp", "disp_occ_0",
                                "left_disp_map_path"),
                               ("rightDisp", "disp_occ_1",
                                "right_disp_map_path")):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
            rel = f"{sub}/{i:06d}_10.png"
            if key.endswith("Disp"):
                io.save_kitti_disp(os.path.join(root, rel), s[key][..., 0])
            else:
                io.save_png(os.path.join(root, rel),
                            np.clip(np.round(s[key]), 0, 255)
                            .astype(np.uint8), filter_type=i % 5)
            item[kind] = rel
        items.append(item)
    ann = os.path.join(root, "kitti15.json")
    with open(ann, "w") as fp:
        json.dump(items, fp)
    return ann


def randomize_bn(variables, rng):
    """Numpy copy of ``variables`` with every BatchNorm's statistics and
    affine parameters random."""
    def walk(tree, in_bn):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, in_bn or k == "BatchNorm_0")
            elif in_bn and k in ("scale", "var"):
                out[k] = rng.uniform(0.8, 1.25, v.shape).astype(np.float32)
            elif in_bn and k in ("bias", "mean"):
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.array(v)
        return out
    return walk(variables, False)


def eval_split(root, ann):
    return {"type": "KITTI-2015", "data_root": root,
            "eval": {"annfile": ann, "use_right_disp": True}}


@pytest.fixture(scope="module")
def eval_case(tmp_path_factory):
    """The dataset, the port's module on JAX's weights, and JAX's
    evaluate at batch sizes 3 and 1 (one jitted step, one compile per
    batch shape)."""
    root = str(tmp_path_factory.mktemp("kitti"))
    ann = write_kitti_dataset(root, SIZES)
    cfg = get_config("PSMNet/kitti_2015_f32", **TINY)
    module = build_model(cfg, torch.Generator().manual_seed(0))
    # the port's seeded tree in Flax's layout (a Flax init of PSMNet takes
    # tens of seconds on the CPU), BN made random, loaded on both sides
    variables = randomize_bn(flax_variables(module), np.random.RandomState(0))
    load_jax_variables(module, variables)
    jcfg = jget_config("PSMNet/kitti_2015_f32", **TINY)
    mean, std = jcfg["data"]["mean"], jcfg["data"]["std"]
    jmodel = jbuild_model(jcfg)
    jds = jbuild_dataset(eval_split(root, ann), "eval",
                         transform=jtransforms.make_eval_transform(
                             PAD, mean, std))
    ecfg = jcfg["model"]["eval"]
    ids = tuple(jcfg["eval_disparity_id"])
    step = jeval_loop.make_eval_metrics_step(
        jmodel, ecfg["lower_bound"], ecfg["upper_bound"], ids,
        ecfg["eval_occlusion"])
    jvars = jax.tree.map(jnp.asarray, variables)
    want = {b: jeval_loop.evaluate(jmodel, jvars, jds, ecfg, ids,
                                   batch_size=b, step=step)
            for b in (3, 1)}
    tds = build_dataset(eval_split(root, ann), "eval",
                        transform=transforms.make_eval_transform(
                            PAD, mean, std))
    return {"root": root, "ann": ann, "cfg": cfg, "module": module,
            "ds": tds, "want": want}


def assert_metrics_match(got, want, px_rtol=0.0):
    """EPE within 1e-3 px; n-px shares equal, or within ``px_rtol`` where
    the float32 per-batch sums group the samples differently."""
    assert set(got) == set(want) and "disp_0/noc_epe" in got
    for k in want:
        if k.endswith("epe"):
            assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
        else:
            assert abs(got[k] - want[k]) <= px_rtol * abs(want[k]), (
                k, got[k], want[k])


@pytest.mark.parametrize("batch_size", [3, 1])
def test_evaluate_matches_jax(eval_case, batch_size):
    cfg = eval_case["cfg"]
    mode = eval_case["module"].training
    got, n = eval_loop.evaluate(eval_case["module"], eval_case["ds"],
                                cfg["model"]["eval"],
                                cfg["eval_disparity_id"],
                                batch_size=batch_size)
    want, jn = eval_case["want"][batch_size]
    assert n == jn == len(SIZES)
    assert_metrics_match(got, want)
    # batched evaluation averages as the batch-1 loop does
    assert_metrics_match(got, eval_case["want"][1][0], px_rtol=1e-6)
    assert eval_case["module"].training == mode    # left as it came


def test_evaluate_fails_loudly_on_a_bad_sample(eval_case, tmp_path):
    with open(eval_case["ann"]) as fp:
        items = json.load(fp)
    items[2]["left_image_path"] = "image_2/missing.png"
    ann = tmp_path / "bad.json"
    ann.write_text(json.dumps(items))
    ds = build_dataset(eval_split(eval_case["root"], str(ann)), "eval",
                       transform=transforms.make_eval_transform(
                           PAD, (0.,) * 3, (1.,) * 3))
    with pytest.raises(FileNotFoundError, match="missing.png"):
        eval_loop.evaluate(eval_case["module"], ds,
                           eval_case["cfg"]["model"]["eval"])


def test_combine_shard_metrics_one_process_and_many(monkeypatch):
    res = {"disp_0/epe": 1.5}
    assert combine_shard_metrics(res, 4) == (res, 4)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 5"):
        combine_shard_metrics(res, 4)


@pytest.mark.parametrize("compat", [False, True])
def test_inverse_warp_2d_matches_jax(compat):
    rng = np.random.RandomState(0)
    img = rng.randn(2, 7, 13, 3).astype(np.float32)
    # offsets that land inside, between and outside the frame
    disp = rng.uniform(-15, 15, (2, 7, 13, 1)).astype(np.float32)
    want = np.asarray(jwarp.inverse_warp_2d(jnp.asarray(img),
                                            jnp.asarray(disp),
                                            compat_grid_sample=compat))
    got = warp.inverse_warp_2d(torch.from_numpy(img), torch.from_numpy(disp),
                               compat_grid_sample=compat).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    got3 = warp.inverse_warp_2d(torch.from_numpy(img),
                                torch.from_numpy(disp[..., 0]),
                                compat_grid_sample=compat).numpy()
    np.testing.assert_array_equal(got3, got)


def metric_inputs(seed, valid=True):
    rng = np.random.RandomState(seed)
    est = (rng.rand(3, 9, 14, 1) * 40).astype(np.float32)
    gt = (rng.rand(3, 9, 14, 1) * 40).astype(np.float32)
    gt[rng.rand(*gt.shape) < 0.3] = 0           # invalid pixels
    if not valid:
        gt[1] = 0                                # a sample with none valid
    right = np.roll(gt, -2, axis=2) + rng.randn(*gt.shape).astype(
        np.float32) * 0.5
    return est, gt, right


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("lb,ub,valid", [(None, None, True), (0, 32, True),
                                         (0, 32, False), (5, 20, False)])
def test_calc_error_matches_jax(per_sample, lb, ub, valid):
    est, gt, _ = metric_inputs(1, valid)
    want = jmetrics.calc_error(jnp.asarray(est), jnp.asarray(gt), lb, ub,
                               per_sample=per_sample)
    got = metrics.calc_error(torch.from_numpy(est), torch.from_numpy(gt), lb,
                             ub, per_sample=per_sample)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == np.shape(want[k])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("per_sample", [False, True])
def test_occlusion_split_matches_jax(compat, per_sample):
    est, gt, right = metric_inputs(2, valid=False)
    want_mask = jmetrics.occlusion_mask(jnp.asarray(gt), jnp.asarray(right),
                                        compat_grid_sample=compat)
    got_mask = metrics.occlusion_mask(torch.from_numpy(gt),
                                      torch.from_numpy(right),
                                      compat_grid_sample=compat)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    want = jmetrics.calc_error_with_occlusion(
        jnp.asarray(est), jnp.asarray(gt), jnp.asarray(right), 0, 32,
        per_sample=per_sample, compat_grid_sample=compat)
    got = metrics.calc_error_with_occlusion(
        torch.from_numpy(est), torch.from_numpy(gt), torch.from_numpy(right),
        0, 32, per_sample=per_sample, compat_grid_sample=compat)
    assert set(got) == set(want) and len(got) == 10
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)


def tiny_overrides():
    return [f"{k}={v}" for k, v in TINY.items()] + [
        f"data.test.input_shape={PAD}", "data.test.use_right_disp=True",
        "model.eval.batch_size=3"]


def test_test_tool_runs_end_to_end(eval_case, tmp_path, capsys):
    """tools/test.py on the tiny file dataset: the restored checkpoint's
    metrics equal ``evaluate`` on the saved module, and --out-dir holds
    every sample's KITTI PNG at its original size."""
    from densematchingbenchmark_tpu_torch.utils.checkpoint import (
        CheckpointManager)
    work = str(tmp_path / "work")
    CheckpointManager(work).save(
        7, {"module": eval_case["module"].state_dict()})
    out = str(tmp_path / "out")
    results, n = ttest.main([
        "--config", "PSMNet/kitti_2015_f32", "--work-dir", work,
        "--data-root", eval_case["root"], "--annfile", eval_case["ann"],
        "--out-dir", out, "--cpu", "--override", *tiny_overrides()])
    assert n == len(SIZES)
    assert_metrics_match(results, eval_case["want"][3][0])
    text = capsys.readouterr().out
    assert "WARNING" not in text and "noc/epe" in text
    for i, (h, w) in enumerate(SIZES):
        disp = io.load_kitti_disp(os.path.join(out, "disp_0",
                                               f"{i:06d}.png"))
        assert disp.shape == (h, w)
        for sub in ("color_disp", "group_disp"):
            assert os.path.exists(os.path.join(out, sub, f"{i:06d}.png"))
    with pytest.raises(NotImplementedError, match="item 5"):
        ttest.main(["--config", "PSMNet/kitti_2015_f32", "--work-dir", work,
                    "--cpu", "--launcher", "env"])


def test_train_tool_runs_with_synthetic_eval(tmp_path):
    work = str(tmp_path / "work")
    state = ttrain.main([
        "--config", "PSMNet/scene_flow_f32", "--work-dir", work,
        "--synthetic", "--synthetic-shape", "32", "64",
        "--synthetic-length", "2", "--synthetic-eval", "2",
        "--max-steps", "1", "--log-interval", "1", "--cpu",
        "--override", *[f"{k}={v}" for k, v in TINY.items()]])
    assert state.step == 1
    records = read_metrics(work)
    assert np.isfinite(records[0]["train/loss"])
    assert "eval/disp_0/epe" in records[-1]
    assert os.listdir(os.path.join(work, "checkpoints")) == ["1.pt"]
    with pytest.raises(NotImplementedError, match="item 3"):
        ttrain.main(["--config", "PSMNet/scene_flow_f32", "--work-dir", work,
                     "--cpu", "--profile", "1:2"])


def test_demo_tool_runs_end_to_end(tmp_path, capsys):
    rng = np.random.RandomState(0)
    for side in ("left", "right"):
        os.makedirs(tmp_path / "pairs" / side)
        io.save_png(str(tmp_path / "pairs" / side / "a.png"),
                    (rng.rand(40, 70, 3) * 255).astype(np.uint8))
    out = tmp_path / "out"
    tdemo.main(["--config", "PSMNet/kitti_2015_f32", "--data-dir",
                str(tmp_path / "pairs"), "--out-dir", str(out), "--cpu"])
    disp, _ = io.load_pfm(str(out / "a.pfm"))
    color = io.load_png(str(out / "a.png"))
    assert disp.shape == (40, 70) and np.isfinite(disp).all()
    assert color.shape == (40, 70, 3) and color.dtype == np.uint8
    assert "a: disp range" in capsys.readouterr().out


def test_bench_tool_needs_a_gpu(monkeypatch):
    from densematchingbenchmark_tpu_torch.tools import bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
