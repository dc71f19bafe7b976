"""The port's measurement tools, environment dump and annotation generator
on the CPU: each tool's ``main(argv)`` with ``--cpu`` at tiny shapes and
few iterations (the numbers are host times; the card's come from
chip_smoke.py), each tool's refusal without a GPU, gen_annotations
against the JAX package's tool on the same trees, and collect_env without
a GPU. The card's cases are in tests/test_torch_cuda.py.
"""

import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.models.layers import ConvUnit
from densematchingbenchmark_tpu_torch.tools import (benchmark,
                                                    gen_annotations,
                                                    loader_throughput,
                                                    profile_model,
                                                    train_throughput)
from densematchingbenchmark_tpu_torch.utils.collect_env import (
    card_line, collect_env_info, device_memory_stats)

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# StereoNet 8x at 32x64: a 4x8 feature map, 24 disparities at 1/8
STEREO = "StereoNet/scene_flow_8x_2stage"
STEREO_SMALL = ["model.backbone.residual_num=1"]


def positive(x):
    return isinstance(x, float) and math.isfinite(x) and x > 0


def test_zoo_row_counts_the_modules_parameters():
    """One row of the zoo table at full width on a 64x64 frame: the
    parameter count is the built module's, GFLOPs are there, the latency
    (host time here) is finite and positive."""
    rows = benchmark.main(["--cpu", "--models", "PWCFlow/flying_chairs",
                           "--dtype", "float32", "--height", "64",
                           "--width", "64", "--iters", "1", "--json"])
    assert len(rows) == 1
    row = rows[0]
    module = build_model(get_config("PWCFlow/flying_chairs_f32"))
    assert row["params"] == sum(p.numel() for p in module.parameters())
    assert row["gflops"] > 0 and row["device"] == "cpu"
    assert positive(row["latency_ms"]) and positive(row["fps"])
    assert row["ref_fps"] is None and row["vs_baseline"] is None


@pytest.mark.parametrize("ci,co,dhw", [(8, 16, (4, 6, 10)),
                                       (1, 32, (3, 5, 7))])
def test_zoo_flops_of_one_unit(ci, co, dhw):
    """The FLOP count of one 3x3x3 unit (the trunk's ConvUnit in eval,
    its plain route: the conv, then the folded BN) is 2 27 Ci Co D H W:
    two a multiply-add, the epilogue's elementwise work not counted."""
    unit = ConvUnit(ci, co, 3, 1, 1, dims=3).eval()
    d, h, w = dhw
    flops = benchmark.forward_flops(unit, (2, d, h, w, ci))
    assert flops == 2 * 27 * ci * co * d * h * w * 2


def test_zoo_flops_count_keeps_no_fake_tensor():
    """The port's tables made once per key and kept (ops/kept.py) keep
    nothing made under a FLOP count's fake tensor mode: a model's count,
    then a real forward of it in the same process, computes real
    tensors; each table made under the mode, then outside it, is real and
    kept."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from densematchingbenchmark_tpu_torch.ops import (cost_volume,
                                                      interpolate,
                                                      patch_match)
    cfg = get_config("PSMNet/scene_flow_f32", **{
        "model.max_disp": 16,
        "model.cost_processor.cost_computation.max_disp": 4,
        "model.cost_processor.cost_aggregator.max_disp": 16,
        "model.disp_predictor.max_disp": 16})
    module = build_model(cfg).eval()
    shape = (1, 32, 64, 3)
    assert benchmark.forward_flops(module, shape, shape) > 0
    with torch.inference_mode():
        out = build_model(cfg).eval()(torch.zeros(shape), torch.zeros(shape))
    assert not any(isinstance(d, FakeTensor) for d in out["disps"])
    assert np.isfinite(out["disps"][0].numpy()).all()
    cpu = torch.device("cpu")
    tables = [(interpolate.axis_taps_tensors, (7, 13, True, torch.float32,
                                               cpu)),
              (cost_volume.disp_sample_tensor, (11, 1, 1, cpu)),
              (patch_match.eval_noise, (3, 5, 7, cpu))]
    for table, key in tables:
        with FakeTensorMode():
            fake = table(*key)
        real = table(*key)
        for t in (real if isinstance(real, tuple) else (real,)):
            assert not isinstance(t, FakeTensor), table.__name__
        assert table(*key) is real and fake is not real, table.__name__


def test_train_throughput_reports_each_family_asked_for(tmp_path):
    """A record per family of ``--only`` (StereoNet's two), each with a
    step time in both dtypes and the config's published training rate
    where the reference has one; --out writes them."""
    out = tmp_path / "train.json"
    sets = sum([["--set", s] for s in STEREO_SMALL], [])
    records = train_throughput.main(["--cpu", "--only", "StereoNet",
                                     "--shape", "32x64", "--iters", "1",
                                     "--batch", "1", "--out", str(out),
                                     *sets])
    assert [r["family"] for r in records] == [
        "StereoNet/scene_flow_8x_2stage", "StereoNet/scene_flow_8x_4stage"]
    for r in records:
        assert r["batch"] == 1 and r["shape"] == "32x64"
        assert positive(r["f32_ms"]) and positive(r["bf16_ms"])
        assert positive(r["bf16_samples_per_s"])
    assert records[0]["ref_samples_per_sec_per_gpu"] > 0
    assert "ref_samples_per_sec_per_gpu" not in records[1]
    assert json.loads(out.read_text()) == records


def test_profile_model_writes_a_trace_and_lists_kernels(tmp_path):
    """The forward under torch.profiler: a Chrome trace at --out, the
    operators by time (on the CPU the host's operators), the calls
    counted."""
    trace = tmp_path / "trace.json"
    summary = profile_model.main([
        "--cpu", "--config", STEREO, "--height", "32", "--width", "64",
        "--iters", "1", "--dtype", "float32", "--out", str(trace),
        *sum([["--set", s] for s in STEREO_SMALL], [])])
    assert json.loads(trace.read_text())["traceEvents"]
    names = [k for k, _, _ in summary["kernels"]]
    assert any("conv" in n for n in names), names[:10]
    assert summary["launches"] > 0 and summary["wall_ms"] > 0
    times = [ms for _, ms, _ in summary["kernels"]]
    assert times == sorted(times, reverse=True)


def test_loader_throughput_on_the_set_it_writes(tmp_path):
    """The tool writes its SceneFlow-shaped set (PNG pairs, PFM
    disparities, the annotation JSON) into --workdir, reads it through the
    port's DataLoader at a positive rate, and compares with the train step
    of a train_throughput record when given one (no default step)."""
    records = tmp_path / "train.json"
    records.write_text(json.dumps([{"family": "PSMNet/scene_flow",
                                    "bf16_ms": 100.0, "batch": 3}]))
    work = tmp_path / "set"
    args = ["--cpu", "--n", "4", "--size", "64", "128", "--crop", "32",
            "64", "--workers", "2", "--batch", "2", "--epochs", "1",
            "--workdir", str(work)]
    rec = loader_throughput.main(args + ["--throughput-json", str(records)])
    assert positive(rec["value"]) and rec["device"] == "cpu"
    assert rec["vs_train_step_demand"] == pytest.approx(
        rec["value"] / 30.0, rel=1e-2)
    anns = json.loads((work / "annotations.json").read_text())
    assert len(anns) == 4
    assert all((work / a["left_disp_map_path"]).exists() for a in anns)
    # the set is reused; without a step to compare with, no margin
    rec = loader_throughput.main(args)
    assert positive(rec["value"]) and "vs_train_step_demand" not in rec


TOOL_ARGS = {
    "benchmark": (benchmark, ["--models", "PWCFlow/flying_chairs"]),
    "train_throughput": (train_throughput, ["--only", "StereoNet"]),
    "profile_model": (profile_model, ["--config", STEREO]),
    "loader_throughput": (loader_throughput, ["--n", "1"]),
}


@pytest.mark.parametrize("tool", list(TOOL_ARGS))
def test_tools_raise_without_a_gpu(monkeypatch, tool):
    """Without --cpu a measurement tool runs on the GPU: with none it
    raises before it builds or writes anything, and never falls back to
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, args = TOOL_ARGS[tool]
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(args)


def write_tree(root, files):
    for rel in files:
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as fp:
            fp.write(b"")


def sceneflow_tree(root):
    files = []
    for split, parts in (("TRAIN", "AB"), ("TEST", "C")):
        for part in parts:
            for idx in ("0000", "0001"):
                for view in ("left", "right"):
                    for i in (6, 7):
                        files += [
                            f"flyingthings3d/frames_cleanpass/{split}/{part}/"
                            f"{idx}/{view}/{i:04d}.png",
                            f"flyingthings3d/disparity/{split}/{part}/{idx}/"
                            f"{view}/{i:04d}.pfm"]
    for scene in ("Monkaa/disparity/a_rain_of_stones_x2",
                  "Driving/disparity/15mm_focallength/scene_backwards/fast"):
        for view in ("left", "right"):
            files += [f"{scene}/{view}/{i:04d}.pfm" for i in (1, 2)]
    write_tree(root, files)


def kitti_tree(root, year):
    left, right, disp = (("image_2", "image_3", "disp_occ_0") if year == 2015
                         else ("colored_0", "colored_1", "disp_occ"))
    files = []
    for split in ("training", "testing"):
        for i in range(3):
            for name in (f"{i:06d}_10.png", f"{i:06d}_11.png"):
                files += [f"{split}/{left}/{name}", f"{split}/{right}/{name}"]
            if split == "training" and i != 1:
                files.append(f"{split}/{disp}/{i:06d}_10.png")
    write_tree(root, files)


def jax_gen_annotations():
    """The JAX package's tool, loaded by its path (tools/ is not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_gen_annotations", os.path.join(REPO, "tools",
                                            "gen_annotations.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dataset,extra", [
    ("SceneFlow", []), ("SceneFlow", ["--data-type", "final"]),
    ("KITTI-2015", []), ("KITTI-2012", [])],
    ids=["sceneflow", "sceneflow_final", "kitti2015", "kitti2012"])
def test_gen_annotations_matches_jax(tmp_path, monkeypatch, dataset, extra):
    """The same tree through both tools gives identical JSON files (the
    SceneFlow splits with Monkaa and Driving in the train split; KITTI's
    training pairs with and without GT, and the test pairs)."""
    root = str(tmp_path / "data")
    if dataset == "SceneFlow":
        sceneflow_tree(root)
        if extra:   # the final pass's frames, beside the clean ones
            for cur, _, files in os.walk(root):
                if "frames_cleanpass" in cur:
                    write_tree(root, [os.path.relpath(os.path.join(
                        cur, f), root).replace("cleanpass", "finalpass")
                        for f in files])
    else:
        kitti_tree(root, int(dataset[-4:]))
    args = ["--dataset", dataset, "--data-root", root, *extra]
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["gen_annotations.py", *args,
                                      "--out-dir", str(want_dir)])
    jax_gen_annotations().main()
    written = gen_annotations.main(args + ["--out-dir", str(got_dir)])
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and len(names) == 2
    for name in names:
        want = (want_dir / name).read_text()
        assert (got_dir / name).read_text() == want, name
        assert written[str(got_dir / name)] == len(json.loads(want))
    assert sum(written.values()) > 0


def test_collect_env_without_a_gpu():
    """The environment dump runs here, says there is no GPU, names torch
    and numpy, and raises nothing; no memory stats without a GPU."""
    info = collect_env_info()
    lines = info.splitlines()
    assert lines[0] == card_line() == \
        "gpu: none (torch.cuda.is_available() is False)"
    assert any(line.startswith("torch: ") for line in lines)
    assert f"numpy: {np.__version__}" in lines
    assert device_memory_stats() == {}
