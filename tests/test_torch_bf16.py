"""bfloat16 compute of the port (``model.dtype="bfloat16"``: float32
parameters and BN statistics, bfloat16 activations and convolutions, a
float32 soft-argmin) against the JAX package's, on the CPU: the config
names and the default dtype, K4's plain version at pack 1 with the [Co]
epilogue, the mixed-precision helpers and the tools in bfloat16. The
units are in tests/test_torch_bf16_units.py, the slice in
tests/test_torch_bf16_slice.py and a train step in
tests/test_torch_bf16_train.py (one file each keeps every file's CPU
time near 15 s).
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu import configs as jconfigs
from densematchingbenchmark_tpu.ops import conv3d as jconv3d
from densematchingbenchmark_tpu.ops.pallas.packed_conv3d_kernel import (
    conv3d_packed_s1_pallas)
from densematchingbenchmark_tpu.utils import mixed_precision as jmp

from densematchingbenchmark_tpu_torch import configs as tconfigs
from densematchingbenchmark_tpu_torch.data import (SyntheticStereoDataset,
                                                   io)
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.tools import bench as tbench
from densematchingbenchmark_tpu_torch.tools import demo as tdemo
from densematchingbenchmark_tpu_torch.tools import test as ttest
from densematchingbenchmark_tpu_torch.tools import train as ttrain
from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics
from densematchingbenchmark_tpu_torch.utils.checkpoint import (
    CheckpointManager)
from densematchingbenchmark_tpu_torch.utils.mixed_precision import (
    DynamicLossScale, all_finite, select_tree)

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_STEP = 2.0 ** -7
M = 16
TINY = {"model.max_disp": M,
        "model.cost_processor.cost_computation.max_disp": M // 4,
        "model.cost_processor.cost_aggregator.max_disp": M,
        "model.disp_predictor.max_disp": M,
        "model.losses.l1_loss.max_disp": M,
        "model.eval.upper_bound": M}
NAMES = ["PSMNet/scene_flow", "PSMNet/kitti_2015", "PSMNet/kitti_2012"]


def bf16_numpy(a):
    """float32 numpy array rounded to bfloat16 (round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16() \
        .float().numpy()


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("name", NAMES)
def test_dtype_names_resolve_as_jax(name):
    over = {"model.max_disp": 96}
    for suffix, dtype in (("_bf16", "bfloat16"), ("_f32", "float32")):
        got = tconfigs.get_config(name + suffix, **over)
        assert got == jconfigs.get_config(name + suffix, **over)
        assert got["model"]["dtype"] == dtype
    # an explicit model.dtype wins over the suffix, as in JAX
    pinned = {"model.dtype": "float32"}
    assert tconfigs.get_config(name + "_bf16", **pinned) == \
        jconfigs.get_config(name + "_bf16", **pinned)


def test_default_compute_dtype(monkeypatch):
    """As tests/test_configs.py:55-66: the environment variable wins, then
    a CUDA device means bfloat16 and none float32; suffixes and an explicit
    model.dtype pin it. Deciding creates no CUDA context."""
    monkeypatch.delenv("DMB_DEFAULT_DTYPE", raising=False)
    assert tconfigs.get_config("PSMNet/scene_flow")["model"]["dtype"] == \
        "float32"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tconfigs.default_compute_dtype() == "bfloat16"
    assert tconfigs.get_config("PSMNet/kitti_2015")["model"]["dtype"] == \
        "bfloat16"
    assert not torch.cuda.is_initialized()
    monkeypatch.setenv("DMB_DEFAULT_DTYPE", "float32")
    assert tconfigs.get_config("PSMNet/scene_flow")["model"]["dtype"] == \
        "float32"
    monkeypatch.setenv("DMB_DEFAULT_DTYPE", "bfloat16")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tconfigs.get_config("PSMNet/scene_flow")["model"]["dtype"] == \
        "bfloat16"
    assert tconfigs.get_config("PSMNet/scene_flow_f32")["model"]["dtype"] \
        == "float32"
    assert tconfigs.get_config("PSMNet/scene_flow", **{
        "model.dtype": "float32"})["model"]["dtype"] == "float32"


def test_unknown_dtype_raises():
    with pytest.raises(ValueError, match="model.dtype"):
        build_model(tconfigs.get_config("PSMNet/scene_flow",
                                        **{"model.dtype": "float16"}))


def test_k4_plain_bf16_pack1_matches_pallas():
    """K4's plain version in bfloat16 at pack 1 (the trunk's call: a [Co]
    folded-BN epilogue, ReLU on and off) against JAX's
    conv3d_packed_s1_pallas in interpret mode, as
    tests/ops/test_packed_conv3d_pallas.py runs it. The Pallas kernel takes
    an even pack only, so it runs at pack 2 on the packed volume and its
    result is unpacked: the same convolution. Within one bfloat16 step of
    the largest magnitude (both round their float32 result once)."""
    rng = np.random.RandomState(2)
    for (ci, co, shape), relu in (((64, 32, (2, 4, 4, 9)), True),
                                  ((32, 32, (1, 4, 8, 10)), False)):
        x = bf16_numpy(rng.randn(*shape, ci) * 0.5)
        k = (rng.randn(3, 3, 3, ci, co) * 0.05).astype(np.float32)
        scale = (rng.rand(co) + 0.5).astype(np.float32)
        bias = rng.randn(co).astype(np.float32)
        want = jconv3d.unpack_volume(conv3d_packed_s1_pallas(
            jconv3d.pack_volume(jnp.asarray(x, jnp.bfloat16), 2),
            jnp.asarray(k), jnp.asarray(scale), jnp.asarray(bias), pack=2,
            relu=relu, h_tile=4, interpret=True), 2)
        assert want.dtype == jnp.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        got = kernels.conv3d_packed_s1(
            torch.from_numpy(x).bfloat16(), torch.from_numpy(k),
            torch.from_numpy(scale), torch.from_numpy(bias), pack=1,
            relu=relu)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=BF16_STEP * np.abs(want).max())


def test_regression_takes_bf16_costs_as_jax():
    """K2 and K3 (their plain versions here) on bfloat16 costs against
    JAX's soft_argmin (ops/soft_argmin.py:37 promotes the cost to float32)
    and its fused_upsample_soft_argmin (interpret mode, the low-resolution
    cost promoted first): float32 disparities, equal up to float32 sums
    in another order; and K2's forward block on the card holds 16 bytes of
    the cost's dtype a thread, so D stays inside each thread in both
    dtypes."""
    from densematchingbenchmark_tpu.ops.pallas import (
        fused_upsample_soft_argmin as jfused)
    from densematchingbenchmark_tpu.ops.soft_argmin import (
        soft_argmin as jsoft_argmin)
    from densematchingbenchmark_tpu_torch.ops.cuda import soft_argmin_kernel
    rng = np.random.RandomState(4)
    cost = bf16_numpy(rng.randn(2, 16, 5, 9) * 3)
    want = np.asarray(jsoft_argmin(jnp.asarray(cost, jnp.bfloat16),
                                   max_disp=16))
    got = kernels.fused_soft_argmin(torch.from_numpy(cost).bfloat16(), 16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    low = bf16_numpy(rng.randn(1, 4, 3, 5) * 3)
    want = np.asarray(jfused(jnp.asarray(low, jnp.bfloat16), 16, 8, 20))
    got = kernels.fused_upsample_soft_argmin(
        torch.from_numpy(low).bfloat16(), 16, 8, 20)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert soft_argmin_kernel.fwd_block_w(torch.float32) == 4 * 32 * \
        soft_argmin_kernel.FWD_WARPS
    assert soft_argmin_kernel.fwd_block_w(torch.bfloat16) == 8 * 32 * \
        soft_argmin_kernel.FWD_WARPS


# -------------------------------------------------------- mixed precision

def test_dynamic_loss_scale():
    """As tests/test_utils.py:21-45, with the scale's tensors on the
    device of their creation and the JAX class's values step by step."""
    scale = DynamicLossScale.create(1024.0, growth_interval=2)
    jscale = jmp.DynamicLossScale.create(1024.0, growth_interval=2)
    for finite in (False, True, True, True, False):
        scale = scale.update(torch.tensor(finite))
        jscale = jscale.update(jnp.bool_(finite))
        assert float(scale.value) == float(jscale.value)
        assert int(scale.counter) == int(jscale.counter)
    assert scale.value.dtype == torch.float32
    # non-finite halves, two finite steps grow, never below 1
    s = DynamicLossScale.create(1024.0, growth_interval=2)
    s = s.update(torch.tensor(False))
    assert float(s.value) == 512.0
    s = s.update(torch.tensor(True)).update(torch.tensor(True))
    assert float(s.value) == 1024.0
    s = DynamicLossScale.create(1.0).update(torch.tensor(False))
    assert float(s.value) == 1.0


def test_all_finite_and_select():
    good = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
    bad = {"a": torch.tensor([1.0, float("nan"), 1.0]),
           "b": {"c": torch.zeros(2)}}
    assert bool(all_finite(good)) and bool(all_finite([]))
    assert not bool(all_finite(bad))
    assert not bool(all_finite([torch.ones(2), torch.tensor([float("inf")])]))
    sel = select_tree(torch.tensor(False), bad, good)
    assert bool(all_finite(sel))
    assert torch.equal(select_tree(torch.tensor(True), bad, good)["b"]["c"],
                       bad["b"]["c"])


# ------------------------------------------------------------------ tools

def test_train_tool_takes_a_bf16_step(tmp_path):
    work = str(tmp_path / "work")
    state = ttrain.main([
        "--config", "PSMNet/scene_flow", "--dtype", "bfloat16",
        "--work-dir", work, "--synthetic", "--synthetic-shape", "32", "64",
        "--synthetic-length", "1", "--max-steps", "1", "--log-interval",
        "1", "--cpu", "--override", *[f"{k}={v}" for k, v in TINY.items()]])
    assert state.step == 1
    conv = state.module.cost_processor.aggregator.ConvUnit_0
    assert conv.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.module.parameters())
    record = read_metrics(work)[0]
    assert np.isfinite(record["train/loss"])
    assert np.isfinite(record["train/grad_norm"])


def write_pairs(root, sizes):
    """A KITTI-2015-layout file dataset of SyntheticStereoDataset pairs;
    returns its annotation file."""
    items = []
    for i, (h, w) in enumerate(sizes):
        s = SyntheticStereoDataset(length=1, height=h, width=w, max_disp=12,
                                   seed=i, with_right_disp=True).load(0)
        item = {}
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
                io.save_png(os.path.join(root, rel), np.clip(
                    np.round(s[key]), 0, 255).astype(np.uint8))
            item[kind] = rel
        items.append(item)
    ann = os.path.join(root, "kitti15.json")
    with open(ann, "w") as fp:
        json.dump(items, fp)
    return ann


def test_test_and_demo_tools_run_in_bf16(tmp_path, capsys):
    """tools/test.py and tools/demo.py with --dtype bfloat16: the model is
    built in bfloat16 compute and the metrics and disparities come out as
    float32 numbers; without --dtype a _bf16 name does the same."""
    root = str(tmp_path / "kitti")
    ann = write_pairs(root, ((30, 60), (32, 64)))
    over = [f"{k}={v}" for k, v in TINY.items()
            if k != "model.losses.l1_loss.max_disp"]
    for config, dtype in (("PSMNet/kitti_2015", ["--dtype", "bfloat16"]),
                          ("PSMNet/kitti_2015_bf16", [])):
        results, n = ttest.main([
            "--config", config, "--work-dir", str(tmp_path / "work"),
            "--data-root", root, "--annfile", ann, "--cpu", *dtype,
            "--override", *over, "data.test.input_shape=(32, 64)",
            "data.test.use_right_disp=True"])
        assert n == 2 and "disp_0/noc_epe" in results
        assert all(isinstance(v, float) and np.isfinite(v)
                   for v in results.values())
    assert CheckpointManager(str(tmp_path / "work")).latest_step() is None
    pairs = tmp_path / "pairs"
    rng = np.random.RandomState(0)
    for side in ("left", "right"):
        os.makedirs(pairs / side)
        io.save_png(str(pairs / side / "a.png"),
                    (rng.rand(40, 70, 3) * 255).astype(np.uint8))
    tdemo.main(["--config", "PSMNet/kitti_2015", "--data-dir", str(pairs),
                "--out-dir", str(tmp_path / "out"), "--cpu", "--dtype",
                "bfloat16"])
    disp, _ = io.load_pfm(str(tmp_path / "out" / "a.pfm"))
    assert disp.shape == (40, 70) and np.isfinite(disp).all()
    assert "a: disp range" in capsys.readouterr().out
    args = tdemo.parse_args(["--config", "c", "--data-dir", "d",
                             "--out-dir", "o", "--dtype", "bfloat16"])
    assert args.dtype == "bfloat16"


def test_bench_names_its_record_by_dtype(monkeypatch):
    """bfloat16 carries bench.py's own metric name, float32 its _f32 one;
    either way the tool needs a GPU."""
    with open(os.path.join(REPO, "bench.py")) as fp:
        assert f'"{tbench.metric_name("bfloat16")}"' in fp.read()
    assert tbench.metric_name("bfloat16") == \
        "psmnet_inference_fps_384x1248_b1"
    assert tbench.metric_name("float32") == \
        "psmnet_inference_fps_384x1248_b1_f32"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--dtype", "float32"], ["--dtype", "bfloat16"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tbench.main(argv)
