"""The port's convergence tools against the JAX package's, on the CPU:
tools/convergence_gauntlet.py (its family tables, its synthetic streams
and their batches, its EPE, and its overfit criterion), and
tools/bf16_convergence.py and tools/view_cost.py.

JAX's tools live at the repository's root (``tools/``) and import no JAX
at their top. The gauntlet's pieces are held exactly: the tables, every
batch ``_drive`` feeds a step (through the loader's epochs, and in the
overfit mode), the eval sets, and the EPE of the same predictions. The
overfit criterion of JAX's tests/test_convergence_gauntlet.py (24 steps on
one batch: the loss below 0.7 of its first value, the batch's EPE down)
is held at JAX's CI sizes on the port's counterparts of its tiny configs
(tests/test_torch_convergence_overfit.py). ``view_cost``'s curves are
held within 1e-5 of the softmax of JAX's model's cost on the same
weights.
"""

import numpy as np
import jax
import pytest
import torch

from densematchingbenchmark_tpu.configs import get_config as jget_config
from densematchingbenchmark_tpu.data import DataLoader as JDataLoader
from densematchingbenchmark_tpu.flow import transforms as jflow_transforms
from densematchingbenchmark_tpu.flow.datasets import (
    SyntheticFlowDataset as JSyntheticFlowDataset)
from densematchingbenchmark_tpu.models import build_model as jbuild_model
from tools import convergence_gauntlet as jgauntlet

from densematchingbenchmark_tpu_torch.apis import StereoModel
from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.data import io
from densematchingbenchmark_tpu_torch.losses import make_loss_evaluator
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.tools import bf16_convergence
from densematchingbenchmark_tpu_torch.tools import (
    convergence_gauntlet as gauntlet)
from densematchingbenchmark_tpu_torch.tools import view_cost
from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                      build_optimizer,
                                                      make_train_step)
from densematchingbenchmark_tpu_torch.utils import flax_variables

from acfnet_parity import jit_call

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

M = 32
# JAX's __graft_entry__._tiny_cfg, PSMNet at max_disp 32
TINY_PSMNET = {"model.max_disp": M,
               "model.cost_processor.cost_computation.max_disp": M // 4,
               "model.cost_processor.cost_aggregator.max_disp": M,
               "model.disp_predictor.max_disp": M,
               "model.losses.l1_loss.max_disp": M}
# JAX's CI sizes (tests/test_convergence_gauntlet.py:25-27)
STREAM = dict(crop_hw=(64, 96), gen_hw=(96, 160), train_len=8, eval_len=2,
              batch=2, seed=3)


def test_family_tables_are_jax():
    assert gauntlet.STEREO_FAMILIES == jgauntlet.STEREO_FAMILIES
    assert gauntlet.FLOW_FAMILIES == jgauntlet.FLOW_FAMILIES


def recorder():
    """A train step that keeps each batch it is fed (numpy) and returns
    the step's number as its loss."""
    seen = []

    def step(state, batch):
        seen.append({k: np.asarray(v) for k, v in batch.items()})
        return state, {"loss": float(len(seen))}
    return step, seen


def same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def jax_flow_data(cfg, crop_hw, gen_hw, max_flow, train_len, eval_len,
                  batch, seed):
    """JAX's flow stream as its run_flow_family builds it inline
    (tools/convergence_gauntlet.py:212-221)."""
    mean, std = cfg["data"]["mean"], cfg["data"]["std"]
    train_ds = JSyntheticFlowDataset(
        length=train_len, height=gen_hw[0], width=gen_hw[1],
        max_flow=max_flow, seed=seed,
        transform=jflow_transforms.make_train_transform(crop_hw, mean, std))
    eval_ds = JSyntheticFlowDataset(
        length=eval_len, height=crop_hw[0], width=crop_hw[1],
        max_flow=max_flow, seed=seed + 7,
        transform=jflow_transforms.make_eval_transform(crop_hw, mean, std))
    return JDataLoader(train_ds, batch, seed=seed), eval_ds


@pytest.mark.parametrize("task", ["stereo", "flow"])
@pytest.mark.parametrize("overfit", [False, True])
def test_streams_and_drive_feed_jax_batches(task, overfit):
    """The train loader's batches through ``_drive`` (10 steps: two epochs
    of 4 and part of a third, or the first batch again and again), its
    logged (step, loss) pairs and its first batch, and the eval set,
    equal JAX's exactly for the same seed."""
    s = STREAM
    if task == "stereo":
        name, keys, size = "PSMNet/scene_flow", gauntlet.STEREO_KEYS, 12
        loader, eval_ds = gauntlet._stereo_data(
            get_config(name + "_f32"), s["crop_hw"], s["gen_hw"], size,
            s["train_len"], s["eval_len"], s["batch"], s["seed"])
        jloader, jeval_ds = jgauntlet._stereo_data(
            jget_config(name), s["crop_hw"], s["gen_hw"], size,
            s["train_len"], s["eval_len"], s["batch"], s["seed"])
    else:
        name, keys, size = "PWCFlow/flying_chairs", gauntlet.FLOW_KEYS, 4
        loader, eval_ds = gauntlet._flow_data(
            get_config(name + "_f32"), s["crop_hw"], s["gen_hw"], size,
            s["train_len"], s["eval_len"], s["batch"], s["seed"])
        jloader, jeval_ds = jax_flow_data(
            jget_config(name), s["crop_hw"], s["gen_hw"], size,
            s["train_len"], s["eval_len"], s["batch"], s["seed"])
    step, seen = recorder()
    _, losses, fixed = gauntlet._drive(loader, step, None, 10, 3, keys,
                                       overfit, "cpu")
    jstep, jseen = recorder()
    _, jlosses, jfixed = jgauntlet._drive(jloader, jstep, None, 10, 3,
                                          keys, overfit)
    same_batches(seen, jseen)
    assert losses == jlosses == [(1, 1.0), (3, 3.0), (6, 6.0), (9, 9.0),
                                 (10, 10.0)]
    if overfit:
        same_batches([{k: v.numpy() for k, v in fixed.items()}],
                     [{k: np.asarray(v) for k, v in jfixed.items()}])
        first = gauntlet._first_batch(loader, keys, "cpu")
        same_batches([{k: v.numpy() for k, v in first.items()}], seen[:1])
    else:
        assert fixed is None and jfixed is None
    rng = np.random.default_rng
    for i in range(len(jeval_ds)):
        got = eval_ds.__getitem__(i, rng=rng(i))
        want = jeval_ds.__getitem__(i, rng=rng(i))
        for k in ("leftImage", "rightImage", keys[2]):
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("out_key", ["disps", "flows"])
def test_epe_is_jax(out_key):
    """The same predictions (a numpy function of the frames) scored by
    both tools' _epe over the same eval set: equal to float32 rounding."""
    s = STREAM
    if out_key == "disps":
        cfg, jcfg = get_config("PSMNet/scene_flow_f32"), jget_config(
            "PSMNet/scene_flow")
        _, eval_ds = gauntlet._stereo_data(cfg, s["crop_hw"], s["gen_hw"],
                                           12, 8, 3, 2, 0)
        _, jeval_ds = jgauntlet._stereo_data(jcfg, s["crop_hw"], s["gen_hw"],
                                             12, 8, 3, 2, 0)
    else:
        cfg = get_config("PWCFlow/flying_chairs_f32")
        _, eval_ds = gauntlet._flow_data(cfg, s["crop_hw"], s["gen_hw"], 4,
                                         8, 3, 2, 0)
        _, jeval_ds = jax_flow_data(jget_config("PWCFlow/flying_chairs"),
                                    s["crop_hw"], s["gen_hw"], 4, 8, 3, 2, 0)

    def predict(left, right):
        left, right = np.asarray(left), np.asarray(right)
        pred = np.abs(left - right).sum(-1, keepdims=True) * 3.0
        return pred if out_key == "disps" else np.concatenate(
            [pred, -left[..., :1]], -1)
    got = gauntlet._epe(predict, eval_ds, out_key)
    want = jgauntlet._epe(lambda v, l, r: predict(l, r), None, jeval_ds,
                          out_key)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def tiny_psmnet(fused=False):
    """(port config, JAX config) of PSMNet at max_disp 32, JAX at its
    plain schedule."""
    over = dict(TINY_PSMNET, **{"model.eval.fused_upsample_argmin": fused})
    return (get_config("PSMNet/scene_flow_f32", **over),
            jget_config("PSMNet/scene_flow_f32", **over,
                        **{"model.backbone.pack": 0,
                           "model.cost_processor.cost_aggregator.pack": 0}))


@pytest.fixture(scope="module")
def view_cost_run(tmp_path_factory):
    """view_cost.main on the CPU at the tiny PSMNet (its seeded weights)
    over the JAX tool's RandomState(0) pixels: (its result, its out dir,
    the JAX model's cost and disparity on the same weights and pair)."""
    out_dir = tmp_path_factory.mktemp("costs")
    result = view_cost.main(
        ["--cpu", "--config", "PSMNet/scene_flow_f32", "--out-dir",
         str(out_dir), "--override",
         *(f"{k}={v}" for k, v in TINY_PSMNET.items())])
    cfg, jcfg = tiny_psmnet()
    variables = flax_variables(build_model(
        cfg, torch.Generator().manual_seed(0)))
    norm = view_cost.synthetic_pair(cfg)[1]
    out = jit_call(lambda v, l, r: jbuild_model(jcfg).apply(
        v, l, r, train=False), variables, norm["leftImage"][None],
        norm["rightImage"][None])
    return (result, out_dir, np.asarray(out["costs"][0])[0],
            np.asarray(out["disps"][0])[0, ..., 0])


def test_view_cost_curves_match_jax(view_cost_run):
    """At the JAX tool's RandomState(0) pixels of the 256x512 synthetic
    pair, each curve within 1e-5 of softmax over D of JAX's cost on the
    same weights, the estimate within 1e-3 px of JAX's disparity, the GT
    the pair's."""
    result, _, cost, disp = view_cost_run
    sample = view_cost.synthetic_pair(tiny_psmnet()[0])[0]
    rng = np.random.RandomState(0)     # the JAX tool's draw
    pixels = [(int(rng.randint(64, 192)), int(rng.randint(128, 384)))
              for _ in range(4)]
    assert [(c["y"], c["x"]) for c in result["curves"]] == pixels
    np.testing.assert_array_equal(result["d_axis"], np.arange(M))
    for c in result["curves"]:
        col = cost[:, c["y"], c["x"]]
        want = np.exp(col - col.max())
        np.testing.assert_allclose(c["prob"], want / want.sum(), rtol=0,
                                   atol=1e-5)
        assert abs(c["est"] - disp[c["y"], c["x"]]) <= 1e-3
        assert c["gt"] == sample["leftDisp"][c["y"], c["x"], 0]


def test_view_cost_writes_the_plots(view_cost_run):
    """One PNG a pixel under JAX's names, read back by data/io.decode_png
    as draw_curve's RGB image at PLOT_SIZE: white around the curve, with
    the curve's colour and, where the estimate falls in [0, D - 1], its
    marker's."""
    result, out_dir, _, _ = view_cost_run
    assert sorted(p.name for p in out_dir.iterdir()) == sorted(
        f"cost_y{c['y']}_x{c['x']}.png" for c in result["curves"])
    for c in result["curves"]:
        img = io.decode_png((out_dir / f"cost_y{c['y']}_x{c['x']}.png")
                            .read_bytes())
        assert img.shape == view_cost.PLOT_SIZE + (3,)
        np.testing.assert_array_equal(img, view_cost.draw_curve(
            c["prob"], c["est"], c["gt"]))
        colours = {tuple(map(int, p)) for p in np.unique(
            img.reshape(-1, 3), axis=0)}
        assert view_cost.CURVE in colours and (255, 255, 255) in colours
        assert (view_cost.EST in colours) == (0 <= c["est"] <= M - 1)


def test_view_cost_fused_mode_fails_as_jax():
    """In the fused eval mode the model's first cost is the 1/4-resolution
    volume (JAX models/builder.py:122-130, the port's
    models/generalized.py): both tools index it at full-resolution pixels,
    and the first of the JAX tool's RandomState(0) draws is out of range.
    JAX's side by shapes (jax.eval_shape, nothing computed) and numpy's
    indexing as its tool does it; the port's by running cost_curves."""
    cfg, jcfg = tiny_psmnet(fused=True)
    module = build_model(cfg, torch.Generator().manual_seed(0)).eval()
    norm = view_cost.synthetic_pair(cfg)[1]
    shapes = jax.eval_shape(lambda v, l, r: jbuild_model(jcfg).apply(
        v, l, r, train=False), flax_variables(module),
        norm["leftImage"][None], norm["rightImage"][None])
    assert shapes["costs"][0].shape == (1, M // 4, 64, 128)
    assert shapes["disps"][0].shape == (1, 256, 512, 1)
    rng = np.random.RandomState(0)
    y, x = int(rng.randint(64, 192)), int(rng.randint(128, 384))
    with pytest.raises(IndexError):
        np.zeros(shapes["costs"][0].shape, np.float32)[0][:, y, x]
    assert module.fused_upsample_argmin
    with pytest.raises(IndexError, match=f"index {y} is out of bounds"):
        view_cost.cost_curves(StereoModel(cfg, module, torch.device("cpu")))


def test_view_cost_without_costs_fails_as_jax():
    """DeepPruner returns no cost volume on either side ('costs': [],
    JAX models/deeppruner.py:258): the tool fails with JAX's assertion
    (tools/view_cost.py:84)."""
    cfg = get_config("DeepPruner/scene_flow_8x_f32",
                     **{"model.max_disp": 64, "model.disp_sampler.iterations":
                        1})
    module = build_model(cfg, torch.Generator().manual_seed(0)).eval()
    with pytest.raises(AssertionError, match="no cost volumes to inspect"):
        view_cost.cost_curves(StereoModel(cfg, module, torch.device("cpu")))


def test_bf16_convergence_runs_the_same_stream():
    """bf16_convergence.main for 3 steps on AnyNet (the smallest model) at
    32x64 batch 2: JAX's record keys; its float32 curve's first loss equal
    to one port train step from the same seed on the stream's first batch;
    both curves finite."""
    name = "AnyNet/scene_flow"
    out = bf16_convergence.main(["--cpu", "--config", name, "--steps", "3",
                                 "--height", "32", "--width", "64",
                                 "--log-every", "2"])
    assert sorted(out) == sorted(["config", "steps", "shape", "batch",
                                  "float32", "bfloat16", "tail_rel_diff",
                                  "speedup"])
    for dtype in ("float32", "bfloat16"):
        assert sorted(out[dtype]) == ["curve", "final_loss", "step_ms"]
        assert [s for s, _ in out[dtype]["curve"]] == [0, 2]
        assert np.isfinite([v for _, v in out[dtype]["curve"]]).all()
    cfg = get_config(name, **{"model.dtype": "float32"})
    module = build_model(cfg, torch.Generator().manual_seed(0))
    state = TrainState.create(module, build_optimizer(cfg, module, 3)[0], 1)
    step = make_train_step(make_loss_evaluator(cfg["model"]["losses"]))
    batch = bf16_convergence.stream(cfg, 32, 64, 2)(0)
    _, metrics = step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    assert out["float32"]["curve"][0][1] == round(metrics["loss"].item(), 5)


@pytest.mark.parametrize("tool,argv", [
    (gauntlet, ["--families", "AnyNet", "--steps", "1"]),
    (bf16_convergence, ["--steps", "1"]),
    (view_cost, ["--config", "PSMNet/scene_flow", "--out-dir", "unused"])])
def test_tools_raise_without_a_gpu(monkeypatch, tool, argv):
    """Without a GPU and without --cpu each tool raises before any work,
    as the measurement tools do (tools/common.tool_device)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(argv)
