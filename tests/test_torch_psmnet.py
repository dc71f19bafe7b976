"""The port's PSMNet inference slice end to end against the JAX package.

Both sides go through their own ``init_model`` + ``inference_stereo`` at a
tiny config (max_disp 64, 64x64 test shape; the JAX side still runs its
shipped row-packed backbone and D-packed trunk). The JAX variables, with
every BatchNorm's parameters and running statistics set to random,
non-trivial values (identity BN would hide an epilogue bug), are carried
into the port by ``load_jax_variables``. Both sides compute in float32 and
differ in the order of their sums, amplified through soft-argmin:
tolerance 1e-3 px on disparities in [0, 64).
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu import apis as japis
from densematchingbenchmark_tpu.configs import get_config as jget_config
from densematchingbenchmark_tpu.models import build_model as jbuild_model

from densematchingbenchmark_tpu_torch import apis as tapis
from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)
from densematchingbenchmark_tpu_torch.utils.checkpoint import (
    CheckpointManager)

from acfnet_parity import flat

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model.max_disp": 64,
        "model.cost_processor.cost_computation.max_disp": 16,
        "model.cost_processor.cost_aggregator.max_disp": 64,
        "model.disp_predictor.max_disp": 64,
        "data.test.input_shape": (64, 64)}


def randomize_bn(variables, rng):
    """Numpy copy of ``variables`` with every BatchNorm's scale / bias /
    mean / var drawn at random. Scale in [0.7, 1.1] and var in [0.9, 1.4]
    keep the random network's costs moderate (disparities spread over a
    few px): with BN gains around 1 the 30 BN layers compound into costs
    of magnitude ~80, whose float32 rounding soft-argmin amplifies to
    ~1e-3 px even between two correct implementations."""
    def walk(tree, in_bn):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, in_bn or k == "BatchNorm_0")
            elif in_bn and k == "scale":
                out[k] = rng.uniform(0.7, 1.1, v.shape).astype(np.float32)
            elif in_bn and k == "var":
                out[k] = rng.uniform(0.9, 1.4, v.shape).astype(np.float32)
            elif in_bn and k in ("bias", "mean"):
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.array(v)
        return out
    return walk(variables, False)


def pairs(n, shape, seed):
    rng = np.random.RandomState(seed)
    return [{"leftImage": rng.rand(*shape, 3).astype(np.float32) * 255,
             "rightImage": rng.rand(*shape, 3).astype(np.float32) * 255}
            for _ in range(n)]


@pytest.mark.parametrize("fused", [False, True])
def test_psmnet_inference_matches_jax(fused):
    over = dict(TINY, **{"model.eval.fused_upsample_argmin": fused})
    jmodel = japis.init_model("PSMNet/scene_flow_f32", **over)
    variables = randomize_bn(jax.tree.map(np.asarray, jmodel.variables),
                             np.random.RandomState(0))
    jmodel.variables = jax.tree.map(jnp.asarray, variables)
    tmodel = tapis.init_model("PSMNet/scene_flow_f32", device="cpu", **over)
    load_jax_variables(tmodel.module, variables)

    batch = pairs(3, (50, 60), seed=1)
    want = japis.inference_stereo(jmodel, batch, pad_to_shape=(64, 64))
    kernels.reset_launch_counts()
    got = tapis.inference_stereo(tmodel, batch, pad_to_shape=(64, 64))
    # on the CPU every wrapper ran its plain version and counted nothing
    assert set(kernels.launch_counts().values()) == {0}
    for w, g in zip(want, got):
        assert len(g["disps"]) == len(w["disps"]) == 3
        for wd, gd in zip(w["disps"], g["disps"]):
            assert gd.shape == wd.shape == (1, 50, 60, 1)
            np.testing.assert_allclose(gd, wd, atol=1e-3)


def test_scale_factor_and_crop_run_on_the_port():
    """inference_stereo's scale_factor and crop_shape paths against JAX's
    on the same weights, within 1e-4 px (the resizes add float32 rounding
    on both sides)."""
    tmodel = tapis.init_model("PSMNet/scene_flow_f32", device="cpu", **TINY)
    variables = randomize_bn(flax_variables(tmodel.module),
                             np.random.RandomState(4))
    load_jax_variables(tmodel.module, variables)
    jmodel = japis.StereoModel(jget_config("PSMNet/scene_flow_f32", **TINY),
                               jax.tree.map(jnp.asarray, variables))
    for batch, kwargs, shape in (
            (pairs(1, (40, 40), seed=2),
             dict(pad_to_shape=(64, 64), scale_factor=1.5,
                  disp_div_factor=2.0), (40, 40)),
            (pairs(1, (70, 80), seed=3), dict(crop_shape=(64, 64)),
             (64, 64))):
        got = tapis.inference_stereo(tmodel, batch, **kwargs)[0]["disps"]
        want = japis.inference_stereo(jmodel, batch, **kwargs)[0]["disps"]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.shape == w.shape == (1, *shape, 1)
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-4,
                                       err_msg=str(kwargs))


def test_port_imports_no_jax():
    # inference and one training step in float32 and in bfloat16 (PSMNet,
    # AcfNet, StereoNet, GCNet, DeepPruner, AnyNet; PWCFlow and RAFT
    # through the flow API and trainer), PSMNet with the Correlation cost
    # processor and the packed-conv microbench, with every module of the
    # port (parallel/ and the environment dump among them), its four
    # command-line tools and its measurement tools imported
    train = dict(TINY, **{"model.losses.l1_loss.max_disp": 64,
                          "data.batch_size_per_device": 1})
    # AcfNet adaptive (with the vis hook, the profiler window and the
    # TensorBoard writer) at max_disp 16
    acf = {"model.max_disp": 16,
           "model.cost_processor.cost_computation.max_disp": 4,
           "model.cost_processor.cost_aggregator.max_disp": 16,
           "model.disp_predictor.max_disp": 16,
           "model.losses.l1_loss.max_disp": 16,
           "model.losses.focal_loss.max_disp": 16,
           "model.cmn.in_planes": 16,
           "model.cmn.losses.nll_loss.max_disp": 16}
    flow = {"pwc": {"model.chans": (8, 16, 16), "model.radius": 2,
                    "model.hidden": 16, "model.losses.flow_l1_loss.weights":
                    (1.0, 1.0, 0.5, 0.25)},
            "raft": {"model.iters": 2, "model.hidden": 32,
                     "model.context": 16,
                     "model.losses.flow_l1_loss.weights": (1.0, 1.0, 0.8)}}
    code = f"""
import sys, tempfile
import numpy as np
from densematchingbenchmark_tpu_torch.apis import init_model, inference_stereo
from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.data import SyntheticStereoDataset, transforms
from densematchingbenchmark_tpu_torch.trainer import train_matcher
import densematchingbenchmark_tpu_torch.losses
import densematchingbenchmark_tpu_torch.ops.conv3d
import densematchingbenchmark_tpu_torch.ops.cuda
import densematchingbenchmark_tpu_torch.utils
import densematchingbenchmark_tpu_torch.utils.checkpoint
import densematchingbenchmark_tpu_torch.utils.logging
import densematchingbenchmark_tpu_torch.utils.mixed_precision
from densematchingbenchmark_tpu_torch.tools import microbench_packed
import densematchingbenchmark_tpu_torch.data.io
import densematchingbenchmark_tpu_torch.data.sampler
import densematchingbenchmark_tpu_torch.evaluation.eval_loop
import densematchingbenchmark_tpu_torch.evaluation.format
import densematchingbenchmark_tpu_torch.evaluation.metrics
import densematchingbenchmark_tpu_torch.ops.warp
import densematchingbenchmark_tpu_torch.visualization
import densematchingbenchmark_tpu_torch.evaluation.sparsification
import densematchingbenchmark_tpu_torch.ops.disp2prob
import densematchingbenchmark_tpu_torch.trainer.vis_hook
import densematchingbenchmark_tpu_torch.models.refinement
import densematchingbenchmark_tpu_torch.ops.patch_match
import densematchingbenchmark_tpu_torch.ops.spn
import densematchingbenchmark_tpu_torch.flow
import densematchingbenchmark_tpu_torch.flow.trainer
import densematchingbenchmark_tpu_torch.parallel
import densematchingbenchmark_tpu_torch.parallel.collectives
import densematchingbenchmark_tpu_torch.parallel.distributed
from densematchingbenchmark_tpu_torch.tools import bench, demo, test, train
from densematchingbenchmark_tpu_torch.tools import (
    benchmark, gen_annotations, loader_throughput, profile_model,
    train_throughput)
from densematchingbenchmark_tpu_torch.ops import correlation1d_volume
from densematchingbenchmark_tpu_torch.utils.collect_env import (
    collect_env_info, device_memory_stats)
print(collect_env_info(), device_memory_stats())
model = init_model("PSMNet/scene_flow_f32", device="cpu", **{TINY!r})
rng = np.random.RandomState(0)
img = rng.rand(64, 64, 3).astype(np.float32) * 255
inference_stereo(model, [{{"leftImage": img, "rightImage": img}}])
model = init_model("PSMNet/scene_flow_f32", device="cpu", **{TINY!r},
                   **{{"model.cost_processor.type": "Correlation"}})
inference_stereo(model, [{{"leftImage": img, "rightImage": img}}])
model = init_model("PSMNet/scene_flow_bf16", device="cpu", **{TINY!r})
inference_stereo(model, [{{"leftImage": img, "rightImage": img}}])
ds = SyntheticStereoDataset(length=1, height=32, width=64, max_disp=8)
ds.transform = transforms.make_train_transform((32, 64), (128.,) * 3, (64.,) * 3)
for name in ("PSMNet/scene_flow_f32", "PSMNet/scene_flow_bf16"):
    train_matcher(get_config(name, **{train!r}), tempfile.mkdtemp(),
                  train_dataset=ds, max_steps=1, device="cpu")
acf = {acf!r}
model = init_model("AcfNet/scene_flow_adaptive_f32", device="cpu", **acf)
import torch
out = model.forward(torch.zeros(1, 32, 64, 3), torch.zeros(1, 32, 64, 3))
assert out["confs"][0].shape == (1, 32, 64, 1)
train_matcher(get_config("AcfNet/scene_flow_adaptive_bf16", **acf,
                         **{{"data.batch_size_per_device": 1}}),
              tempfile.mkdtemp(), train_dataset=ds, eval_dataset=ds,
              max_steps=1, device="cpu", profile_steps=(1, 1))
st = {{"model.max_disp": 32,
       "model.cost_processor.cost_computation.max_disp": 4,
       "model.disp_predictor.max_disp": 4, "model.losses.l1_loss.max_disp": 32,
       "model.backbone.residual_num": 1}}
model = init_model("StereoNet/scene_flow_8x_4stage_f32", device="cpu", **st)
out = inference_stereo(model, [{{"leftImage": img, "rightImage": img}}])
assert len(out[0]["disps"]) == 4
train_matcher(get_config("StereoNet/scene_flow_8x_2stage_bf16", **st,
                         **{{"data.batch_size_per_device": 1}}),
              tempfile.mkdtemp(), train_dataset=ds, max_steps=1,
              device="cpu")
gc = {{"model.max_disp": 32, "model.cost_processor.cost_computation.max_disp": 16,
       "model.cost_processor.cost_aggregator.max_disp": 32,
       "model.disp_predictor.max_disp": 32, "model.losses.l1_loss.max_disp": 32,
       "data.batch_size_per_device": 1}}
model = init_model("GCNet/scene_flow_f32", device="cpu", **gc)
out = inference_stereo(model, [{{"leftImage": img, "rightImage": img}}])
assert out[0]["disps"][0].shape == (1, 64, 64, 1)
train_matcher(get_config("GCNet/scene_flow_bf16", **gc), tempfile.mkdtemp(),
              train_dataset=ds, max_steps=1, device="cpu")
dp = {{"model.max_disp": 64, "model.disp_sampler.iterations": 1,
       "model.losses.l1_loss.max_disp": 64,
       "model.losses.quantile_loss.max_disp": 64,
       "data.batch_size_per_device": 1}}
model = init_model("DeepPruner/scene_flow_8x_f32", device="cpu", **dp)
out = inference_stereo(model, [{{"leftImage": img, "rightImage": img}}])
assert len(out[0]["disps"]) == 5
ds64 = SyntheticStereoDataset(length=1, height=64, width=64, max_disp=8)
ds64.transform = transforms.make_train_transform((64, 64), (128.,) * 3, (64.,) * 3)
train_matcher(get_config("DeepPruner/scene_flow_4x_bf16", **dp),
              tempfile.mkdtemp(), train_dataset=ds64, max_steps=1, device="cpu")
model = init_model("AnyNet/scene_flow_f32", device="cpu")
out = inference_stereo(model, [{{"leftImage": img, "rightImage": img}}])
assert len(out[0]["disps"]) == 4
train_matcher(get_config("AnyNet/scene_flow_bf16",
                         **{{"data.batch_size_per_device": 1}}),
              tempfile.mkdtemp(), train_dataset=ds, max_steps=1, device="cpu")
from densematchingbenchmark_tpu_torch.apis import init_flow_model, inference_flow
from densematchingbenchmark_tpu_torch.flow import SyntheticFlowDataset, transforms as ftrans
from densematchingbenchmark_tpu_torch.flow.trainer import evaluate_flow
flow = {flow!r}
for name, over, size in (("PWCFlow/flying_chairs", flow["pwc"], 32),
                         ("RAFT/flying_chairs", flow["raft"], 64)):
    model = init_flow_model(name + "_f32", device="cpu", **over)
    out = inference_flow(model, [{{"leftImage": img, "rightImage": img}}],
                         pad_to_shape=(64, 64))
    assert np.isfinite(out[0]["flows"][0]).all()
    fds = SyntheticFlowDataset(length=2, height=size, width=size,
                               transform=ftrans.make_train_transform(
                                   (size, size), (128.,) * 3, (64.,) * 3))
    train_matcher(get_config(name + "_bf16", **over,
                             **{{"data.batch_size_per_device": 1}}),
                  tempfile.mkdtemp(), train_dataset=fds, max_steps=1,
                  device="cpu")
microbench_packed.run(cases=(("tiny", (1, 8, 4, 6), 8, 4),), iters=1,
                      device="cpu")
names = ("jax", "flax", "optax", "orbax", "densematchingbenchmark_tpu")
bad = [m for m in sys.modules if m in names
       or m.startswith(tuple(n + "." for n in names))]
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_init_model_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapis.init_model("PSMNet/scene_flow_f32", **TINY)


# (override, what JAX's builder does with it: the exception it raises,
# or None where it builds); a flow task on a stereo config has no flow
# meta-architecture (ValueError on both sides), an unknown
# meta-architecture raises ValueError and an unknown cost processor
# KeyError on both sides (ROADMAP fault 11)
@pytest.mark.parametrize("override,jax_does", [
    ({"model.backbone.type": "AnyNet"}, TypeError),
    ({"model.cost_processor.cost_aggregator.type": "AnyNet"}, KeyError),
    ({"model.backbone.type": "AnyNet",
      "model.cost_processor.type": "Correlation"}, TypeError),
    ({"model.cost_processor.type": "Correlation"}, None),
    ({"model.disp_refinement": {"type": "AnyNet"}}, None),
    ({"model.meta_architecture": "AnyNet"}, TypeError),
    ({"task": "flow"}, ValueError),
    ({"model.meta_architecture": "Foo"}, ValueError),
    ({"model.cost_processor.type": "Foo"}, KeyError),
], ids=[f"override{i}" for i in range(9)])
def test_unported_pieces_raise(override, jax_does):
    """Pieces of other families on a PSMNet config, as JAX's builder takes
    them: AnyNet's backbone takes no ``pack`` (TypeError), there is no
    AnyNet aggregator (KeyError), its refinement builds, and the AnyNet
    branch cannot read PSMNet's int sample range (TypeError). The
    Correlation cost processor builds on both sides into the same Flax
    tree (jax.eval_shape of JAX's init), whose first aggregator unit takes
    the one-channel volume; its forward and a train step against JAX's:
    tests/test_torch_correlation*.py. Unknown names raise what JAX
    raises."""
    cfg = get_config("PSMNet/scene_flow", **override)
    if jax_does is None:
        jmodel = jbuild_model(jget_config("PSMNet/scene_flow", **override))
        module = build_model(cfg)
        if "model.disp_refinement" in override:
            assert type(module.disp_refinement).__name__ == \
                "AnyNetRefinement"
            return
        dummy = jnp.zeros((1, 64, 128, 3))
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), dummy,
                                dummy)
        want = {k: tuple(v.shape) for k, v in flat(jax.tree.map(
            lambda s: np.empty(s.shape, np.float32), shapes)).items()}
        variables = flax_variables(module)
        assert {k: v.shape for k, v in flat(variables).items()} == want
        first = ("params", "cost_processor", "aggregator", "ConvUnit_0",
                 "Conv_0", "kernel")
        assert want[first] == (3, 3, 3, 1, 32)
        # the tree loads, and a leaf of another shape still raises
        load_jax_variables(module, variables)
        variables["params"]["cost_processor"]["aggregator"]["ConvUnit_0"][
            "Conv_0"]["kernel"] = np.zeros((3, 3, 3, 64, 32), np.float32)
        with pytest.raises(ValueError, match="shape"):
            load_jax_variables(module, variables)
        return
    with pytest.raises(jax_does):
        jbuild_model(jget_config("PSMNet/scene_flow", **override))
    with pytest.raises(jax_does):
        build_model(cfg)


def test_checkpoint_restore_not_ported(tmp_path):
    """init_model(checkpoint_dir=...) restores the parameters and BN
    statistics that train_matcher's CheckpointManager saved: the restored
    model's disparities are identical to the saved module's. With no
    checkpoint in the directory it keeps the seeded weights."""
    saved = build_model(get_config("PSMNet/scene_flow_f32", **TINY),
                        torch.Generator().manual_seed(5))
    load_jax_variables(saved, randomize_bn(flax_variables(saved),
                                           np.random.RandomState(5)))
    CheckpointManager(str(tmp_path)).save(3, {"module": saved.state_dict(),
                                              "step": 3})
    model = tapis.init_model("PSMNet/scene_flow_f32", device="cpu",
                             checkpoint_dir=str(tmp_path), **TINY)
    seeded = tapis.init_model("PSMNet/scene_flow_f32", device="cpu", **TINY)
    want = tapis.StereoModel(model.cfg, saved.eval(), torch.device("cpu"))
    batch = pairs(1, (50, 60), seed=6)
    got = tapis.inference_stereo(model, batch, pad_to_shape=(64, 64))
    ref = tapis.inference_stereo(want, batch, pad_to_shape=(64, 64))
    for g, w in zip(got[0]["disps"], ref[0]["disps"]):
        np.testing.assert_array_equal(g, w)
    empty = tapis.init_model("PSMNet/scene_flow_f32", device="cpu",
                             checkpoint_dir=str(tmp_path / "none"), **TINY)
    for a, b in zip(empty.module.state_dict().values(),
                    seeded.module.state_dict().values()):
        assert torch.equal(a, b)


def test_same_seed_same_weights_in_both_eval_modes():
    a = build_model(get_config("PSMNet/scene_flow_f32", **TINY),
                    torch.Generator().manual_seed(3))
    b = build_model(get_config("PSMNet/scene_flow_f32", **dict(
        TINY, **{"model.eval.fused_upsample_argmin": True})),
        torch.Generator().manual_seed(3))
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    n_params = sum(p.numel() for p in a.parameters())
    assert 5.0e6 < n_params < 5.5e6   # the reference PSMNet's 5.2 M
