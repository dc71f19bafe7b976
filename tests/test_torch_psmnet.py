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

from densematchingbenchmark_tpu_torch import apis as tapis
from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.utils import load_jax_variables

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
    model = tapis.init_model("PSMNet/scene_flow_f32", device="cpu", **TINY)
    batch = pairs(1, (40, 40), seed=2)
    out = tapis.inference_stereo(model, batch, pad_to_shape=(64, 64),
                                 scale_factor=1.5, disp_div_factor=2.0)
    assert out[0]["disps"][0].shape == (1, 40, 40, 1)
    crop = tapis.inference_stereo(model, pairs(1, (70, 80), seed=3),
                                  crop_shape=(64, 64))
    assert crop[0]["disps"][0].shape == (1, 64, 64, 1)
    assert all(np.isfinite(d).all() for d in out[0]["disps"]
               + crop[0]["disps"])


def test_port_imports_no_jax():
    # inference, then one training step, with every module of the port
    train = dict(TINY, **{"model.losses.l1_loss.max_disp": 64,
                          "data.batch_size_per_device": 1})
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
model = init_model("PSMNet/scene_flow_f32", device="cpu", **{TINY!r})
rng = np.random.RandomState(0)
img = rng.rand(64, 64, 3).astype(np.float32) * 255
inference_stereo(model, [{{"leftImage": img, "rightImage": img}}])
ds = SyntheticStereoDataset(length=1, height=32, width=64, max_disp=8)
ds.transform = transforms.make_train_transform((32, 64), (128.,) * 3, (64.,) * 3)
train_matcher(get_config("PSMNet/scene_flow_f32", **{train!r}),
              tempfile.mkdtemp(), train_dataset=ds, max_steps=1, device="cpu")
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


@pytest.mark.parametrize("override", [
    {"model.dtype": "bfloat16"},
    {"model.backbone.type": "GCNet"},
    {"model.cost_processor.cost_aggregator.type": "AcfNet"},
    {"model.cost_processor.type": "Correlation"},
    {"model.disp_predictor.type": "LOCAL"},
    {"model.meta_architecture": "AnyNet"},
    {"task": "flow"},
])
def test_unported_pieces_raise(override):
    with pytest.raises(NotImplementedError):
        build_model(get_config("PSMNet/scene_flow", **override))


def test_checkpoint_restore_not_ported():
    with pytest.raises(NotImplementedError):
        tapis.init_model("PSMNet/scene_flow_f32", device="cpu",
                         checkpoint_dir="/nonexistent")


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
