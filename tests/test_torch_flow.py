"""The port's PWCFlow against the JAX package's, on the CPU: the Flax
tree, every flow of the list in float32 (within 1e-3 px) and in
bfloat16, and ``apis.inference_flow``'s pad and crop against JAX's.

At the tiny size of tests/flow_parity.py (PWCFlow (8, 16, 16), radius 2,
hidden 16, 32x64 frames), on shared randomized weights; each JAX function
is traced and compiled once (tests/acfnet_parity.jit_call).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu import apis as japis
from densematchingbenchmark_tpu.configs import get_config as jget_config
from densematchingbenchmark_tpu.flow.models import (
    build_flow_model as jbuild_flow)

from densematchingbenchmark_tpu_torch import apis as tapis
from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.data import io as tio
from densematchingbenchmark_tpu_torch.flow import PWCFlow
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

from acfnet_parity import flat, jit_call
from flow_parity import OVERRIDES, PWC, configs, frames, shared_weights

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    return shared_weights(PWC)[1]


@pytest.fixture(scope="module")
def eval_case(weights):
    """The port's and JAX's eval-mode flows in float32 and bfloat16 on the
    same frames."""
    ref, tgt = frames(PWC)
    cases = {}
    for suffix in ("_f32", "_bf16"):
        jcfg, cfg = configs(PWC, suffix)
        module = build_model(cfg)
        load_jax_variables(module, weights)
        module.eval()
        kernels.reset_launch_counts()
        with torch.no_grad():
            out = module(torch.from_numpy(ref), torch.from_numpy(tgt))
        assert set(kernels.launch_counts().values()) == {0}
        jmodel = jbuild_flow(jcfg)
        want = to_numpy(jit_call(
            lambda v, a, b: jmodel.apply(v, a, b, train=False),
            jax.tree.map(jnp.asarray, weights), ref, tgt))
        cases[suffix] = ([f.numpy() for f in out["flows"]], want["flows"])
    return cases


def test_pwcflow_flax_tree_matches_jax(weights):
    """The port's module has exactly the leaves and shapes of JAX's Flax
    tree (jax.eval_shape of its init) at the shipped config's width
    (1,452,182 parameters; at the tiny size JAX's apply takes the port's
    tree in the eval tests): FlowPyramidEncoder_0's 2
    units a level, FlowEstimator_<i> from the coarsest level, and
    ContextRefinement_0's 6 units; a leaf missing raises in the
    loader."""
    dummy = jnp.zeros((1, 32, 64, 3))
    shapes = jax.eval_shape(jbuild_flow(jget_config(PWC + "_f32")).init,
                            jax.random.PRNGKey(0), dummy, dummy)
    want = {k: tuple(v.shape) for k, v in flat(jax.tree.map(
        lambda s: np.empty(s.shape, np.float32), shapes)).items()}
    module = build_model(get_config(PWC + "_f32"))
    assert isinstance(module, PWCFlow)
    got = {k: v.shape for k, v in flat(flax_variables(module)).items()}
    assert got == want
    assert sum(int(np.prod(s)) for k, s in got.items()
               if k[0] == "params") == 1452182
    assert {k[1] for k in got} == {"FlowPyramidEncoder_0", "FlowEstimator_0",
                                   "FlowEstimator_1", "FlowEstimator_2",
                                   "FlowEstimator_3", "ContextRefinement_0"}
    bad = jax.tree.map(np.array, weights)
    del bad["params"]["FlowEstimator_2"]["ConvUnit_1"]
    with pytest.raises(KeyError, match="FlowEstimator_2/ConvUnit_1"):
        load_jax_variables(build_model(configs(PWC)[1]), bad)


def test_pwcflow_eval_matches_jax(eval_case):
    """The four flows (the refined one at 32x64, then the levels at 1/2,
    1/4 and 1/8) within 1e-3 px of JAX's, float32 on both sides; the
    flows move by pixels (the score heads are peaked)."""
    got, want = eval_case["_f32"]
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (2, 32, 64, 2), (2, 16, 32, 2), (2, 8, 16, 2), (2, 4, 8, 2)]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-3)
    assert np.abs(want[0]).max() > 1.0


def test_pwcflow_bf16_eval_matches_jax(eval_case):
    """bfloat16 on both sides (the convs and features bfloat16, the warp's
    flow cast to bfloat16, the soft-argmax and flows float32): every flow
    within 0.05 px mean of JAX's, the bound the stereo slices are held
    to (they lie 0.0007-0.007 px apart here, each side's own
    bfloat16-vs-float32 gap 0.0004-0.008 px: the warp, the correlation's
    products and the units round at other points); each apart from the
    float32 flows (the model does run in bfloat16)."""
    got, want = eval_case["_bf16"]
    g32, _ = eval_case["_f32"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float32
        gap = np.abs(g - w).mean()
        assert gap < 0.05, (i, gap)
        assert np.abs(g - g32[i]).mean() > 0


def write_flow_pairs(root, n=2, size=(30, 60), seed=3):
    """Frame pairs as PPM files (left/ frame t, right/ frame t + 1)."""
    rng = np.random.RandomState(seed)
    for d in ("left", "right"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    pairs = []
    for i in range(n):
        a = (rng.rand(*size, 3) * 255).astype(np.uint8)
        b = np.roll(a, (1, 2), axis=(0, 1))
        tio.save_pnm(os.path.join(root, "left", f"{i}.ppm"), a)
        tio.save_pnm(os.path.join(root, "right", f"{i}.ppm"), b)
        pairs.append((a.astype(np.float32), b.astype(np.float32)))
    return pairs


def test_inference_flow_pads_and_crops_as_jax(weights, tmp_path,
                                             monkeypatch):
    """``inference_flow`` pads a 30x60 pair to 32x64 (bottom and right),
    normalizes, runs the model and crops each flow to [:30, :60]: within
    1e-3 px of JAX's ``inference_flow`` on the same weights, every level
    of the list. Without a GPU, ``init_flow_model`` raises unless the
    caller asks for the CPU, and it takes flow configs only."""
    (a, b), = write_flow_pairs(str(tmp_path), n=1)
    jcfg, cfg = configs(PWC)
    model = tapis.init_flow_model(cfg, device="cpu")
    load_jax_variables(model.module, weights)
    got = tapis.inference_flow(model, [{"leftImage": a, "rightImage": b,
                                        "name": "x"}], pad_to_shape=(32, 64))
    jmodel = japis.FlowModel(jcfg, jax.tree.map(jnp.asarray, weights))
    want = japis.inference_flow(jmodel, [{"leftImage": a, "rightImage": b}],
                                pad_to_shape=(32, 64))
    assert got[0]["name"] == "x"
    assert [f.shape for f in got[0]["flows"]] == [
        f.shape for f in want[0]["flows"]] == [
        (1, 30, 60, 2), (1, 16, 32, 2), (1, 8, 16, 2), (1, 4, 8, 2)]
    for g, w in zip(got[0]["flows"], want[0]["flows"]):
        np.testing.assert_allclose(g, w, atol=1e-3)
    with pytest.raises(ValueError, match="flow config"):
        tapis.init_flow_model("AnyNet/scene_flow_f32", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapis.init_flow_model(PWC + "_f32", **OVERRIDES[PWC])
