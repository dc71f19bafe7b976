"""The Correlation cost processor of the port against the JAX package, on
the CPU: ``ops.cost_volume.correlation1d_volume`` (both branches, in
float32 and bfloat16), and PSMNet (both eval modes), AcfNet and GCNet
built with ``model.cost_processor.type=Correlation``, whose aggregators
take the one-channel volume (one train step: the train file beside this
one).

The models run at tiny sizes (PSMNet and AcfNet at
tests/acfnet_parity.py's max_disp 16 on 2x32x64 frames, GCNet at max_disp
32 on 1x32x64) with JAX's TPU schedules off (``pack`` 0, GCNet's
``phase_argmin`` and ``split_concat``: the same parameters and function).
The weights are the port's seeded tree with every BatchNorm's parameters
and statistics and every conv bias drawn at random
(tests/acfnet_parity.randomize), carried to JAX through
``flax_variables``; JAX's three models run in one jitted call (the
port's fused eval mode is held against JAX's plain mode, the same
function). Tolerances are stated where they are asserted.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.configs import get_config as jget_config
from densematchingbenchmark_tpu.models import build_model as jbuild_model
from densematchingbenchmark_tpu.ops.cost_volume import (
    correlation1d_volume as jcorrelation1d_volume)

from densematchingbenchmark_tpu_torch import apis as tapis
from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.ops import correlation1d_volume
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

from acfnet_parity import flat, jit_call, randomize

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

CORR = {"model.cost_processor.type": "Correlation"}
M, GC_M = 16, 32
B, H, W = 2, 32, 64


def overrides(name, **extra):
    """The tiny size of ``name`` with a correlation volume and JAX's TPU
    schedules off."""
    m = GC_M if name.startswith("GCNet") else M
    over = {"model.max_disp": m,
            "model.cost_processor.cost_computation.max_disp":
                m // 2 if name.startswith("GCNet") else m // 4,
            "model.cost_processor.cost_aggregator.max_disp": m,
            "model.disp_predictor.max_disp": m,
            "model.losses.l1_loss.max_disp": m,
            "model.eval.upper_bound": m,
            "model.cost_processor.cost_aggregator.pack": 0, **CORR}
    if name.startswith("GCNet"):
        over.update({
            "model.cost_processor.cost_aggregator.phase_argmin": False,
            "model.cost_processor.cost_aggregator.split_concat": False})
    else:
        over["model.backbone.pack"] = 0
    if name.startswith("AcfNet"):
        over["model.losses.focal_loss.max_disp"] = m
    over.update(extra)
    return over


def configs(name, **extra):
    """(JAX config, port config) of ``name`` at the tiny size."""
    return (jget_config(name, **overrides(name, **extra)),
            get_config(name, **overrides(name, **extra)))


def shared_weights(cfg, seed=0):
    module = build_model(cfg, torch.Generator().manual_seed(seed))
    variables = randomize(flax_variables(module), np.random.RandomState(seed))
    load_jax_variables(module, variables)
    return module, variables


def features(seed, shape=(2, 5, 24, 16)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


# (max_disp, start_disp, dilation): the plain range, a negative start
# with a dilation, a start past 0 with a dilation of 3
RANGES = [(8, 0, 1), (6, -2, 2), (9, 3, 3)]


def bf16_step(ref, tgt, **kw):
    """One bfloat16 step at the magnitude the channel sum passes through,
    sum_c |ref_c tgt_c| rounded up to a power of two, at each cost
    element (the leaky ReLU's slope below 0 scales an error with its
    value)."""
    scale = correlation1d_volume(torch.from_numpy(np.abs(ref)).double(),
                                 torch.from_numpy(np.abs(tgt)).double(),
                                 **kw).numpy()
    return 2.0 ** (np.ceil(np.log2(np.maximum(scale, 1e-30))) - 7)


@pytest.mark.parametrize("rng_", RANGES, ids=["plain", "start-2_dil2",
                                              "start3_dil3"])
def test_correlation1d_volume_matches_jax(rng_):
    """The fixed range, JAX's zero fill on the columns whose shifted
    source leaves the frame, in float32 within 1e-5 and in bfloat16
    within one bfloat16 step of JAX's (bf16_step): both sides are within
    0.84 of 2^-8 of that magnitude of the float64 sum of the rounded
    inputs (measured), the port by one rounding of a float32 sum."""
    max_disp, start, dilation = rng_
    kw = dict(max_disp=max_disp, start_disp=start, dilation=dilation)
    ref, tgt = features(1)
    want = np.asarray(jcorrelation1d_volume(jnp.asarray(ref),
                                            jnp.asarray(tgt), **kw))
    got = correlation1d_volume(torch.from_numpy(ref), torch.from_numpy(tgt),
                               **kw)
    d = (max_disp + dilation - 1) // dilation
    assert got.shape == want.shape == (2, d, 5, 24)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (want < 0).any() and (want == 0).any()   # leaky side, zero fill
    rb, tb = (torch.from_numpy(x).bfloat16() for x in (ref, tgt))
    want = np.asarray(jcorrelation1d_volume(
        jnp.asarray(ref, jnp.bfloat16), jnp.asarray(tgt, jnp.bfloat16),
        **kw).astype(jnp.float32))
    got = correlation1d_volume(rb, tb, **kw)
    assert got.dtype == torch.bfloat16
    step = bf16_step(rb.float().numpy(), tb.float().numpy(), **kw)
    assert (np.abs(got.float().numpy() - want) <= step).all()


def test_correlation1d_volume_per_pixel_samples_match_jax():
    """The ``disp_sample`` branch: the target warped by each per-pixel
    sample (sub-pixel, some outside the frame), the reference unmasked;
    float32 within 1e-5, bfloat16 within one step (as above)."""
    ref, tgt = features(2)
    rng = np.random.RandomState(3)
    sample = rng.uniform(-2, 10, (2, 4, 5, 24)).astype(np.float32)
    want = np.asarray(jcorrelation1d_volume(
        jnp.asarray(ref), jnp.asarray(tgt), 8,
        disp_sample=jnp.asarray(sample)))
    got = correlation1d_volume(torch.from_numpy(ref), torch.from_numpy(tgt),
                               8, disp_sample=torch.from_numpy(sample))
    assert got.shape == want.shape == (2, 4, 5, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    rb, tb = (torch.from_numpy(x).bfloat16() for x in (ref, tgt))
    want = np.asarray(jcorrelation1d_volume(
        jnp.asarray(ref, jnp.bfloat16), jnp.asarray(tgt, jnp.bfloat16), 8,
        disp_sample=jnp.asarray(sample)).astype(jnp.float32))
    got = correlation1d_volume(rb, tb, 8,
                               disp_sample=torch.from_numpy(sample))
    # the step at the magnitude of the warped products: the warp's two
    # taps are a convex combination, so |warped| <= the larger tap
    scale = correlation1d_volume(rb.double().abs(), tb.double().abs(), 8,
                                 disp_sample=torch.from_numpy(
                                     sample).double()).numpy()
    bound = 2.0 ** (np.ceil(np.log2(np.maximum(scale, 1e-30))) - 7)
    assert (np.abs(got.float().numpy() - want) <= bound).all()


# the eval cases: (config name, overrides, the JAX case it is held
# against); the port's fused mode is held against JAX's plain mode, the
# same function (K3's plain version against JAX's Pallas kernel:
# tests/test_torch_ops.py), which saves tracing and compiling a fourth
# JAX model
CASES = {"psmnet": ("PSMNet/scene_flow_f32", {}, "psmnet"),
         "psmnet_fused": ("PSMNet/scene_flow_f32",
                          {"model.eval.fused_upsample_argmin": True},
                          "psmnet"),
         "acfnet": ("AcfNet/scene_flow_uniform_f32", {}, "acfnet"),
         "gcnet": ("GCNet/scene_flow_f32", {}, "gcnet")}


def images(seed, b):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, H, W, 3).astype(np.float32),
            rng.randn(b, H, W, 3).astype(np.float32))


@pytest.fixture(scope="module")
def eval_case():
    """Per case: the port's eval outputs and JAX's on one batch; JAX's
    three models in one jitted call. The two PSMNet cases share weights
    and inputs."""
    cases, jmodels, trees, data = {}, {}, {}, {}
    for k, (name, over, ref) in CASES.items():
        jcfg, cfg = configs(name, **over)
        _, variables = shared_weights(cfg)
        cases[k] = (cfg, variables, images(1, 1 if k == "gcnet" else B))
        if ref == k:
            jmodels[k], trees[k], data[k] = (jbuild_model(jcfg), variables,
                                             cases[k][2])
            assert jmodels[k].cost_processor.volume_type == "correlation"
    assert cases["psmnet_fused"][0]["model"]["eval"][
        "fused_upsample_argmin"]

    def run(trees, data):
        return {k: m.apply(trees[k], *data[k], train=False)
                for k, m in jmodels.items()}
    want = jax.tree.map(np.asarray, jit_call(
        run, jax.tree.map(jnp.asarray, trees), data))
    want = {k: want[ref] for k, (_, _, ref) in CASES.items()}
    got = {}
    for k, (cfg, variables, (left, right)) in cases.items():
        model = tapis.init_model(cfg, device="cpu")
        load_jax_variables(model.module, variables)
        kernels.reset_launch_counts()
        got[k] = model.forward(torch.from_numpy(left),
                               torch.from_numpy(right))
        # on the CPU every wrapper ran its plain version, counting nothing
        assert set(kernels.launch_counts().values()) == {0}
        got[k]["model"] = model.module
    return got, want


@pytest.mark.parametrize("case", list(CASES))
def test_correlation_models_match_jax(eval_case, case):
    """Every disparity within 1e-3 px of JAX's (float32 convolutions
    summing in another order, through soft-argmin); the aggregator's first
    unit takes the one-channel volume."""
    got, want = eval_case
    out, ref = got[case], want[case]
    assert len(out["disps"]) == len(ref["disps"]) == (1 if case == "gcnet"
                                                       else 3)
    for g, w in zip(out["disps"], ref["disps"]):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-3)
    assert out["model"].fused_upsample_argmin == (case == "psmnet_fused")
    agg = out["model"].cost_processor.aggregator
    assert agg.ConvUnit_0.in_features == 1
    if case == "gcnet":
        # c21 takes the raw volume and c20 (32 channels); f stays 32
        assert agg.ConvUnit_2.in_features == 1 + 32
        assert agg.ConvUnit_13.features == 128


def test_correlation_flax_tree_matches_jax():
    """StereoNet's aggregator takes a correlation volume as JAX's does: its
    first unit's kernel is (3, 3, 3, 1, 32), and the port's module at the
    shipped widths has exactly the leaves and shapes of JAX's Flax tree
    (jax.eval_shape of its init). PSMNet's full-width tree:
    tests/test_torch_psmnet.py::test_unported_pieces_raise; AcfNet's and
    GCNet's: the eval cases above apply JAX's models to the port's
    tree."""
    name = "StereoNet/scene_flow_8x_2stage_f32"
    jcfg, cfg = jget_config(name, **CORR), get_config(name, **CORR)
    dummy = jnp.zeros((1, 64, 128, 3))
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0),
                            dummy, dummy)
    want = {k: tuple(v.shape) for k, v in flat(jax.tree.map(
        lambda s: np.empty(s.shape, np.float32), shapes)).items()}
    module = build_model(cfg)
    assert {k: v.shape for k, v in flat(flax_variables(module)).items()} \
        == want
    assert want[("params", "cost_processor", "aggregator", "ConvUnit_0",
                 "Conv_0", "kernel")] == (3, 3, 3, 1, 32)


@pytest.mark.parametrize("name", ["AnyNet/scene_flow_f32",
                                  "DeepPruner/scene_flow_4x_f32"])
def test_correlation_type_is_ignored_where_jax_ignores_it(name):
    """JAX's AnyNet and DeepPruner branches never read
    cost_processor.type (their volumes are their own): both builders build
    the same model with Correlation as without."""
    assert jbuild_model(jget_config(name, **CORR)) == \
        jbuild_model(jget_config(name))
    a = build_model(get_config(name, **CORR))
    b = build_model(get_config(name))
    assert [(n, p.shape) for n, p in a.named_parameters()] == \
        [(n, p.shape) for n, p in b.named_parameters()]
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                  b.parameters()))
