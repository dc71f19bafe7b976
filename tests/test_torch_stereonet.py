"""The port's StereoNet (8x, 2-stage and 4-stage) against the JAX package,
on the CPU: the difference volume, the backbone, the aggregator and the
edge-aware refinement, both configs' eval disparities, the bfloat16
slice and units, the GERF and smooth-L1 losses over the refinement list,
one train step (losses, gradients, BN statistics), the evaluation of
every disparity of the list through ``tools/test.main`` and
``tools/demo.py`` on JPEG pairs.

Both sides build StereoNet at max_disp 32 (4 cost disparities at 1/8
resolution, images 64x128) with 2 residual blocks in the backbone (the
refinement keeps its 6). The JAX side runs its plain schedule (``pack``
0: the same parameter tree, no Pallas interpret run), each function
jitted once (tests/acfnet_parity.jit_call). The weights are the port's
seeded tree with every BatchNorm's parameters and statistics and every
conv bias drawn at random (tests/acfnet_parity.randomize), carried to JAX
through ``flax_variables``. Tolerances are stated where they are
asserted.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.configs import get_config as jget_config
from densematchingbenchmark_tpu.losses import disp_losses as jdisp_losses
from densematchingbenchmark_tpu.losses import make_loss_evaluator as jmake_ev
from densematchingbenchmark_tpu.losses.builder import total_loss as jtotal
from densematchingbenchmark_tpu.models import build_model as jbuild_model
from densematchingbenchmark_tpu.models import layers as jlayers
from densematchingbenchmark_tpu.ops import cost_volume as jcost_volume

from densematchingbenchmark_tpu_torch import apis as tapis
from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.data import (SyntheticStereoDataset,
                                                   io)
from densematchingbenchmark_tpu_torch.losses import (gerf_loss,
                                                     make_loss_evaluator,
                                                     smooth_l1_loss)
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.models import layers as tlayers
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.ops.cost_volume import dif_volume
from densematchingbenchmark_tpu_torch.tools import demo as tdemo
from densematchingbenchmark_tpu_torch.tools import test as ttest
from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                      make_train_step)
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

from acfnet_parity import flat, jit_call, randomize

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

M = 32
B, H, W = 2, 64, 128
TWO = "StereoNet/scene_flow_8x_2stage"
FOUR = "StereoNet/scene_flow_8x_4stage"
BF16_STEP = 2.0 ** -7


def overrides(**extra):
    over = {"model.max_disp": M,
            "model.cost_processor.cost_computation.max_disp": M // 8,
            "model.disp_predictor.max_disp": M // 8,
            "model.losses.l1_loss.max_disp": M,
            "model.eval.upper_bound": M,
            "model.backbone.residual_num": 2,
            "model.cost_processor.cost_aggregator.pack": 0,
            "model.disp_refinement.pack": 0}
    over.update(extra)
    return over


def configs(name, **extra):
    """(JAX config, port config) of ``name`` at the tiny size."""
    return (jget_config(name, **overrides(**extra)),
            get_config(name, **overrides(**extra)))


def shared_weights(cfg, seed=0):
    """The port's module of ``cfg`` with randomized weights, and the same
    weights as a numpy Flax tree."""
    module = build_model(cfg, torch.Generator().manual_seed(seed))
    variables = randomize(flax_variables(module), np.random.RandomState(seed))
    load_jax_variables(module, variables)
    return module, variables


def batch(seed=1):
    """Normalized images [B, H, W, 3] and GT [B, H, W, 1] with some pixels
    outside (0, M): the masks are exercised."""
    rng = np.random.RandomState(seed)
    return {"leftImage": rng.randn(B, H, W, 3).astype(np.float32),
            "rightImage": rng.randn(B, H, W, 3).astype(np.float32),
            "leftDisp": rng.uniform(-2, M + 4, (B, H, W, 1)).astype(
                np.float32)}


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    """One tree for both configs: the 2-stage model's is the 4-stage one's
    without EdgeAwareRefinement_1 and _2."""
    _, cfg = configs(FOUR + "_f32")
    return shared_weights(cfg)[1]


def two_stage(variables):
    tree = jax.tree.map(np.array, variables)
    for i in (1, 2):
        del tree["params"]["disp_refinement"][f"EdgeAwareRefinement_{i}"]
        del tree["batch_stats"]["disp_refinement"][
            f"EdgeAwareRefinement_{i}"]
    return tree


@pytest.fixture(scope="module")
def eval_case(weights):
    """Per config name: the port's eval outputs and JAX's on one batch;
    the 4-stage float32 run also returns JAX's intermediates (each
    module's output, ``capture_intermediates``)."""
    images = batch(1)
    cases = {}
    for name in (TWO + "_f32", FOUR + "_f32", FOUR + "_bf16"):
        jcfg, cfg = configs(name)
        variables = weights if name.startswith(FOUR) else two_stage(weights)
        model = tapis.init_model(cfg, device="cpu")
        load_jax_variables(model.module, variables)
        jmodel = jbuild_model(jcfg)
        capture = name == FOUR + "_f32"

        def apply(v, left, right):
            if not capture:
                return jmodel.apply(v, left, right, train=False)
            return jmodel.apply(v, left, right, train=False,
                                capture_intermediates=True,
                                mutable=["intermediates"])
        want = to_numpy(jit_call(apply, jax.tree.map(jnp.asarray, variables),
                                 images["leftImage"], images["rightImage"]))
        kernels.reset_launch_counts()
        out = model.forward(torch.from_numpy(images["leftImage"]),
                            torch.from_numpy(images["rightImage"]))
        # on the CPU every wrapper ran its plain version and counted nothing
        assert set(kernels.launch_counts().values()) == {0}
        cases[name] = model, out, want
    return cases, images


# the loss builder's gerf_loss and l1_loss branches, as a config names them
BUILDER_LOSSES = {"gerf_loss": dict(max_disp=M, weights=(1.0, 0.5),
                                    weight=2.0),
                  "l1_loss": dict(max_disp=M, weights=(1.0, 0.5))}
DIF_CASES = [dict(max_disp=6), dict(max_disp=6, start_disp=-2, dilation=2),
             dict(max_disp=5, normalize=True),
             dict(max_disp=5, normalize=True, p=2.0)]


def dif_inputs():
    rng = np.random.RandomState(2)
    return tuple(rng.randn(2, 3, 9, 4).astype(np.float32) for _ in range(2))


def loss_inputs(seed, n):
    """``n`` full-resolution disparities and a GT with pixels outside
    (0, M)."""
    rng = np.random.RandomState(seed)
    gt = rng.uniform(-2, M + 4, (B, 16, 24, 1)).astype(np.float32)
    est = [rng.uniform(0, M, (B, 16, 24, 1)).astype(np.float32)
           for _ in range(n)]
    return est, gt


def loss_list():
    """The 4-stage list of full-resolution disparities with the config's
    weights (1.0, 0.5, 0.5, 0.5), and a half-resolution level."""
    est, gt = loss_inputs(6, 4)
    est.append(est[0][:, ::2, ::2])
    return est, gt, (1.0, 0.5, 0.5, 0.5, 0.7)


@pytest.fixture(scope="module")
def jax_pieces():
    """JAX's difference volumes and multi-level losses for every case, in
    one jitted call."""
    ref, tgt = dif_inputs()
    est, gt, weights = loss_list()

    evaluator = jmake_ev(BUILDER_LOSSES)

    def run(ref, tgt, est, gt):
        vols = [jcost_volume.dif_volume(ref, tgt, **kw) for kw in DIF_CASES]
        losses = {f"{loss}-{sparse}": getattr(jdisp_losses, loss)(
            est, gt, max_disp=M, start_disp=1, weights=weights,
            sparse=sparse)
            for loss in ("gerf_loss", "smooth_l1_loss")
            for sparse in (False, True)}
        losses["builder"] = evaluator(est[:2], None, gt)
        return vols, losses
    return to_numpy(jit_call(run, ref, tgt, est, gt))


@pytest.mark.parametrize("case", range(len(DIF_CASES)))
def test_dif_volume_matches_jax(jax_pieces, case):
    ref, tgt = dif_inputs()
    want = jax_pieces[0][case]
    got = dif_volume(torch.from_numpy(ref), torch.from_numpy(tgt),
                     **DIF_CASES[case]).numpy()
    assert got.shape == want.shape
    # subtractions are exact; the p-norm's sum and root within 1e-6
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_dif_volume_warped_path_is_not_ported():
    """The warped path (a per-pixel ``disp_sample``) arrived with DeepPruner
    (tests/test_torch_deeppruner.py holds it against JAX's): at integer
    samples it is the fixed-range volume's slice of the same shift."""
    ref, tgt = (torch.from_numpy(a) for a in dif_inputs())
    b, h, w, _ = ref.shape
    vals = torch.arange(6, dtype=torch.float32)
    samples = vals[None, :, None, None].expand(b, 6, h, w)
    got = dif_volume(ref, tgt, 6, disp_sample=samples)
    np.testing.assert_array_equal(got.numpy(),
                                  dif_volume(ref, tgt, 6).numpy())


def test_stereonet_flax_tree_matches_jax():
    """The port's 4-stage module has exactly the leaves and shapes of
    JAX's Flax tree (jax.eval_shape of its init, no compile):
    downsample_<i>, blocks_<i> and final in the backbone, ConvUnit_0..3
    and Conv_0 in the aggregator, EdgeAwareRefinement_0..2 (ConvUnit_0,
    BasicBlock_0..5, Conv_0) in the refinement. The 2-stage tree is this
    one without EdgeAwareRefinement_1 and _2: ``eval_case`` loads it into
    the port's 2-stage module (load_jax_variables raises on a leaf left
    unmatched on either side) and JAX applies its 2-stage model to it (a
    missing leaf raises)."""
    jcfg, cfg = configs(FOUR + "_f32")
    dummy = jnp.zeros((1, H, W, 3))
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0),
                            dummy, dummy)
    want = {k: tuple(v.shape) for k, v in flat(jax.tree.map(
        lambda s: np.empty(s.shape, np.float32), shapes)).items()}
    module, variables = shared_weights(cfg)
    got = {k: v.shape for k, v in flat(variables).items()}
    assert got == want
    assert {k[2] for k in got if k[:2] == ("params", "disp_refinement")} \
        == {f"EdgeAwareRefinement_{i}" for i in range(3)}
    assert {k[2] for k in got if k[:2] == ("params", "backbone")} == {
        "downsample_0", "downsample_1", "downsample_2", "blocks_0",
        "blocks_1", "final"}
    bad = jax.tree.map(np.array, variables)
    del bad["params"]["backbone"]["final"]
    with pytest.raises(KeyError, match="backbone/final"):
        load_jax_variables(module, bad)


def test_stereonet_pieces_match_jax(eval_case):
    """The backbone's features, the aggregator's cost and every refined
    disparity of the 4-stage model against JAX's module outputs, within
    1e-5 of each output's largest magnitude (float32 library convs
    summing in another order)."""
    cases, images = eval_case
    model, out, want = cases[FOUR + "_f32"]
    inter = want[1]["intermediates"]
    module = model.module
    left, right = (torch.from_numpy(images[k])
                   for k in ("leftImage", "rightImage"))
    with torch.no_grad():
        feats = module.backbone(left, right)
        raw = dif_volume(*feats, M // 8)
        costs = module.cost_processor.aggregator(raw)
    jfeats = inter["backbone"]["__call__"][0]
    assert len(feats) == len(jfeats) == 2
    jcost = inter["cost_processor"]["aggregator"]["__call__"][0]
    refined = inter["disp_refinement"]["__call__"][0]
    for got, w in [*zip(feats, jfeats), (costs[0], jcost[0]),
                   *zip(out["disps"], refined)]:
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), w,
                                   atol=1e-5 * np.abs(w).max())
    assert costs[0].dtype == torch.float32
    assert costs[0].shape == (B, M // 8, H // 8, W // 8)


@pytest.mark.parametrize("name", [TWO + "_f32", FOUR + "_f32"])
def test_stereonet_eval_matches_jax(eval_case, name):
    cases, _ = eval_case
    _, out, want = cases[name]
    if name.startswith(FOUR):
        want = want[0]
    n = 4 if name.startswith(FOUR) else 2
    assert len(out["disps"]) == len(want["disps"]) == n
    for g, w in zip(out["disps"], want["disps"]):
        assert g.shape == w.shape == (B, H, W, 1) and g.dtype == torch.float32
        # float32 in another summation order, through the soft-argmin and
        # the refinement's 13 full-resolution convs a stage
        np.testing.assert_allclose(g.numpy(), w, atol=1e-3)
    np.testing.assert_allclose(out["costs"][0].numpy(), want["costs"][0],
                               atol=1e-5 * np.abs(want["costs"][0]).max())


def test_stereonet_bf16_eval_matches_jax(eval_case):
    """The 4-stage model in bfloat16 on both sides. The initial disparity
    (the trunk, the float32 cost and the soft-argmin) within 0.05 px mean,
    the bound tests/test_torch_bf16_slice.py holds PSMNet to. A refined
    disparity adds a bfloat16 residual of the scale of the disparity
    itself (at random weights up to tens of px: one bfloat16 step is
    0.125-0.25 px there), and the two sides round at other points (XLA's
    CPU compiler elides the rounding of a conv before its BN); at this
    size JAX's own bfloat16-vs-float32 mean gap is 0.057 / 0.041 / 0.031
    px on the three refined disparities, the port's 0.062 / 0.044 /
    0.034, and the two bfloat16 runs lie 0.075 / 0.053 / 0.038 px apart.
    So every disparity within 0.1 px mean of JAX's, and the port's own
    bfloat16-vs-float32 gap between 0.8x and 1.25x JAX's on each
    disparity: the lower side fails a refinement that ignores bfloat16
    (run in float32 its own gap is 0.002 px, against JAX's 0.057)."""
    cases, _ = eval_case
    model, out, want = cases[FOUR + "_bf16"]
    _, f32, jf32 = cases[FOUR + "_f32"]
    assert model.cfg["model"]["dtype"] == "bfloat16"
    assert out["costs"][0].dtype == torch.float32
    gaps = []
    for g, w, g32, w32 in zip(out["disps"], want["disps"], f32["disps"],
                              jf32[0]["disps"]):
        assert g.dtype == torch.float32 and w.dtype == np.float32
        gap = np.abs(g.numpy() - w).mean()
        own, jax_own = (np.abs(g.numpy() - g32.numpy()).mean(),
                        np.abs(w - w32).mean())
        assert gap < 0.1, (gap, own, jax_own)
        assert 0.8 * jax_own <= own <= 1.25 * jax_own + 1e-3, (gap, own,
                                                               jax_own)
        gaps.append(gap)
    assert gaps[-1] < 0.05, gaps


# (kind, input channels, ConvUnit kwargs of both sides, input shape
# without its channels): the aggregator's fusable unit with its conv bias,
# the refinement's [disp || left] mix unit and a dilated residual conv
BF16_UNITS = {
    "aggregator": (32, dict(kernel_size=3, stride=1, padding=1, dims=3,
                            bias=True), (2, 4, 8, 16)),
    "mix": (4, dict(kernel_size=3, stride=1, padding=1, dims=2, bias=True),
            (2, 16, 32)),
    "dilated": (32, dict(kernel_size=3, stride=1, padding=1, dilation=4,
                         dims=2, bias=False), (2, 16, 32)),
}


@pytest.fixture(scope="module")
def bf16_units():
    """Per unit: its input, the port's module on random weights, and JAX's
    eval and train outputs, all in one jitted call."""
    rng = np.random.RandomState(5)
    cases, jmods, args = {}, {}, {}
    for kind, (cin, kw, shape) in BF16_UNITS.items():
        tm = tlayers.ConvUnit(cin, 32, dtype=torch.bfloat16, **kw)
        tlayers.init_parameters(tm, torch.Generator().manual_seed(3))
        variables = randomize(flax_variables(tm), rng)
        load_jax_variables(tm, variables)
        x = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32)) \
            .bfloat16().float().numpy()
        cases[kind] = (x, tm, variables)
        jmods[kind] = jlayers.ConvUnit(32, dtype=jnp.bfloat16, **kw)
        args[kind] = (jax.tree.map(jnp.asarray, variables), x)

    def run(a):
        out = {}
        for kind, (v, x) in a.items():
            ev = jmods[kind].apply(v, x, train=False)
            tr, _ = jmods[kind].apply(v, x, train=True,
                                      mutable=["batch_stats"])
            out[kind] = (ev.astype(jnp.float32), tr.astype(jnp.float32))
        return out
    return cases, to_numpy(jit_call(run, args))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", sorted(BF16_UNITS))
def test_stereonet_bf16_units_match_jax(bf16_units, kind, train):
    """Within 2 bfloat16 steps of the output's largest magnitude (the
    bound and the reasons of tests/test_torch_bf16_units.py)."""
    cases, want = bf16_units
    x, module, _ = cases[kind]
    module.train(train)
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    w = want[kind][int(train)]
    assert got.shape == w.shape
    np.testing.assert_allclose(got.float().numpy(), w,
                               atol=2 * BF16_STEP * np.abs(w).max())


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("loss", ["gerf_loss", "smooth_l1_loss"])
def test_losses_over_the_refinement_list_match_jax(jax_pieces, loss, sparse):
    """Over the 4-stage list of full-resolution disparities with the
    config's weights (1.0, 0.5, 0.5, 0.5), and a half-resolution level."""
    est, gt, weights = loss_list()
    want = jax_pieces[1][f"{loss}-{sparse}"]
    fn = {"gerf_loss": gerf_loss, "smooth_l1_loss": smooth_l1_loss}[loss]
    got = fn([torch.from_numpy(e) for e in est], torch.from_numpy(gt),
             max_disp=M, start_disp=1, weights=weights, sparse=sparse)
    assert sorted(got) == sorted(want) and len(got) == 5
    for k in want:
        # float32 sums over up to 768 terms in another order
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_gerf_loss_through_the_loss_builder_matches_jax(jax_pieces):
    est, gt, _ = loss_list()
    want = jax_pieces[1]["builder"]
    got = make_loss_evaluator(BUILDER_LOSSES)(
        [torch.from_numpy(e) for e in est[:2]], None, torch.from_numpy(gt))
    assert sorted(got) == sorted(want) == [
        "gerf_loss_lvl0", "gerf_loss_lvl1", "l1_loss_lvl0", "l1_loss_lvl1"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


class KeepGrads:
    """An optimizer that keeps the gradients of the step and updates
    nothing."""

    def __init__(self, module):
        self.names = [n for n, _ in module.named_parameters()]
        self.params = list(module.parameters())

    def step(self, grads, grad_norm=None):
        self.grads = dict(zip(self.names, grads))


@pytest.fixture(scope="module")
def train_case():
    """One train-mode step of the 2-stage model on both sides: the port's
    ``make_train_step``, and JAX's model and loss evaluator under one
    jitted ``jax.value_and_grad``."""
    jcfg, cfg = configs(TWO + "_f32")
    module, variables = shared_weights(cfg, seed=2)
    data = batch(3)
    opt = KeepGrads(module)
    state = TrainState.create(module, opt, seed=1)
    _, metrics = make_train_step(make_loss_evaluator(
        cfg["model"]["losses"]))(
        state, {k: torch.from_numpy(v) for k, v in data.items()})
    port = {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flat(flax_variables(module, opt.grads)["params"]),
            "batch_stats": flat(flax_variables(module)["batch_stats"])}

    jmodel = jbuild_model(jcfg)
    ev = jmake_ev(jcfg["model"]["losses"])

    def loss_fn(params, batch_stats):
        out, upd = jmodel.apply({"params": params,
                                 "batch_stats": batch_stats},
                                data["leftImage"], data["rightImage"],
                                train=True, mutable=["batch_stats"])
        ld = ev(out["disps"], out["costs"], data["leftDisp"])
        return jtotal(ld), (ld, upd["batch_stats"])

    v = jax.tree.map(jnp.asarray, variables)
    (loss, (ld, stats)), g = jit_call(jax.value_and_grad(
        loss_fn, has_aux=True), v["params"], v["batch_stats"])
    want = {"metrics": {"loss": float(loss),
                        **{k: float(x) for k, x in ld.items()}},
            "grads": flat(to_numpy(g)), "batch_stats": flat(to_numpy(stats))}
    return port, want


def test_stereonet_train_losses_match_jax(train_case):
    port, want = train_case
    keys = ["l1_loss_lvl0", "l1_loss_lvl1", "loss"]
    assert sorted(want["metrics"]) == keys
    assert sorted(port["metrics"]) == sorted(keys + ["grad_norm"])
    for k in keys:
        # the bound of tests/test_torch_acfnet_train.py
        np.testing.assert_allclose(port["metrics"][k], want["metrics"][k],
                                   rtol=3e-5, err_msg=k)


def test_stereonet_train_gradients_match_jax(train_case):
    """Per leaf, as tests/test_torch_train_step.py holds PSMNet's: cosine
    above 0.999 and relative L2 error below 3e-2. Some biases have a zero
    gradient in exact arithmetic: conv biases that feed batch-statistics
    BN (the aggregator's 4 units, the refinement's mix unit), the
    backbone's final bias, which both views' features carry and the
    difference volume cancels, and the aggregator's Co=1 bias, a shift of
    every disparity's cost to which the soft-argmin is blind. Those are
    float32 noise on both sides, below 1e-6 of the largest gradient."""
    port, want = train_case
    got, ref = port["grads"], want["grads"]
    assert sorted(got) == sorted(ref)
    top = max(float(np.abs(w).max()) for w in ref.values())
    zero = {k for k in got if k[-2:] == ("Conv_0", "bias")
            and k[:-2] + ("BatchNorm_0", "scale") in got}
    zero |= {("backbone", "final", "bias"),
             ("cost_processor", "aggregator", "Conv_0", "bias")}
    assert len(zero) == 7
    for k, g in got.items():
        w = ref[k]
        assert g.shape == w.shape, k
        if k in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-6 * top, k
            continue
        cos = float((g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w)))
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert cos > 0.999 and rel < 3e-2, ("/".join(k), cos, rel)


def test_stereonet_train_bn_stats_match_jax(train_case):
    port, want = train_case
    got = port["batch_stats"]
    assert sorted(got) == sorted(want["batch_stats"])
    for k, w in want["batch_stats"].items():
        # Flax E[x^2] - E[x]^2 vs torch's two-pass variance, float32
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg="/".join(k))


def write_sceneflow_dataset(root, n=3, size=(60, 120)):
    """SceneFlow-layout files (PNG images, PFM disparities of both views,
    an annotation JSON) from SyntheticStereoDataset. Returns the
    annotation file's path."""
    items = []
    for i in range(n):
        s = SyntheticStereoDataset(length=1, height=size[0], width=size[1],
                                   max_disp=M // 2, seed=i,
                                   with_right_disp=True).load(0)
        item = {}
        for key, rel, kind in (
                ("leftImage", f"left/{i:04d}.png", "left_image_path"),
                ("rightImage", f"right/{i:04d}.png", "right_image_path"),
                ("leftDisp", f"disp_left/{i:04d}.pfm", "left_disp_map_path"),
                ("rightDisp", f"disp_right/{i:04d}.pfm",
                 "right_disp_map_path")):
            path = os.path.join(root, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if key.endswith("Disp"):
                io.save_pfm(path, s[key][..., 0])
            else:
                io.save_png(path, np.clip(np.round(s[key]), 0, 255).astype(
                    np.uint8), filter_type=i % 5)
            item[kind] = rel
        items.append(item)
    ann = os.path.join(root, "sceneflow_test.json")
    with open(ann, "w") as fp:
        json.dump(items, fp)
    return ann


def test_test_tool_scores_every_refined_disparity(tmp_path, capsys):
    """tools/test.main on the 4-stage config over a SceneFlow-layout set:
    one row of metrics for each of eval_disparity_id (0, 1, 2, 3), the
    same at batch 2 as at batch 1 (per-sample metrics, float32 sums in
    another order: 1e-4 px of EPE)."""
    root = str(tmp_path / "sf")
    ann = write_sceneflow_dataset(root)
    runs = []
    for bs in (2, 1):
        over = [f"{k}={v}" for k, v in overrides(**{
            "model.eval.batch_size": bs,
            "data.test.input_shape": (64, 128),
            "data.test.use_right_disp": True}).items()]
        results, n = ttest.main(["--cpu", "--config", FOUR + "_f32",
                                 "--work-dir", str(tmp_path / "work"),
                                 "--data-root", root, "--annfile", ann,
                                 "--override", *over])
        assert n == 3
        runs.append(results)
    assert {k.split("/")[0] for k in runs[0]} == {f"disp_{i}"
                                                   for i in range(4)}
    for k, v in runs[0].items():
        assert np.isfinite(v) and abs(v - runs[1][k]) <= 1e-4 * max(
            1.0, abs(v)), k
    assert "disp_3" in capsys.readouterr().out


def test_demo_tool_reads_jpeg_pairs_with_stereonet(tmp_path, capsys):
    """tools/demo.py on a directory of JPEG pairs (read through imageio,
    as the JAX demo reads them) with the 2-stage config at full width:
    the best disparity of each pair at the image's size, finite and
    non-negative (the refinement's ReLU), as PFM and a colour PNG."""
    from PIL import Image
    rng = np.random.RandomState(4)
    img = (rng.rand(60, 120, 3) * 255).astype(np.uint8)
    for side, shift in (("left", 0), ("right", -3)):
        os.makedirs(tmp_path / side)
        Image.fromarray(np.roll(img, shift, 1)).save(
            str(tmp_path / side / "000.jpg"))
    out = tmp_path / "out"
    tdemo.main(["--cpu", "--config", TWO + "_f32", "--data-dir",
                str(tmp_path), "--out-dir", str(out)])
    disp, _ = io.load_pfm(str(out / "000.pfm"))
    assert disp.shape == (60, 120) and np.isfinite(disp).all()
    assert disp.min() >= 0
    assert io.load_png(str(out / "000.png")).shape == (60, 120, 3)
    assert "000: disp range" in capsys.readouterr().out
