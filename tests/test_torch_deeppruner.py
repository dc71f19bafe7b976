"""The port's DeepPruner pieces and its Best (4x) model against the JAX
package, on the CPU: ``inverse_warp_3d``, the per-pixel ``cat_volume`` /
``dif_volume``, ``patch_match`` under JAX's two scorings ('corr', the
shipped TPU schedule, and 'warp'), the sample ranges, ``HWHourglass``,
``quantile_loss`` (alone and through the loss builder), the 4x model's
eval under both scorings. The 8x model's eval:
tests/test_torch_deeppruner_8x.py (float32) and _bf16.py; both models'
Flax trees and one train step: tests/test_torch_deeppruner_train.py.

PatchMatch draws its initial particles' noise from a PRNG, and JAX's and
torch's cannot match bit for bit: the port is handed JAX's own draw
(``noise=``). At eval JAX draws ``uniform(PRNGKey(0), (1, n, H', W'))``
and broadcasts it over the batch (``patch_match``'s own test holds that a
sample's result does not depend on its batch). Models run at max_disp
64, batch 1, on 32x64 frames here (the 4x model's hourglasses need H / 32 whole) and
64x128 for the 8x model, with one PatchMatch iteration (two propagation
and evaluation rounds, W then H; the config's 3 make six, and JAX's
trace and compile of the model twice as long: about 7 s; ``patch_match``
below runs two iterations); the weights are the port's seeded tree with every
BatchNorm's parameters and statistics and every conv bias drawn at
random (tests/acfnet_parity.randomize), carried to JAX through
``flax_variables``; JAX's functions run jitted once per fixture
(tests/acfnet_parity.jit_call). Tolerances are stated where they are
asserted.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.configs import get_config as jget_config
from densematchingbenchmark_tpu.losses import disp_losses as jdisp_losses
from densematchingbenchmark_tpu.losses import make_loss_evaluator as jmake_ev
from densematchingbenchmark_tpu.models import build_model as jbuild_model
from densematchingbenchmark_tpu.models import layers as jlayers
from densematchingbenchmark_tpu.ops import cost_volume as jcost_volume
from densematchingbenchmark_tpu.ops import patch_match as jpatch_match
from densematchingbenchmark_tpu.ops import warp as jwarp

from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.losses import (make_loss_evaluator,
                                                     quantile_loss)
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.models import layers as tlayers
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.ops import patch_match as tpatch_match
from densematchingbenchmark_tpu_torch.ops.cost_volume import (cat_volume,
                                                              dif_volume)
from densematchingbenchmark_tpu_torch.ops.warp import inverse_warp_3d
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

from acfnet_parity import flat, jit_call, randomize

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

M = 64
B, H, W = 1, 32, 64
BEST, FAST = "DeepPruner/scene_flow_4x", "DeepPruner/scene_flow_8x"


def configs(name, **extra):
    """(JAX config, port config) of ``name`` at the tiny size."""
    over = {"model.max_disp": M,
            "model.disp_sampler.iterations": 1,
            "model.losses.l1_loss.max_disp": M,
            "model.losses.quantile_loss.max_disp": M,
            "model.eval.upper_bound": M}
    over.update(extra)
    return jget_config(name, **over), get_config(name, **over)


def shared_weights(cfg, seed=0):
    module = build_model(cfg, torch.Generator().manual_seed(seed))
    variables = randomize(flax_variables(module), np.random.RandomState(seed))
    load_jax_variables(module, variables)
    return module, variables


def batch(seed=1, size=(H, W), b=B):
    rng = np.random.RandomState(seed)
    return {"leftImage": rng.randn(b, *size, 3).astype(np.float32),
            "rightImage": rng.randn(b, *size, 3).astype(np.float32),
            "leftDisp": rng.uniform(-2, M + 4, (b, *size, 1)).astype(
                np.float32)}


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def eval_noise(scale, size, samples=14):
    """JAX's eval draw of the PatchMatch noise, [1, n, H', W'], for
    frames of ``size``."""
    return np.array(jax.random.uniform(
        jax.random.PRNGKey(0),
        (1, samples - 2, size[0] // scale, size[1] // scale), jnp.float32))


def run_eval(cases, images, variables):
    """Per case (config name, overrides): JAX's eval outputs (one jitted
    call for every case) and the port's, with JAX's noise injected. The
    port's 'corr' and 'warp' models are one function (the builder drops
    'corr': the warped scores are the same), so it runs once for both."""
    jmodels = {k: jbuild_model(configs(n, **o)[0])
               for k, (n, o) in cases.items()}

    def run(v, left, right):
        return {k: m.apply(v, left, right, train=False)
                for k, m in jmodels.items()}
    want = to_numpy(jit_call(run, jax.tree.map(jnp.asarray, variables),
                             images["leftImage"], images["rightImage"]))
    got, runs = {}, {}
    for k, (name, over) in cases.items():
        key = (name, tuple(sorted((o, v) for o, v in over.items()
                                  if o != "model.disp_sampler.scoring")))
        if key not in runs:
            cfg = configs(name, **over)[1]
            module = build_model(cfg)
            load_jax_variables(module, variables)
            module.eval()
            kernels.reset_launch_counts()
            with torch.no_grad():
                runs[key] = module(torch.from_numpy(images["leftImage"]),
                                   torch.from_numpy(images["rightImage"]),
                                   noise=torch.from_numpy(eval_noise(
                                       cfg["model"]["scale"],
                                       images["leftImage"].shape[1:3])))
            # on the CPU every wrapper ran its plain version, counting
            # nothing
            assert set(kernels.launch_counts().values()) == {0}
        got[k] = runs[key]
    return got, want


def assert_disps_match(out, ref, atol=1e-3):
    """Every disparity of the list (refined..., post, min, max) at full
    resolution within ``atol`` px of JAX's."""
    assert len(out["disps"]) == len(ref["disps"])
    for g, w in zip(out["disps"], ref["disps"]):
        assert g.shape == w.shape and g.shape[-1] == 1
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=atol)
    np.testing.assert_array_equal(out["min_disparity"].numpy(),
                                  out["disps"][-2].numpy())
    np.testing.assert_array_equal(out["max_disparity"].numpy(),
                                  out["disps"][-1].numpy())
    assert out["costs"] == []


def flax_tree_matches_jax(name, size):
    """The port's module of config ``name`` has exactly the leaves and
    shapes of JAX's Flax tree (jax.eval_shape of its init, no compile)."""
    jcfg, cfg = configs(name + "_f32")
    dummy = jnp.zeros((1, *size, 3))
    shapes = jax.eval_shape(
        jbuild_model(jcfg).init, {"params": jax.random.PRNGKey(0),
                                  "patch_match": jax.random.PRNGKey(1)},
        dummy, dummy)
    want = {k: tuple(v.shape) for k, v in flat(jax.tree.map(
        lambda s: np.empty(s.shape, np.float32), shapes)).items()}
    _, variables = shared_weights(cfg)
    assert {k: v.shape for k, v in flat(variables).items()} == want
    heads = 1 if name == BEST else 2
    assert {k[1] for k in want if k[0] == "params"} == {
        "backbone", "ConfidenceRangePredictor_0", "DeepPrunerAggregator_0",
        "Conv_0", "ConvUnit_0", *(f"RefinementHead_{i}"
                                  for i in range(heads))}


def test_deeppruner_flax_tree_matches_jax():
    flax_tree_matches_jax(BEST, (H, W))


@pytest.fixture(scope="module")
def best_case():
    """The 4x model's eval under JAX's shipped scoring ('corr') and
    'warp', on one tree of weights."""
    _, cfg = configs(BEST + "_f32")
    _, variables = shared_weights(cfg)
    cases = {s: (BEST + "_f32", {"model.disp_sampler.scoring": s})
             for s in ("corr", "warp")}
    return run_eval(cases, batch(1), variables)


@pytest.mark.parametrize("scoring", ["corr", "warp"])
def test_deeppruner_best_eval_matches_jax(best_case, scoring):
    """Every disparity within 1e-3 px of JAX's (float32 in another
    summation order, through PatchMatch's softmax selections and the
    refinement's convs; measured about 1e-5). JAX's 'corr' scores and
    the port's warped ones are the same function."""
    got, want = best_case
    assert len(got[scoring]["disps"]) == 4      # refined, post, min, max
    assert_disps_match(got[scoring], want[scoring])


# ---- the pieces, against JAX in one jitted call ----

WARP_SHAPE = (2, 5, 12, 4)          # [B, H, W, C]
PM_ARGS = dict(disparity_sample_number=8, propagation_filter_size=3,
               iterations=2, temperature=7.0)
PM_RANGE = 6
HG_SHAPE = (2, 3, 8, 16, 4)          # [B, D, H, W, C]


def piece_inputs():
    rng = np.random.RandomState(4)
    b, h, w, c = WARP_SHAPE
    fm = rng.randn(b, h, w, c).astype(np.float32)
    ref = rng.randn(b, h, w, c).astype(np.float32)
    # samples reaching past both edges of the frame, and fractional
    samples = rng.uniform(-3, w + 3, (b, 3, h, w)).astype(np.float32)
    left = rng.randn(2, 6, 16, 8).astype(np.float32)
    right = np.roll(left, -2, axis=2) + 0.1 * rng.randn(
        2, 6, 16, 8).astype(np.float32)
    lo = rng.uniform(0, 3, (2, 6, 16, 1)).astype(np.float32)
    hi = lo + rng.uniform(0, 12, lo.shape).astype(np.float32)
    gt = rng.uniform(-2, 20, (2, 6, 16, 1)).astype(np.float32)
    return dict(fm=fm, ref=ref, samples=samples, left=left, right=right,
                lo=lo, hi=hi, gt=gt,
                hg=rng.randn(*HG_SHAPE).astype(np.float32))


def pm_noise(b=2, h=6, w=16):
    n = PM_ARGS["disparity_sample_number"] - 2
    return np.array(jax.random.uniform(jax.random.PRNGKey(3), (b, n, h, w),
                                       jnp.float32))


@pytest.fixture(scope="module")
def pieces():
    """JAX's pieces on ``piece_inputs`` and the port's HWHourglass with its
    random weights, in one jitted call."""
    x = piece_inputs()
    hg = tlayers.HWHourglass(4)
    tlayers.init_parameters(hg, torch.Generator().manual_seed(5))
    variables = randomize(flax_variables(hg), np.random.RandomState(6))
    load_jax_variables(hg, variables)
    jhg = jlayers.HWHourglass(4)
    zeros = np.zeros_like(x["lo"])
    evaluator = jmake_ev({"l1_loss": dict(max_disp=16, weights=(1.0,)),
                          "quantile_loss": dict(max_disp=16, weight=2.0,
                                                theta=0.1)})

    def run(x, v):
        out = {}
        for compat in (False, True):
            out[f"warp-{compat}"] = jwarp.inverse_warp_3d(
                x["fm"], x["samples"], compat_grid_sample=compat)
            out[f"cat-{compat}"] = jcost_volume.cat_volume(
                x["ref"], x["fm"], 8, disp_sample=x["samples"],
                compat_grid_sample=compat)
            out[f"dif-{compat}"] = jcost_volume.dif_volume(
                x["ref"], x["fm"], 8, disp_sample=x["samples"],
                compat_grid_sample=compat)
        out["dif-norm"] = jcost_volume.dif_volume(
            x["ref"], x["fm"], 8, disp_sample=x["samples"], normalize=True)
        key = jax.random.PRNGKey(3)
        out["pm-warp"] = jpatch_match.patch_match(
            x["left"], x["right"], zeros, zeros + PM_RANGE, key, **PM_ARGS)
        out["pm-corr"] = jpatch_match.patch_match(
            x["left"], x["right"], zeros, zeros + PM_RANGE, key,
            static_search_range=PM_RANGE, **PM_ARGS)
        out["pm-range"] = jpatch_match.patch_match(
            x["left"], x["right"], x["lo"], x["hi"], key, **PM_ARGS)
        lo, hi = jpatch_match.adjust_sample_range(x["lo"], x["hi"], 9, 10.0)
        out["adjust"] = (lo, hi)
        out["uniform"] = jpatch_match.uniform_sample(lo, hi, 9)
        out["quantile"] = jdisp_losses.quantile_loss(
            x["lo"], x["hi"], x["gt"], 16, start_disp=1, weight=2.0,
            theta=0.1)
        out["builder"] = evaluator([x["lo"]], None, x["gt"],
                                   min_disparity=x["lo"],
                                   max_disparity=x["hi"])
        out["hg-eval"] = jhg.apply(v, x["hg"], train=False)
        out["hg-train"] = jhg.apply(v, x["hg"], train=True,
                                    mutable=["batch_stats"])[0]
        return out
    return x, hg, to_numpy(jit_call(run, x, jax.tree.map(jnp.asarray,
                                                         variables)))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("compat", [False, True])
def test_inverse_warp_3d_matches_jax(pieces, compat):
    """Exact (float32 lerps of the same two taps: 1e-6), both outputs."""
    x, _, want = pieces
    warped, valid = inverse_warp_3d(t(x["fm"]), t(x["samples"]),
                                    compat_grid_sample=compat)
    assert warped.shape == (2, 3, 5, 12, 4) and valid.shape == (2, 3, 5, 12,
                                                                 1)
    np.testing.assert_allclose(warped.numpy(), want[f"warp-{compat}"][0],
                               atol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), want[f"warp-{compat}"][1])


@pytest.mark.parametrize("kind", ["cat-False", "cat-True", "dif-False",
                                  "dif-True", "dif-norm"])
def test_volumes_with_disp_sample_match_jax(pieces, kind):
    """The per-pixel path of both volumes (the reference's masking and
    its compat quirk, the difference volume's norm): 1e-6."""
    x, _, want = pieces
    fn = cat_volume if kind.startswith("cat") else dif_volume
    kw = ({"normalize": True} if kind == "dif-norm"
          else {"compat_grid_sample": kind.endswith("True")})
    got = fn(t(x["ref"]), t(x["fm"]), 8, disp_sample=t(x["samples"]), **kw)
    assert got.shape == want[kind].shape
    np.testing.assert_allclose(got.numpy(), want[kind], atol=1e-6)


@pytest.mark.parametrize("case", ["pm-warp", "pm-corr", "pm-range"])
def test_patch_match_matches_jax(pieces, case):
    """The port's warped scores against JAX's 'warp' and 'corr' (its
    static tent windows) on [0, 6], and on a per-pixel range, with JAX's
    noise injected: the samples within 1e-4 px (the bound JAX holds its
    'corr' to its 'warp' by, tests/models/test_deeppruner.py); (min, the
    n, max) in that order."""
    x, _, want = pieces
    lo, hi = ((t(x["lo"]), t(x["hi"])) if case == "pm-range" else
              (torch.zeros(2, 6, 16, 1), torch.full((2, 6, 16, 1),
                                                    float(PM_RANGE))))
    got = tpatch_match.patch_match(t(x["left"]), t(x["right"]), lo, hi,
                                   noise=t(pm_noise()), **PM_ARGS)
    assert got.shape == (2, 8, 6, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[case], atol=1e-4)


def test_patch_match_noise_sources():
    """Without ``noise`` the eval draw is one batch-1 draw seeded 0, made
    once per shape and device and broadcast over the batch (a sample's
    samples do not depend on its batch); with a generator, a [B, n, H, W]
    draw from it, and the generator advances."""
    rng = np.random.RandomState(8)
    left = t(rng.randn(3, 6, 16, 8).astype(np.float32))
    right = t(rng.randn(3, 6, 16, 8).astype(np.float32))
    lo = torch.zeros(3, 6, 16, 1)
    args = dict(PM_ARGS)
    a = tpatch_match.patch_match(left, right, lo, lo + 6, **args)
    b = tpatch_match.patch_match(left[1:2], right[1:2], lo[:1], lo[:1] + 6,
                                 **args)
    np.testing.assert_array_equal(a[1:2].numpy(), b.numpy())
    drawn = tpatch_match.eval_noise(6, 6, 16, torch.device("cpu"))
    assert drawn is tpatch_match.eval_noise(6, 6, 16, torch.device("cpu"))
    np.testing.assert_array_equal(drawn.numpy(), torch.rand(
        (1, 6, 6, 16), generator=torch.Generator().manual_seed(0)).numpy())
    gen = torch.Generator().manual_seed(5)
    c = tpatch_match.patch_match(left, right, lo, lo + 6, generator=gen,
                                 **args)
    want = torch.rand((3, 6, 6, 16),
                      generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(c.numpy(), tpatch_match.patch_match(
        left, right, lo, lo + 6, noise=want, **args).numpy())
    assert not torch.equal(gen.get_state(),
                           torch.Generator().manual_seed(5).get_state())


def test_sample_ranges_match_jax(pieces):
    """``adjust_sample_range`` (upstream DeepPruner's half-shortfall
    stretch, clipped to [0, max_disp]) and ``uniform_sample``: 1e-6."""
    x, _, want = pieces
    lo, hi = tpatch_match.adjust_sample_range(t(x["lo"]), t(x["hi"]), 9,
                                              10.0)
    np.testing.assert_allclose(lo.numpy(), want["adjust"][0], atol=1e-6)
    np.testing.assert_allclose(hi.numpy(), want["adjust"][1], atol=1e-6)
    uni = tpatch_match.uniform_sample(lo, hi, 9)
    assert uni.shape == (2, 9, 6, 16)
    np.testing.assert_allclose(uni.numpy(), want["uniform"], atol=1e-6)


def test_quantile_loss_matches_jax(pieces):
    """Alone and through the loss builder (its ``quantile_loss`` entry
    beside the l1 levels): float32 sums of 192 terms in another order,
    1e-6 relative."""
    x, _, want = pieces
    got = quantile_loss(t(x["lo"]), t(x["hi"]), t(x["gt"]), 16,
                        start_disp=1, weight=2.0, theta=0.1)
    np.testing.assert_allclose(float(got), float(want["quantile"]),
                               rtol=1e-6)
    ev = make_loss_evaluator({"l1_loss": dict(max_disp=16, weights=(1.0,)),
                              "quantile_loss": dict(max_disp=16, weight=2.0,
                                                    theta=0.1)})
    out = ev([t(x["lo"])], None, t(x["gt"]), min_disparity=t(x["lo"]),
             max_disparity=t(x["hi"]))
    assert sorted(out) == sorted(want["builder"]) == ["l1_loss_lvl0",
                                                      "quantile_loss"]
    for k in out:
        np.testing.assert_allclose(float(out[k]), float(want["builder"][k]),
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_hw_hourglass_matches_jax(pieces, train):
    """DeepPruner's H/W hourglass on random weights, eval (running BN; its
    three stride-1 units fused) and train (batch statistics): within
    1e-5 of the output's largest magnitude (float32 convs in another
    order)."""
    x, hg, want = pieces
    assert [i for i in range(9)
            if getattr(hg, f"ConvUnit_{i}").fusable] == [1, 3, 5]
    hg.train(train)
    with torch.no_grad():
        got = hg(t(x["hg"]))
    w = want["hg-train" if train else "hg-eval"]
    assert got.shape == w.shape == HG_SHAPE
    np.testing.assert_allclose(got.numpy(), w, atol=1e-5 * np.abs(w).max())
