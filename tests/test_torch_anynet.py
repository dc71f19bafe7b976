"""The port's AnyNet against the JAX package, on the CPU: the SPN scan in
its four directions and the gate normalisation, the soft-argmin over a
range that starts below zero, the pre-norm 3-D unit at each of AnyNet's
aggregator widths (in eval and training, float32 and bfloat16), the
backbone, each stage's aggregator and the refinement, the whole model's
disparities and costs in float32 and bfloat16, the Flax tree, the
kernels' routes and ``tools/test.main`` scoring
every disparity of the list.

Both sides build the shipped ``AnyNet/scene_flow`` config (its full
widths, C = 1) on 64x128 frames (sides multiples of 16). The JAX model
has no TPU schedule here (no ``pack`` in the config), so nothing runs a
Pallas kernel; each JAX function is traced and compiled once
(tests/acfnet_parity.jit_call). The weights are the port's seeded tree
with every BatchNorm's parameters and statistics and every conv bias
drawn at random (tests/acfnet_parity.randomize). Tolerances are stated
where they are asserted.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.configs import get_config as jget_config
from densematchingbenchmark_tpu.models import build_model as jbuild_model
from densematchingbenchmark_tpu.models import layers as jlayers
from densematchingbenchmark_tpu.ops import spn as jspn

from densematchingbenchmark_tpu_torch import apis as tapis
from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.models import layers as tlayers
from densematchingbenchmark_tpu_torch.models.anynet import AnyNet
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.ops import spn
from densematchingbenchmark_tpu_torch.tools import test as ttest
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

from acfnet_parity import flat, jit_call, randomize
from test_torch_stereonet import write_sceneflow_dataset

# the modules (the packages export the functions of the same name)
jsoft_argmin = importlib.import_module(
    "densematchingbenchmark_tpu.ops.soft_argmin")
tsoft_argmin = importlib.import_module(
    "densematchingbenchmark_tpu_torch.ops.soft_argmin")

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

NAME = "AnyNet/scene_flow"
B, H, W = 2, 64, 128
BF16_STEP = 2.0 ** -7


def shared_weights(cfg, seed=0):
    """The port's module of ``cfg`` with randomized weights, and the same
    weights as a numpy Flax tree."""
    module = build_model(cfg, torch.Generator().manual_seed(seed))
    variables = randomize(flax_variables(module), np.random.RandomState(seed))
    load_jax_variables(module, variables)
    return module, variables


def batch(seed=1):
    """Normalized images [B, H, W, 3] and GT [B, H, W, 1] with some pixels
    outside (0, 192): the masks are exercised."""
    rng = np.random.RandomState(seed)
    return {"leftImage": rng.randn(B, H, W, 3).astype(np.float32),
            "rightImage": rng.randn(B, H, W, 3).astype(np.float32),
            "leftDisp": rng.uniform(-8, 200, (B, H, W, 1)).astype(
                np.float32)}


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- pieces

DIRECTIONS = [(True, False), (True, True), (False, False), (False, True)]
# (in, out) widths of AnyNet's aggregator units with Co > 1 (init_guess:
# 8 -> 16, 16 -> 16; warp_level_8: 4 -> 4; warp_level_4: 2 -> 4, 4 -> 4)
# and a pre-norm unit without BN
UNITS = [(8, 16, True), (16, 16, True), (4, 4, True), (2, 4, True),
         (4, 4, False)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def spn_inputs():
    rng = np.random.RandomState(3)
    x, a, b, c = (rng.randn(2, 7, 9, 3).astype(np.float32)
                  for _ in range(4))
    return x, a, b, c


def unit_modules(ci, co, bn, dtype):
    """(port unit, JAX unit, variables) with random weights and BN."""
    tm = tlayers.bn_relu_conv3d(bn, ci, co, 3, 1, 1, bias=True,
                                dtype=DTYPES[dtype][0])
    tlayers.init_parameters(tm, torch.Generator().manual_seed(ci + co))
    variables = randomize(flax_variables(tm), np.random.RandomState(co))
    load_jax_variables(tm, variables)
    jm = jlayers.bn_relu_conv3d(bn, co, 3, 1, 1, bias=True,
                                dtype=DTYPES[dtype][1])
    return tm, jm, variables


def unit_input(ci):
    x = np.random.RandomState(ci).randn(2, 3, 5, 6, ci).astype(np.float32)
    # representable in bfloat16, so that both sides start from one input
    return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.fixture(scope="module")
def jax_pieces():
    """JAX's scans, gate normalisation, soft-argmins and pre-norm units,
    in one jitted call."""
    x, a, b, c = spn_inputs()
    rng = np.random.RandomState(4)
    cost = rng.randn(2, 5, 6, 7).astype(np.float32) * 3
    units = {(ci, co, bn, dt): unit_modules(ci, co, bn, dt)
             for ci, co, bn in UNITS for dt in DTYPES}
    args = {k: (jax.tree.map(jnp.asarray, v[2]), unit_input(k[0]))
            for k, v in units.items()}

    def run(x, a, b, c, cost, args):
        gates = jspn.normalize_gates(a, b, c)
        scans = [jspn.gate_recurrent_2d(x, *gates, horizontal=hz,
                                        reverse=rv)
                 for hz, rv in DIRECTIONS]
        vals = jnp.linspace(-2.0, 2.0, 5)[None, :, None, None]
        argmins = (jsoft_argmin.soft_argmin(cost, max_disp=5,
                                            start_disp=-2),
                   jsoft_argmin.soft_argmin(
                       cost, disp_sample=jnp.broadcast_to(vals, cost.shape)))
        outs = {}
        for k, (v, xin) in args.items():
            jm = units[k][1]
            ev = jm.apply(v, xin, train=False)
            tr, _ = jm.apply(v, xin, train=True, mutable=["batch_stats"])
            outs[k] = (ev.astype(jnp.float32), tr.astype(jnp.float32))
        return gates, scans, argmins, outs
    want = to_numpy(jit_call(run, x, a, b, c, cost, args))
    return want, units, cost


def test_normalize_gates_matches_jax(jax_pieces):
    want = jax_pieces[0][0]
    got = spn.normalize_gates(*(torch.from_numpy(t)
                                for t in spn_inputs()[1:]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
    total = sum(g.abs() for g in got)
    assert float(total.max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("direction", range(4))
def test_gate_recurrent_2d_matches_jax(jax_pieces, direction):
    """All four sweeps (left to right, right to left, top down, bottom
    up) within 1e-6: the same multiply-adds in the same order."""
    x = torch.from_numpy(spn_inputs()[0])
    gates = [torch.from_numpy(np.array(g)) for g in jax_pieces[0][0]]
    hz, rv = DIRECTIONS[direction]
    got = spn.gate_recurrent_2d(x, *gates, horizontal=hz, reverse=rv)
    want = jax_pieces[0][1][direction]
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_soft_argmin_with_a_negative_start_matches_jax(jax_pieces):
    """The warp stages' range (5 samples from -2) through the K2 wrapper
    (its plain version here), against JAX's uniform range and JAX's
    ``disp_sample`` form of the same values, as JAX's warp stages call
    it."""
    cost = torch.from_numpy(jax_pieces[2])
    got = tsoft_argmin.soft_argmin(cost, max_disp=5, start_disp=-2)
    for want in jax_pieces[0][2]:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert float(got.min()) < 0


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("unit", range(len(UNITS)))
def test_prenorm_unit_matches_jax(jax_pieces, unit, dtype, train):
    """The pre-norm 3-D unit (BN -> ReLU -> conv + bias) at each of
    AnyNet's widths, padded to the kernels' widths where they need it
    (float32: the 2 -> 4 unit to Ci 4; bfloat16: Ci to 16, Co to 8),
    against JAX's
    ``bn_relu_conv3d``: float32 within 1e-4 (another summation order);
    bfloat16 within 2 bfloat16 steps of the output's largest magnitude
    (the bound of tests/test_torch_bf16_units.py: the kernel adds the
    bias in float32 and rounds once, JAX rounds the conv and then adds
    the bias in bfloat16)."""
    ci, co, bn = UNITS[unit]
    tm = jax_pieces[1][(ci, co, bn, dtype)][0]
    assert tm.fusable and tm.pre_norm
    assert tm.padded == ((ci, co) == (2, 4) if dtype == "f32"
                         else (ci, co) != (16, 16))
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(unit_input(ci)))
    assert got.dtype == DTYPES[dtype][0] and got.shape[-1] == co
    want = jax_pieces[0][3][(ci, co, bn, dtype)][int(train)]
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2 * BF16_STEP * np.abs(want).max())


def test_prenorm_unit_eval_operands_ignore_its_bn():
    """A pre-norm unit's kept eval operands are keyed on its conv's weight
    and bias only: its BN stays outside the kernel, so a change of the BN
    statistics changes the output without a rebuild, and a change of the
    conv bias rebuilds them."""
    unit = tlayers.bn_relu_conv3d(True, 4, 4, 3, 1, 1).eval()
    x = torch.randn(1, 3, 4, 5, 4)
    with torch.no_grad():
        before = unit(x)
        builds = tlayers.ConvUnit.operand_builds
        unit.BatchNorm_0.running_mean.add_(0.5)
        moved = unit(x)
        assert tlayers.ConvUnit.operand_builds == builds
        assert not torch.equal(before, moved)
        unit.Conv_0.bias.add_(1.0)
        np.testing.assert_allclose(unit(x).numpy(), moved.numpy() + 1.0,
                                   atol=1e-5)
        assert tlayers.ConvUnit.operand_builds == builds + 1


# ------------------------------------------------------------ the model

@pytest.fixture(scope="module")
def weights():
    return shared_weights(get_config(NAME + "_f32"))[1]


def port_run(name, variables, images):
    """The port's eval outputs of ``name`` and its modules' outputs
    (forward hooks on the backbone, the three aggregators and the
    refinement)."""
    model = tapis.init_model(name, device="cpu")
    load_jax_variables(model.module, variables)
    pieces = {}
    for key in ("backbone", "agg_init_guess", "agg_warp_level_8",
                "agg_warp_level_4", "disp_refinement"):
        getattr(model.module, key).register_forward_hook(
            lambda m, i, o, key=key: pieces.__setitem__(key, o))
    kernels.reset_launch_counts()
    out = model.forward(torch.from_numpy(images["leftImage"]),
                        torch.from_numpy(images["rightImage"]))
    # on the CPU every wrapper ran its plain version and counted nothing
    assert set(kernels.launch_counts().values()) == {0}
    return model, out, pieces


@pytest.fixture(scope="module")
def eval_case(weights):
    """The port's and JAX's eval outputs in float32 (JAX's with every
    module's output, ``capture_intermediates``) and in bfloat16."""
    images = batch(1)
    cases = {}
    for name in (NAME + "_f32", NAME + "_bf16"):
        jmodel = jbuild_model(jget_config(name))
        capture = name.endswith("_f32")

        def apply(v, left, right):
            if not capture:
                return jmodel.apply(v, left, right, train=False)
            return jmodel.apply(v, left, right, train=False,
                                capture_intermediates=True,
                                mutable=["intermediates"])
        want = to_numpy(jit_call(apply, jax.tree.map(jnp.asarray, weights),
                                 images["leftImage"], images["rightImage"]))
        cases[name] = (*port_run(name, weights, images), want)
    return cases


def test_anynet_flax_tree_matches_jax(weights):
    """The port's module has exactly the leaves and shapes of JAX's Flax
    tree (jax.eval_shape of its init): 46,965 parameters, the backbone's
    conv_init / conv_down2 / down_{4,8,16}x_<i> / mix_{8,4}x_<i>, the
    aggregators agg_<stage>.ConvUnit_0..5 at the top level and the
    refinement's ConvUnit_0..2 and Conv_0..2; a leaf missing on the JAX
    side raises in the loader."""
    dummy = jnp.zeros((1, H, W, 3))
    shapes = jax.eval_shape(jbuild_model(jget_config(NAME + "_f32")).init,
                            jax.random.PRNGKey(0), dummy, dummy)
    want = {k: tuple(v.shape) for k, v in flat(jax.tree.map(
        lambda s: np.empty(s.shape, np.float32), shapes)).items()}
    got = {k: v.shape for k, v in flat(weights).items()}
    assert got == want
    assert sum(int(np.prod(s)) for k, s in got.items()
               if k[0] == "params") == 46965
    assert {k[1] for k in got} == {"backbone", "agg_init_guess",
                                   "agg_warp_level_8", "agg_warp_level_4",
                                   "disp_refinement"}
    module = build_model(get_config(NAME + "_f32"))
    bad = jax.tree.map(np.array, weights)
    del bad["params"]["disp_refinement"]["Conv_2"]
    with pytest.raises(KeyError, match="disp_refinement/Conv_2"):
        load_jax_variables(module, bad)


def test_anynet_pieces_match_jax(eval_case):
    """The backbone's three feature maps of each view, each stage's cost
    and the refinement's list against JAX's module outputs, within 1e-4
    of each output's largest magnitude (float32 library convs and
    kernels' plain versions summing in another order, through the warps
    of the earlier stages)."""
    _, out, pieces, want = eval_case[NAME + "_f32"]
    inter = want[1]["intermediates"]
    pairs = list(zip(pieces["backbone"][0] + pieces["backbone"][1],
                     inter["backbone"]["__call__"][0][0]
                     + inter["backbone"]["__call__"][0][1]))
    for st in ("init_guess", "warp_level_8", "warp_level_4"):
        pairs.append((pieces[f"agg_{st}"][0],
                      inter[f"agg_{st}"]["__call__"][0][0]))
    pairs += list(zip(pieces["disp_refinement"],
                      inter["disp_refinement"]["__call__"][0]))
    assert len(pairs) == 6 + 3 + 2
    for got, w in pairs:
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), w,
                                   atol=1e-4 * np.abs(w).max())


def test_anynet_eval_matches_jax(eval_case):
    """The four disparities (refined, 1/4, 1/8, 1/16 stages, at the
    input's resolution) within 1e-3 px and the three costs within 1e-4
    of their largest magnitude, float32 on both sides (no TF32 on the
    CPU)."""
    _, out, _, want = eval_case[NAME + "_f32"]
    want = want[0]
    assert len(out["disps"]) == len(want["disps"]) == 4
    for g, w in zip(out["disps"], want["disps"]):
        assert g.shape == w.shape == (B, H, W, 1) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-3)
    assert [c.shape[1:] for c in out["costs"]] == [
        (5, H // 4, W // 4), (5, H // 8, W // 8), (12, H // 16, W // 16)]
    for g, w in zip(out["costs"], want["costs"]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-4 * np.abs(w).max())


def test_anynet_bf16_eval_matches_jax(eval_case):
    """The bfloat16 model on both sides, the costs in float32. The three
    stages' disparities (the trunk: its units, the warps, the float32
    costs and soft-argmins) within 0.05 px mean of JAX's, the bound
    tests/test_torch_bf16_slice.py holds PSMNet to; they lie about 0.003
    px apart at this size, their values near 89 px. The refined
    disparity adds the SPN's bfloat16 residual, of the scale of the
    disparity itself (about 33 px here, where one bfloat16 step is 0.125
    to 0.25 px), and the two sides round at other points: on this batch
    JAX's own bfloat16-vs-float32 mean gap there is 0.32 px, the port's
    0.36 px, and the two bfloat16 runs lie 0.18 px apart. So the refined
    disparity within 0.25 px mean of JAX's, and the port's own gap
    between 0.8x and 1.25x JAX's: the lower side fails a refinement that
    ignores bfloat16. Every own gap is above 0 (the model does run in
    bfloat16)."""
    model, out, _, want = eval_case[NAME + "_bf16"]
    _, f32, _, jf32 = eval_case[NAME + "_f32"]
    assert model.cfg["model"]["dtype"] == "bfloat16"
    assert all(c.dtype == torch.float32 for c in out["costs"])
    for i, (g, w, g32, w32) in enumerate(zip(
            out["disps"], want["disps"], f32["disps"], jf32[0]["disps"])):
        assert g.dtype == torch.float32
        gap = np.abs(g.numpy() - w).mean()
        own, jax_own = (np.abs(g.numpy() - g32.numpy()).mean(),
                        np.abs(w - w32).mean())
        assert own > 0
        if i == 0:
            assert gap < 0.25, (gap, own, jax_own)
            assert 0.8 * jax_own <= own <= 1.25 * jax_own, (own, jax_own)
        else:
            assert gap < 0.05, (i, gap)


def test_anynet_runs_its_units_and_argmins_through_the_kernels(
        monkeypatch, weights):
    """The routes, spied on the CPU: a float32 eval forward calls K1's
    wrapper 15 times (the aggregators' pre-norm units with Co > 1, none
    of them padded past K1's widths except 2 -> 4), a bfloat16 eval
    forward K4's at pack 1 15 times, a training forward K4's 15 times in
    each dtype, and every forward the K2 wrapper 3 times, each over its
    stage's uniform range."""
    calls = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    spy(tlayers, "fused_conv3d")
    spy(tlayers, "conv3d_packed_s1")
    spy(tsoft_argmin, "fused_soft_argmin")
    x = torch.from_numpy(batch(2)["leftImage"][:1, :32, :64])
    for dtype in ("f32", "bf16"):
        module = build_model(get_config(f"{NAME}_{dtype}"))
        assert isinstance(module, AnyNet)
        units = [m for m in module.modules()
                 if isinstance(m, tlayers.ConvUnit) and m.fusable]
        assert len(units) == 15 and all(u.pre_norm for u in units)
        for train in (False, True):
            module.train(train)
            calls.clear()
            with torch.no_grad():
                module(x, x)
            names = [c[0] for c in calls]
            conv = ("fused_conv3d" if dtype == "f32" and not train
                    else "conv3d_packed_s1")
            assert names.count(conv) == 15, names
            assert len(names) == 18
            assert [c[1][1:3] for c in calls
                    if c[0] == "fused_soft_argmin"] == [(12, 0), (5, -2),
                                                        (5, -2)]


def test_test_tool_scores_every_anynet_disparity(tmp_path, capsys):
    """tools/test.main on the shipped config over a SceneFlow-layout set:
    one row of metrics for each of eval_disparity_id (0, 1, 2, 3), the
    same at batch 2 as at batch 1 (per-sample metrics, float32 sums in
    another order: 1e-4 px of EPE)."""
    root = str(tmp_path / "sf")
    ann = write_sceneflow_dataset(root, size=(60, 120))
    runs = []
    for bs in (2, 1):
        over = [f"model.eval.batch_size={bs}",
                "data.test.input_shape=(64, 128)",
                "data.test.use_right_disp=True"]
        results, n = ttest.main(["--cpu", "--config", NAME + "_f32",
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
