"""The port's AcfNet (uniform and adaptive) in evaluation against the JAX
package, and its new pieces one by one, on the CPU.

The models: both sides build AcfNet at max_disp 16 from their own configs
and run the same weights (tests/acfnet_parity.py) in eval mode, JAX's
forward jitted once per config in a module fixture. The pieces:
``disp2prob``, the stereo focal loss (and its gradients), the confidence
NLL loss, ``local_soft_argmin`` and the LOCAL predictor, the
sparsification curves and the confidence panels against JAX's functions
on the same numpy inputs; the builder's fusion rule; the Flax tree of the
AcfNet and Cmn modules; the vis hook, the TensorBoard routing and
``tools/test.main``'s sparsification rows. Tolerances are stated where
they are asserted.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.evaluation import (
    sparsification as jsparsification)
from densematchingbenchmark_tpu.losses import disp_losses as jdisp_losses
from densematchingbenchmark_tpu.losses import focal as jfocal
from densematchingbenchmark_tpu.models import build_model as jbuild_model
from densematchingbenchmark_tpu.ops import disp2prob as jdisp2prob
from densematchingbenchmark_tpu.ops.soft_argmin import (
    local_soft_argmin as jlocal_soft_argmin)
from densematchingbenchmark_tpu.utils import logging as jlogging
from densematchingbenchmark_tpu.visualization import show_result as jshow

from densematchingbenchmark_tpu_torch import apis as tapis
from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.evaluation import sparsification
from densematchingbenchmark_tpu_torch.losses import (conf_nll_loss,
                                                     stereo_focal_loss)
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.models.predictors import DispPredictor
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.ops import disp2prob
from densematchingbenchmark_tpu_torch.ops.soft_argmin import (
    local_soft_argmin)
from densematchingbenchmark_tpu_torch.tools import test as ttest
from densematchingbenchmark_tpu_torch.trainer.vis_hook import VisHook
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)
from densematchingbenchmark_tpu_torch.utils.logging import MetricsLogger
from densematchingbenchmark_tpu_torch.visualization import show_result

from acfnet_parity import (B, H, M, W, batch, configs, flat, jit_call,
                           overrides, shared_weights)

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

NAMES = ["AcfNet/scene_flow_uniform_f32", "AcfNet/scene_flow_adaptive_f32"]


def jax_eval(name, variables, images):
    jcfg, _ = configs(name)
    jmodel = jbuild_model(jcfg)
    out = jit_call(lambda v, l, r: jmodel.apply(v, l, r, train=False),
                   jax.tree.map(jnp.asarray, variables),
                   images["leftImage"], images["rightImage"])
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def eval_case():
    """Per config: the port's model with the shared weights, and JAX's
    eval outputs on the same batch."""
    images = batch(1)
    cases = {}
    for name in NAMES + ["AcfNet/scene_flow_adaptive_bf16"]:
        _, cfg = configs(name)
        model = tapis.init_model(cfg, device="cpu")
        _, variables = shared_weights(cfg, seed=0)
        load_jax_variables(model.module, variables)
        cases[name] = model, jax_eval(name, variables, images)
    return cases, images


def port_eval(model, images):
    kernels.reset_launch_counts()
    out = model.forward(torch.from_numpy(images["leftImage"]),
                        torch.from_numpy(images["rightImage"]))
    # on the CPU every wrapper ran its plain version and counted nothing
    assert set(kernels.launch_counts().values()) == {0}
    return {k: [t.float().numpy() for t in v] for k, v in out.items()}


@pytest.mark.parametrize("name", NAMES)
def test_acfnet_eval_matches_jax(eval_case, name):
    cases, images = eval_case
    model, want = cases[name]
    got = port_eval(model, images)
    keys = ["costs", "disps"]
    if "adaptive" in name:
        keys = ["conf_costs", "confs", "costs", "disps", "variances"]
    assert sorted(got) == sorted(want) == keys
    for k in keys:
        assert len(got[k]) == len(want[k]) == 3, k
        for g, w in zip(got[k], want[k]):
            shape = (B, M, H, W) if k == "costs" else (B, H, W, 1)
            assert g.shape == w.shape == shape, k
    for g, w in zip(got["disps"], want["disps"]):
        # float32 in another summation order through soft-argmin
        np.testing.assert_allclose(g, w, atol=1e-3)
    for k in ("confs", "variances"):
        for g, w in zip(got.get(k, ()), want.get(k, ())):
            # sigmoid of the confidence costs; measured up to 2e-6
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=k)


def test_acfnet_bf16_eval_matches_jax(eval_case):
    """The adaptive model in bfloat16 compute on both sides: the two round
    at other points (the port's fused trunk unit once after its epilogue),
    so they may differ by about as much as bfloat16 from float32
    (tests/test_torch_bf16_slice.py: a mean of 0.05 px)."""
    cases, images = eval_case
    model, want = cases["AcfNet/scene_flow_adaptive_bf16"]
    assert model.cfg["model"]["dtype"] == "bfloat16"
    got = port_eval(model, images)
    for g, w in zip(got["disps"], want["disps"]):
        assert g.dtype == w.dtype == np.float32
        assert np.abs(g - w).mean() < 0.05, np.abs(g - w).mean()
    for g, w in zip(got["confs"], want["confs"]):
        assert np.abs(g - w).mean() < 0.01, np.abs(g - w).mean()


def test_acfnet_flax_tree_matches_jax():
    """The port's AcfNet and Cmn modules have exactly the leaves and
    shapes of JAX's Flax tree (jax.eval_shape of its init, no compile):
    ConvUnit_0..6, Hourglass3D_0..2, Conv_0..2 and ConvTransposeExact_0..2
    in the aggregator, ConfHead_0..2 in the cmn. A leaf missing or of
    another shape makes load_jax_variables raise."""
    jcfg, cfg = configs("AcfNet/scene_flow_adaptive_f32")
    dummy = jnp.zeros((1, H, W, 3))
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0),
                            dummy, dummy)
    want = {k: tuple(v.shape) for k, v in flat(jax.tree.map(
        lambda s: np.empty(s.shape, np.float32), shapes)).items()}
    module, variables = shared_weights(cfg)
    got = {k: v.shape for k, v in flat(variables).items()}
    assert got == want
    agg = [k[4] for k in got if k[:4] == ("params", "cost_processor",
                                            "aggregator",
                                            "ConvTransposeExact_0")]
    assert agg == ["kernel"]
    assert {k[3] for k in got if k[:3] == ("params", "cmn",
                                           "ConfHead_2")} == {"ConvUnit_0",
                                                              "Conv_0"}
    bad = jax.tree.map(np.array, variables)
    bad["params"]["cmn"]["ConfHead_0"]["Conv_0"]["kernel"] = np.zeros(
        (1, 1, 4, 1), np.float32)
    with pytest.raises(ValueError, match="ConfHead_0/Conv_0/kernel"):
        load_jax_variables(module, bad)
    del bad["params"]["cost_processor"]["aggregator"]["ConvTransposeExact_1"]
    with pytest.raises(KeyError, match="ConvTransposeExact_1"):
        load_jax_variables(module, bad)


@pytest.mark.parametrize("name", NAMES + ["AcfNet/scene_flow_adaptive_bf16"])
@pytest.mark.parametrize("aggregator", ["AcfNet", "PSMNet"])
def test_fusion_rule_matches_jax(name, aggregator):
    """model.eval.fused_upsample_argmin fuses only without a cmn and with
    PSMNet's aggregator, as the JAX builder decides."""
    jcfg, cfg = configs(name, **{
        "model.eval.fused_upsample_argmin": True,
        "model.cost_processor.cost_aggregator.type": aggregator})
    want = jbuild_model(jcfg).fused_upsample_argmin
    assert build_model(cfg).fused_upsample_argmin == want == (
        aggregator == "PSMNet" and "cmn" not in cfg["model"])


def prob_inputs(seed, map_variance):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(-2, 14, (2, 5, 6, 1)).astype(np.float32)
    var = (rng.uniform(0.5, 2.0, (2, 5, 6, 1)).astype(np.float32)
           if map_variance else 1.3)
    return gt, var


@pytest.mark.parametrize("map_variance", [False, True])
@pytest.mark.parametrize("fn", ["laplace_prob", "gaussian_prob",
                                "onehot_prob"])
def test_disp2prob_matches_jax(fn, map_variance):
    gt, var = prob_inputs(3, map_variance)
    if map_variance and fn == "onehot_prob":
        # the one-hot variant takes a map that broadcasts as it is
        var = np.ascontiguousarray(np.moveaxis(var, -1, 1))
    kwargs = dict(max_disp=12, start_disp=1, dilation=2)
    want = np.asarray(getattr(jdisp2prob, fn)(
        jnp.asarray(gt), variance=jnp.asarray(var) if map_variance else var,
        **kwargs))
    got = getattr(disp2prob, fn)(
        torch.from_numpy(gt),
        variance=torch.from_numpy(var) if map_variance else var,
        **kwargs).numpy()
    assert got.shape == want.shape == (2, 6, 5, 6)
    # softmax over 6 samples in another order; EPS kept on the port's side
    # (1e-40, a float32 subnormal) where XLA may flush it
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def focal_inputs(seed, half_res):
    """Two levels of costs, the second at half resolution if
    ``half_res`` (the GT rescaled to it), a GT and a variance map."""
    rng = np.random.RandomState(seed)
    costs = [rng.randn(2, 16, 8, 12).astype(np.float32) * 3,
             (rng.randn(2, 8, 4, 6) if half_res else
              rng.randn(2, 16, 8, 12)).astype(np.float32) * 3]
    gt = rng.uniform(-1, 18, (2, 8, 12, 1)).astype(np.float32)
    var = rng.uniform(0.6, 2.0, (2, 8, 12, 1)).astype(np.float32)
    return costs, gt, var


@pytest.mark.parametrize("variance", ["scalar", "map", "list"])
@pytest.mark.parametrize("sparse", [False, True])
def test_stereo_focal_loss_matches_jax(variance, sparse):
    """Two levels (the second at half resolution where its variance is a
    scalar), the focal weight and the gradients with respect to the costs
    and a variance map."""
    costs, gt, var = focal_inputs(4, half_res=variance != "map")
    kwargs = dict(max_disp=16, start_disp=0, dilation=[1, 1],
                  weights=[1.0, 0.7], focal_coefficient=5.0, sparse=sparse)

    def variances(v, lib):
        return {"scalar": 1.2, "map": lib(v),
                "list": [lib(v), 0.9]}[variance]

    def jloss(cs, v):
        d = jfocal.stereo_focal_loss(list(cs), jnp.asarray(gt),
                                     variance=variances(v, jnp.asarray),
                                     **kwargs)
        return sum(d.values()), d

    (jtotal, jd), jgrads = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(
        [jnp.asarray(c) for c in costs], jnp.asarray(var))
    tcosts = [torch.from_numpy(c).requires_grad_() for c in costs]
    tvar = torch.from_numpy(var).requires_grad_()
    td = stereo_focal_loss(tcosts, torch.from_numpy(gt),
                           variance=variances(tvar, lambda x: x), **kwargs)
    assert sorted(td) == sorted(jd) == ["stereo_focal_loss_lvl0",
                                        "stereo_focal_loss_lvl1"]
    for k in jd:
        # float32 sums over 2 * 16 * 8 * 12 terms in another order
        np.testing.assert_allclose(float(td[k].detach()), float(jd[k]),
                                   rtol=1e-5,
                                   err_msg=k)
    grads = torch.autograd.grad(sum(td.values()), tcosts + [tvar],
                                allow_unused=True)
    for g, w in zip(grads, list(jgrads[0]) + [jgrads[1]]):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, atol=1e-5 * max(np.abs(w).max(),
                                                         1e-3))


@pytest.mark.parametrize("sparse", [False, True])
def test_conf_nll_loss_matches_jax(sparse):
    rng = np.random.RandomState(5)
    conf_costs = [rng.randn(2, h, w, 1).astype(np.float32) * 4
                  for h, w in ((8, 12), (4, 6))]
    # large confidence costs: softplus's linear branch (x > 20)
    conf_costs[0][0, 0, :4, 0] = [25.0, -25.0, 40.0, -40.0]
    gt = rng.uniform(-1, 18, (2, 8, 12, 1)).astype(np.float32)
    kwargs = dict(max_disp=16, start_disp=0, weights=[1.0, 0.7],
                  sparse=sparse)
    want = jdisp_losses.conf_nll_loss([jnp.asarray(c) for c in conf_costs],
                                      jnp.asarray(gt), **kwargs)
    got = conf_nll_loss([torch.from_numpy(c) for c in conf_costs],
                        torch.from_numpy(gt), **kwargs)
    assert sorted(got) == sorted(want) == ["conf_loss_lvl0",
                                           "conf_loss_lvl1"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("kwargs", [
    dict(max_disp=16, radius=2),
    dict(max_disp=12, radius=3, start_disp=-2, dilation=2,
         radius_dilation=2, alpha=1.5),
])
def test_local_soft_argmin_matches_jax(kwargs):
    d = (kwargs["max_disp"] + kwargs.get("dilation", 1) - 1) \
        // kwargs.get("dilation", 1)
    cost = np.random.RandomState(6).randn(2, d, 5, 7).astype(np.float32) * 3
    want = np.asarray(jlocal_soft_argmin(jnp.asarray(cost), **kwargs))
    got = local_soft_argmin(torch.from_numpy(cost), **kwargs).numpy()
    assert got.shape == want.shape == (2, 5, 7, 1)
    # a softmax over 2r+1 samples in another order
    np.testing.assert_allclose(got, want, atol=1e-5)
    pred = DispPredictor(type="LOCAL", **{k: v for k, v in kwargs.items()})
    np.testing.assert_array_equal(pred(torch.from_numpy(cost)).numpy(), got)
    with pytest.raises(ValueError, match="inconsistent"):
        local_soft_argmin(torch.from_numpy(cost[:, 1:]), **kwargs)


@pytest.mark.parametrize("bounds", [dict(), dict(lb=0, ub=12),
                                    dict(lb=10, ub=11)])
def test_sparsification_plot_matches_jax(bounds):
    rng = np.random.RandomState(7)
    est = rng.uniform(0, 16, (1, 20, 30, 1)).astype(np.float32)
    gt = rng.uniform(-2, 16, (1, 20, 30, 1)).astype(np.float32)
    conf = rng.rand(1, 20, 30, 1).astype(np.float32)
    want = jsparsification.sparsification_plot(est, gt, conf, seed=3,
                                               **bounds)
    got = sparsification.sparsification_plot(est, gt, conf, seed=3,
                                             **bounds)
    assert got == want      # the same numpy computation: exact
    assert len(got) == 33


def test_confidence_panels_match_jax():
    conf = np.random.RandomState(8).rand(1, 12, 20, 1).astype(np.float32)
    hist = show_result.conf_to_hist(conf)
    np.testing.assert_array_equal(hist, jshow.conf_to_hist(conf))
    np.testing.assert_array_equal(show_result.hist_to_vis(hist),
                                  jshow.hist_to_vis(hist))
    result = {"disps": [conf * 10], "confs": [conf], "leftDisp": conf * 9,
              "leftImage": np.ones((1, 12, 20, 3), np.float32)}
    got = show_result.ShowResultTool(16)(result)
    want = jshow.ShowResultTool(16)(result)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class FakeWriter:
    """Records a SummaryWriter's calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(tag, value, step, **kwargs):
            self.calls.append((name, tag, np.asarray(value).tolist(), step,
                               kwargs))
        return record


def test_metrics_logger_routes_media_as_jax(tmp_path):
    media = {"image/a": np.full((4, 5), 0.5, np.float32),
             "image/b": np.full((4, 5, 3), 200, np.uint8),
             "image/c": np.full((4, 5, 3), 0.8, np.float32),
             "histogram/h": np.arange(6.0).reshape(2, 3), "x": 1.5}
    loggers = (MetricsLogger(str(tmp_path / "port"), tensorboard=False),
               jlogging.MetricsLogger(str(tmp_path / "jax"),
                                      tensorboard=False))
    for logger in loggers:
        logger.tb = FakeWriter()
        logger.log(3, {"loss": 2.0}, prefix="train/")
        logger.log_media(4, media, value_range={"image/c": "255"})
    assert loggers[0].tb.calls == loggers[1].tb.calls
    assert len(loggers[0].tb.calls) == 6


def test_vis_hook_writes_panels(eval_case, tmp_path):
    """One epoch of the hook on the adaptive model: the disparity, error,
    group and confidence PNGs of each sample, and the same images and
    the confidence histograms in TensorBoard (tensorboardX is here)."""
    from densematchingbenchmark_tpu_torch.data import (
        SyntheticStereoDataset, transforms)
    cases, _ = eval_case
    model, _ = cases["AcfNet/scene_flow_adaptive_f32"]
    data = model.cfg["data"]
    ds = SyntheticStereoDataset(length=3, height=30, width=60, max_disp=12,
                                transform=transforms.make_eval_transform(
                                    (H, W), data["mean"], data["std"]))
    log = MetricsLogger(str(tmp_path))
    assert log.tb is not None
    model.module.train()
    VisHook(ds, str(tmp_path), log, data["mean"], data["std"], max_disp=M,
            max_samples=2)(model.module, 7)
    assert model.module.training                 # its mode is kept
    model.module.eval()
    log.close()
    panels = ["conf_0", "conf_0_hist", "conf_1", "conf_1_hist", "conf_2",
              "conf_2_hist", "disp_0", "disp_0_err", "disp_1", "disp_1_err",
              "disp_2", "disp_2_err", "group"]
    assert sorted(os.listdir(tmp_path / "vis")) == ["sample_000",
                                                    "sample_001"]
    for sample in ("sample_000", "sample_001"):
        files = sorted(os.listdir(tmp_path / "vis" / sample))
        assert files == sorted(f"{p}_7.png" for p in panels)
    from densematchingbenchmark_tpu_torch.data import io
    img = io.load_png(str(tmp_path / "vis" / "sample_000" / "group_7.png"))
    assert img.shape == (2 * H, 2 * W, 3)
    assert len(os.listdir(tmp_path / "tb")) == 1


def test_test_tool_prints_sparsification_rows(eval_case, tmp_path, capsys):
    """tools/test.main on the adaptive config over a KITTI-layout set: the
    metric table, then the est / oracle / random rows of the averaged
    sparsification curves, which equal the curves of JAX's function on
    the port's outputs; with --out-dir the confidence maps and
    histograms."""
    from densematchingbenchmark_tpu_torch.utils.checkpoint import (
        CheckpointManager)
    from test_torch_eval import write_kitti_dataset
    sizes = ((30, 60), (32, 64), (28, 50))
    ann = write_kitti_dataset(str(tmp_path / "kitti"), sizes)
    cases, _ = eval_case
    model, _ = cases["AcfNet/scene_flow_adaptive_f32"]
    work = str(tmp_path / "work")
    CheckpointManager(work).save(1, {"module": model.module.state_dict()})
    name = "AcfNet/kitti_2015_adaptive_f32"
    extra = {"data.test.input_shape": (H, W), "model.eval.batch_size": 2}
    over = [f"{k}={v}" for k, v in overrides(name, **extra).items()]
    out = str(tmp_path / "out")
    results, n = ttest.main(["--config", name, "--work-dir", work,
                             "--data-root", str(tmp_path / "kitti"),
                             "--annfile", ann, "--out-dir", out, "--cpu",
                             "--override", *over])
    assert n == len(sizes)
    text = capsys.readouterr().out
    assert "sparsification (3 samples" in text
    rows = [line.split() for line in text.splitlines()
            if line.strip().split(" ")[0] in ("est", "oracle", "random")]
    assert [r[0] for r in rows] == ["est", "oracle", "random"]
    assert all(len(r) == 12 for r in rows)
    # the same curves from JAX's function on the port's batch-1 outputs
    from densematchingbenchmark_tpu_torch.data import (build_dataset,
                                                       collate, transforms)
    cfg = get_config(name, **overrides(name, **extra))
    cfg["data"].update(data_root=str(tmp_path / "kitti"))
    cfg["data"]["test"]["annfile"] = ann
    ds = build_dataset(cfg["data"], "test", transforms.make_eval_transform(
        (H, W), cfg["data"]["mean"], cfg["data"]["std"]))
    sums = {}
    for i in range(len(ds)):
        b = collate([ds[i]])
        o = model.forward(torch.from_numpy(b["leftImage"]),
                          torch.from_numpy(b["rightImage"]))
        curves = jsparsification.sparsification_plot(
            o["disps"][0].numpy(), b["leftDisp"], o["confs"][0].numpy(),
            lb=0, ub=M, seed=i)
        for k, v in curves.items():
            sums[k] = sums.get(k, 0.0) + v / len(ds)
    for k, v in sums.items():
        # the batch-1 forward in another process of the same weights
        np.testing.assert_allclose(results[f"sparsification/{k}"], v,
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert np.isfinite([float(x) for r in rows for x in r[1:]]).all()
    files = sorted(os.listdir(os.path.join(out, "confidence")))
    assert files == ["000000.png", "000000_hist.png", "000001.png",
                     "000001_hist.png", "000002.png", "000002_hist.png"]


def test_upsample_phase_form_is_the_learned_upsample(monkeypatch):
    """tools/bench_upsample's phase form (a 64-phase 3x3x3 conv at the
    cost's resolution, then a 3-D pixel shuffle) computes AcfNet's learned
    upsample, forward and both gradients (float64: rounding only); the
    tool needs a card."""
    from densematchingbenchmark_tpu_torch.models.aggregators import (
        AcfAggregator)
    from densematchingbenchmark_tpu_torch.tools import bench_upsample
    agg = AcfAggregator(in_planes=4, dtype=torch.float64).double()
    gen = torch.Generator().manual_seed(9)
    cost = torch.randn((2, 3, 5, 7, 1), generator=gen,
                       dtype=torch.float64).requires_grad_()
    weight = agg.ConvTransposeExact_1.weight
    want = agg._up(cost, 1)
    got = bench_upsample.phase_form(cost.movedim(-1, 1), weight)[:, 0]
    assert got.shape == want.shape == (2, 12, 20, 28)
    np.testing.assert_allclose(got.detach().numpy(),
                               want.detach().numpy(), atol=1e-12)
    ct = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    for g, w in zip(torch.autograd.grad(got, (cost, weight), ct),
                    torch.autograd.grad(want, (cost, weight), ct)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_upsample.main([])
