"""The port's GCNet against the JAX package, on the CPU: the Flax tree,
eval under JAX's shipped config (``pack`` 2, ``phase_argmin``,
``split_concat``: the TPU schedules, which the port drops) and with those
off, the full-resolution cost, the bfloat16 eval, the units that run on
the trunk kernels (one train step: tests/test_torch_gcnet_train.py).

Both sides build GCNet at max_disp 64 on 32x64 frames: the raw volume
is [1, 32, 16, 32, 64], a size at which JAX's ``pack`` 2 holds
((max_disp / 2) % 32 == 0 and H / 2, W / 2 multiples of 16; below it
JAX falls back to pack 1). The weights are the port's seeded tree
with every BatchNorm's parameters and statistics and every conv bias
drawn at random (tests/acfnet_parity.randomize), carried to JAX through
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
from densematchingbenchmark_tpu.models import build_model as jbuild_model

from densematchingbenchmark_tpu_torch import apis as tapis
from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.models.layers import ConvUnit
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

from acfnet_parity import flat, jit_call, randomize

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

M = 64
B, H, W = 1, 32, 64
NAME = "GCNet/scene_flow"
# JAX's schedules off: the plain unpacked trunk, the full-resolution head
OFF = {"model.cost_processor.cost_aggregator.pack": 0,
       "model.cost_processor.cost_aggregator.phase_argmin": False,
       "model.cost_processor.cost_aggregator.split_concat": False}


def overrides(**extra):
    over = {"model.max_disp": M,
            "model.cost_processor.cost_computation.max_disp": M // 2,
            "model.cost_processor.cost_aggregator.max_disp": M,
            "model.disp_predictor.max_disp": M,
            "model.losses.l1_loss.max_disp": M,
            "model.eval.upper_bound": M}
    over.update(extra)
    return over


def configs(name, **extra):
    """(JAX config, port config) of ``name`` at the tiny size."""
    return (jget_config(name, **overrides(**extra)),
            get_config(name, **overrides(**extra)))


def shared_weights(cfg, seed=0):
    module = build_model(cfg, torch.Generator().manual_seed(seed))
    variables = randomize(flax_variables(module), np.random.RandomState(seed))
    load_jax_variables(module, variables)
    return module, variables


def batch(seed=1):
    rng = np.random.RandomState(seed)
    return {"leftImage": rng.randn(B, H, W, 3).astype(np.float32),
            "rightImage": rng.randn(B, H, W, 3).astype(np.float32),
            "leftDisp": rng.uniform(-2, M + 4, (B, H, W, 1)).astype(
                np.float32)}


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


# the eval cases: (config name, overrides)
CASES = {"shipped": (NAME + "_f32", {}), "off": (NAME + "_f32", OFF),
         "bf16": (NAME + "_bf16", OFF)}


@pytest.fixture(scope="module")
def eval_case():
    """Per case: the port's eval outputs and JAX's, on one batch and one
    tree of weights; JAX's three models in one jitted call."""
    _, cfg = configs(NAME + "_f32")
    _, variables = shared_weights(cfg)
    images = batch(1)
    jmodels = {k: jbuild_model(configs(n, **o)[0])
               for k, (n, o) in CASES.items()}
    assert jmodels["shipped"].phase_argmin
    assert jmodels["shipped"].cost_processor.aggregator.pack == 2
    assert not jmodels["off"].phase_argmin

    def run(v, left, right):
        return {k: m.apply(v, left, right, train=False)
                for k, m in jmodels.items()}
    want = to_numpy(jit_call(run, jax.tree.map(jnp.asarray, variables),
                             images["leftImage"], images["rightImage"]))
    got = {}
    for k, (name, over) in CASES.items():
        model = tapis.init_model(configs(name, **over)[1], device="cpu")
        load_jax_variables(model.module, variables)
        kernels.reset_launch_counts()
        got[k] = model.forward(torch.from_numpy(images["leftImage"]),
                               torch.from_numpy(images["rightImage"]))
        # on the CPU every wrapper ran its plain version, counting nothing
        assert set(kernels.launch_counts().values()) == {0}
        got[k]["model"] = model
    return got, want


def test_gcnet_flax_tree_matches_jax():
    """The port's module has exactly the leaves and shapes of JAX's Flax
    tree (jax.eval_shape of its init): the backbone's stem, blocks_0..7
    and final; the aggregator's ConvUnit_0..17 and ConvTransposeExact_0.
    The shipped schedules keep that tree: ``eval_case`` applies JAX's
    models with and without them to one tree (a missing leaf raises)."""
    jcfg, cfg = configs(NAME + "_f32")
    dummy = jnp.zeros((1, H, W, 3))
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0),
                            dummy, dummy)
    want = {k: tuple(v.shape) for k, v in flat(jax.tree.map(
        lambda s: np.empty(s.shape, np.float32), shapes)).items()}
    _, variables = shared_weights(cfg)
    assert {k: v.shape for k, v in flat(variables).items()} == want
    agg = {k[3] for k in want if k[:3] == ("params", "cost_processor",
                                           "aggregator")}
    assert agg == {f"ConvUnit_{i}" for i in range(18)} | {
        "ConvTransposeExact_0"}


@pytest.mark.parametrize("case", ["shipped", "off"])
def test_gcnet_eval_matches_jax(eval_case, case):
    """The disparity within 1e-3 px of JAX's, under JAX's shipped
    schedules (the same function) and with them off; the full-resolution
    cost [B, M, H, W] within 1e-5 of its largest magnitude (float32 convs
    summing in another order; JAX's phase-form 'costs' are that volume
    laid out again)."""
    got, want = eval_case
    out, ref = got[case], want[case]
    assert len(out["disps"]) == len(ref["disps"]) == 1
    g, w = out["disps"][0], ref["disps"][0]
    assert g.shape == w.shape == (B, H, W, 1) and g.dtype == torch.float32
    np.testing.assert_allclose(g.numpy(), w, atol=1e-3)
    cost, wcost = out["costs"][0], np.asarray(ref["costs"][0])
    if wcost.ndim == 5:            # the phase layout's [B, D, H, W, 1]
        wcost = wcost[..., 0]
    assert cost.shape == wcost.shape == (B, M, H, W)
    assert cost.dtype == torch.float32
    np.testing.assert_allclose(cost.numpy(), wcost,
                               atol=1e-5 * np.abs(wcost).max())


def test_gcnet_bf16_eval_matches_jax(eval_case):
    """The bfloat16 model against JAX's (both with the schedules off: the
    same function, and a JAX compile half as long), by StereoNet's rule (tests/test_torch_stereonet.py): the
    disparity within 0.05 px mean of JAX's (the bound
    tests/test_torch_bf16_slice.py holds PSMNet to), and the port's own
    bfloat16-vs-float32 mean gap between 0.8x and 1.25x JAX's, the lower
    side failing a model that ignores bfloat16. The head's cost comes
    back in bfloat16, as JAX's."""
    got, want = eval_case
    out = got["bf16"]
    assert out["costs"][0].dtype == torch.bfloat16
    g, g32 = out["disps"][0].numpy(), got["off"]["disps"][0].numpy()
    w, w32 = want["bf16"]["disps"][0], want["off"]["disps"][0]
    gap = np.abs(g - w).mean()
    own, jax_own = np.abs(g - g32).mean(), np.abs(w - w32).mean()
    assert gap < 0.05, (gap, own, jax_own)
    assert 0.8 * jax_own <= own <= 1.25 * jax_own + 1e-3, (gap, own,
                                                           jax_own)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gcnet_units_on_the_kernels(eval_case, dtype):
    """The aggregator's ten stride-1 units (c19, c20, c22, c23, c25, c26,
    c28, c29, c31, c32: ConvUnit_0, 1, 3, 4, 6, 7, 9, 10, 12, 13) are
    fusable: K1 in float32 eval, K4 (its bfloat16 route) in bfloat16 and
    in training; in bfloat16 the 128 -> 128 units c31 and c32 run in two
    slices of Ci, so a bfloat16 forward launches K4 12 times. The strided
    and transposed units are library convs."""
    model = eval_case[0]["off" if dtype == torch.float32
                         else "bf16"]["model"]
    agg = model.module.cost_processor.aggregator
    units = [getattr(agg, f"ConvUnit_{i}") for i in range(18)]
    fusable = [i for i, u in enumerate(units) if u.fusable]
    assert fusable == [0, 1, 3, 4, 6, 7, 9, 10, 12, 13]
    assert all(u.dtype == dtype for u in units)
    launches = sum(len(units[i].widths.slices) for i in fusable)
    assert launches == (10 if dtype == torch.float32 else 12)
    assert sum(isinstance(m, ConvUnit) and m.fusable
               for m in model.module.modules()) == 10


@pytest.mark.parametrize("schedule", ["split_concat", "w_pad"])
def test_gcnet_builder_drops_the_tpu_schedules(schedule):
    """JAX's aggregator schedules keep the parameters and the function:
    the port's builder drops them, and the built module is the plain
    one."""
    value = {"split_concat": True, "w_pad": 64}[schedule]
    _, plain = configs(NAME + "_f32", **OFF)
    _, cfg = configs(NAME + "_f32", **{
        f"model.cost_processor.cost_aggregator.{schedule}": value})
    a, b = build_model(plain), build_model(cfg)
    assert [(n, p.shape) for n, p in a.named_parameters()] == \
        [(n, p.shape) for n, p in b.named_parameters()]
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                  b.parameters()))
