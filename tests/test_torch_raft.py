"""The port's RAFT against the JAX package's, on the CPU: the all-pairs
correlation pyramid (with its floor-pool crop of odd target sizes and its
early stop), the lookup against both of JAX's forms (the tent contraction
of ``corr_lookup`` and the chained gathers of ``corr_lookup_gather``)
with coordinates outside every level, the convex upsampler's layout, the
Flax tree (``fnet``, ``cnet``, ``update`` with no iteration axis,
``ConvexUpsampler_0``), every flow of the list in float32 (within 1e-3
px) and in bfloat16, and the port's refusal of frames too small for the
levels it is built for.

At the tiny size of tests/flow_parity.py (2 iterations, hidden 32,
context 16, 64x64 frames: four correlation levels), on shared randomized
weights; each JAX model function is traced and compiled once
(tests/acfnet_parity.jit_call).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.configs import get_config as jget_config
from densematchingbenchmark_tpu.flow import raft as jraft
from densematchingbenchmark_tpu.flow.models import (
    build_flow_model as jbuild_flow)

from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.flow import RAFTFlow
from densematchingbenchmark_tpu_torch.flow import raft as traft
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

from acfnet_parity import flat, jit_call
from flow_parity import RAFT, configs, frames, shared_weights

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def fmaps(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("shape,levels", [((2, 7, 5, 6), 4),
                                          ((1, 6, 9, 4), 3),
                                          ((1, 3, 2, 4), 4)])
def test_corr_pyramid_matches_jax(shape, levels):
    """The float32 all-pairs product over sqrt(C) and each level's 2x2
    average pool, an odd trailing target row or column cropped first
    (7x5 -> 3x2 -> 1x1), within 1e-6 of JAX's; the pyramid stops where a
    target dim would reach 0, as JAX's (3x2 gives two levels of four)."""
    a, b = fmaps(shape, sum(shape))
    got = traft.all_pairs_corr_pyramid(torch.from_numpy(a),
                                       torch.from_numpy(b), levels)
    want = jraft.all_pairs_corr_pyramid(jnp.asarray(a), jnp.asarray(b),
                                        levels)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    if shape[1:3] == (7, 5):
        assert [g.shape[3:] for g in got] == [(7, 5), (3, 2), (1, 1)]
    if shape[1:3] == (3, 2):
        assert len(got) == 2


def test_corr_lookup_matches_both_jax_forms():
    """The (2r + 1)^2 bilinear window of every level (r = 3, four levels
    of an 8x12 map) at coordinates inside, fractional, on integer cells
    and outside every level (down to -12 and up to 3x the width), within
    1e-5 of JAX's ``corr_lookup`` (tent contraction) and of
    ``corr_lookup_gather`` (chained 1-D gathers); a window wholly outside
    the map is zero."""
    a, b = fmaps((2, 8, 12, 16), 5)
    pyr_t = traft.all_pairs_corr_pyramid(torch.from_numpy(a),
                                         torch.from_numpy(b), 4)
    pyr_j = jraft.all_pairs_corr_pyramid(jnp.asarray(a), jnp.asarray(b), 4)
    rng = np.random.RandomState(6)
    coords = rng.uniform(-12, 36, (2, 8, 12, 2)).astype(np.float32)
    coords[0, :2] = np.round(coords[0, :2])          # integer cells
    coords[1, 0, 0] = (-40.0, -40.0)                 # outside every level
    got = traft.corr_lookup(pyr_t, torch.from_numpy(coords), 3)
    assert got.shape == (2, 8, 12, 4 * 49)
    wants = jit_call(lambda p, c: [fn(p, c, 3) for fn in (
        jraft.corr_lookup, jraft.corr_lookup_gather)], pyr_j,
        jnp.asarray(coords))
    for want in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert not got[1, 0, 0].any()
    assert np.abs(got.numpy()).max() > 1.0


def test_convex_upsampler_layout_matches_jax():
    """The learned 8x upsampler alone: mask channel p * 9 + k (phase p =
    py * 8 + px), the 9 taps from a zero pad (no wrap from the opposite
    edge), the phase shuffle (0, 1, 3, 2, 4, 5): within 1e-5 of JAX's on
    random weights, and a mask peaked on the centre tap gives 8x the
    coarse flow in each 8x8 block."""
    rng = np.random.RandomState(7)
    up = traft.ConvexUpsampler(8)
    hidden = rng.randn(2, 3, 4, 8).astype(np.float32)
    flow = rng.randn(2, 3, 4, 2).astype(np.float32)
    variables = flax_variables(up)
    got = up(torch.from_numpy(hidden), torch.from_numpy(flow)).detach()
    want = jraft.ConvexUpsampler().apply(jax.tree.map(jnp.asarray,
                                                      variables),
                                         hidden, flow)
    assert got.shape == (2, 24, 32, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with torch.no_grad():
        up.ConvUnit_1.Conv_0.weight.zero_()
        bias = torch.full((64, 9), -1e4)
        bias[:, 4] = 0.0
        up.ConvUnit_1.Conv_0.bias.copy_(bias.reshape(-1))
        got = up(torch.from_numpy(hidden), torch.from_numpy(flow))
    np.testing.assert_allclose(
        got.numpy(), 8.0 * np.repeat(np.repeat(flow, 8, 1), 8, 2), atol=1e-5)


@pytest.fixture(scope="module")
def weights():
    return shared_weights(RAFT)[1]


@pytest.fixture(scope="module")
def eval_case(weights):
    """The port's and JAX's eval-mode flows in float32 and bfloat16."""
    ref, tgt = frames(RAFT)
    cases = {}
    for suffix in ("_f32", "_bf16"):
        jcfg, cfg = configs(RAFT, suffix)
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


def test_raft_flax_tree_matches_jax(weights):
    """The port's module has exactly the leaves and shapes of JAX's Flax
    tree (jax.eval_shape of its init) at the shipped config's width
    (2,064,866 parameters; at the tiny size JAX's apply takes the port's
    tree in the eval tests): ``update`` has the UpdateBlock's leaves with
    no iteration axis (nn.scan broadcasts them), the GRU's gates ``z`` /
    ``r`` / ``q`` and the heads ``flow_head1`` / ``flow_head2`` by name,
    the motion encoder's input 196 = 4 levels x 49."""
    dummy = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(jbuild_flow(jget_config(RAFT + "_f32")).init,
                            jax.random.PRNGKey(0), dummy, dummy)
    want = {k: tuple(v.shape) for k, v in flat(jax.tree.map(
        lambda s: np.empty(s.shape, np.float32), shapes)).items()}
    module = build_model(get_config(RAFT + "_f32"))
    assert isinstance(module, RAFTFlow)
    got = {k: v.shape for k, v in flat(flax_variables(module)).items()}
    assert got == want
    assert sum(int(np.prod(s)) for k, s in got.items()
               if k[0] == "params") == 2064866
    assert {k[1] for k in got} == {"fnet", "cnet", "update",
                                   "ConvexUpsampler_0"}
    upd = {k[2:] for k in got if k[1] == "update"}
    assert {k[0] for k in upd} == {"MotionEncoder_0", "ConvGRU_0",
                                   "flow_head1", "flow_head2"}
    assert {k[1] for k in upd if k[0] == "ConvGRU_0"} == {"z", "r", "q"}
    assert got[("params", "update", "MotionEncoder_0", "ConvUnit_0",
                "Conv_0", "kernel")] == (1, 1, 196, 96)


def test_raft_eval_matches_jax(eval_case):
    """The three flows (the convex-upsampled final flow, then the two
    iterations' bilinear 8x flows, latest first), each [2, 64, 64, 2]
    float32, within 1e-3 px of JAX's."""
    got, want = eval_case["_f32"]
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (2, 64, 64, 2)] * 3
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-3)
    assert np.abs(want[0]).max() > 1.0


def test_raft_bf16_eval_matches_jax(eval_case):
    """bfloat16 convolutions, float32 correlation, lookup, hidden state
    between iterations and flows, as JAX's: every flow within 0.05 px
    mean of JAX's (0.007-0.013 px here, of flows of 3-5 px mean), each
    apart from the float32 flows, and the port's own
    bfloat16-vs-float32 gap within 0.8-1.25x JAX's (the recurrence
    carries each side's rounding)."""
    got, want = eval_case["_bf16"]
    g32, w32 = eval_case["_f32"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float32
        gap = np.abs(g - w).mean()
        assert gap < 0.05, (i, gap)
        own, jax_own = (np.abs(g - g32[i]).mean(),
                        np.abs(w - w32[i]).mean())
        assert 0.8 * jax_own <= own <= 1.25 * jax_own, (i, own, jax_own)


def test_raft_refuses_frames_too_small_for_its_levels(weights):
    """At 32x48 the 4x6 map at 1/8 gives JAX's pyramid three levels (its
    motion encoder then built for 3 x 49 inputs); the port, built for
    four, raises a clear ValueError instead."""
    module = build_model(configs(RAFT)[1]).eval()
    x = torch.zeros(1, 32, 48, 3)
    with pytest.raises(ValueError, match="3 correlation levels of the 4"):
        with torch.no_grad():
            module(x, x)
