"""The port's inventory layers and warp-error refinement against the JAX
package, on the CPU: Hourglass2D, DilatedHourglass3D, DenseAspp (and its
block without the leading BatchNorm), WarpErrorRefinement and
CostVolumeNorm.

Each Flax module is initialised by JAX at a tiny shape; its tree, with
every BatchNorm's scale, bias and statistics and every conv bias drawn at
random (identity BN would hide a fold bug: DilatedHourglass3D's two
stride-1 units fold theirs into K1's epilogue in eval), is carried into
the port's module by ``load_jax_variables``. Both run the same numpy
input, in eval mode and in training mode (batch statistics, the running
statistics updated): outputs within 1e-4 of the largest |output| (float32,
convolutions summed in another order), and the updated statistics within
1e-5. JAX jits each init and apply once (tests/acfnet_parity.jit_call).
"""

import numpy as np
import jax
import pytest
import torch

from densematchingbenchmark_tpu.models import cost_norm as jcost_norm
from densematchingbenchmark_tpu.models import layers_extra as jextra
from densematchingbenchmark_tpu.models.refinement import (
    warp_error as jwarp_error)

from densematchingbenchmark_tpu_torch.models import cost_norm
from densematchingbenchmark_tpu_torch.models import layers_extra
from densematchingbenchmark_tpu_torch.models.refinement.warp_error import (
    WarpErrorRefinement)
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

from acfnet_parity import jit_call

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

MODULE_RTOL = 1e-4   # of the largest |output|: float32 convs, other order
STATS_ATOL = 1e-5    # the updated running statistics


def randomize(tree, rng):
    """Numpy copy of a Flax tree, every BatchNorm's scale in [0.7, 1.1],
    var in [0.9, 1.4], and every bias and mean ~ 0.1 N(0, 1)."""
    def walk(node, parent):
        out = {}
        for k, v in node.items():
            if hasattr(v, "items"):
                out[k] = walk(v, k)
            elif parent.startswith("BatchNorm") and k == "scale":
                out[k] = rng.uniform(0.7, 1.1, v.shape).astype(np.float32)
            elif parent.startswith("BatchNorm") and k == "var":
                out[k] = rng.uniform(0.9, 1.4, v.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.array(v)
        return out
    return walk(tree, "")


def rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def leaves(x):
    return x if isinstance(x, tuple) else (x,)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def run_both(jmodule, tmodule, args, seed=0):
    """Both modules from JAX's randomized init on numpy ``args``, in eval
    and training mode: asserts the outputs and the updated statistics."""
    rng = np.random.RandomState(seed)
    variables = randomize(jax.tree.map(np.asarray, jit_call(
        lambda *a: jmodule.init(jax.random.PRNGKey(seed), *a), *args)), rng)
    load_jax_variables(tmodule, variables)
    targs = [torch.from_numpy(a) for a in args]
    for train in (False, True):
        if train:
            want, upd = jit_call(lambda v, *a: jmodule.apply(
                v, *a, train=True, mutable=["batch_stats"]), variables,
                *args)
        else:
            want = jit_call(lambda v, *a: jmodule.apply(v, *a, train=False),
                            variables, *args)
        tmodule.train(train)
        with torch.no_grad():
            got = tmodule(*targs)
        for g, w in zip(leaves(got), leaves(want)):
            w = np.asarray(w, np.float32)
            g = g.float().numpy()
            assert g.shape == w.shape
            err = np.abs(g - w).max()
            assert err <= MODULE_RTOL * max(np.abs(w).max(), 1.0), err
        if train:
            got_stats = flat(flax_variables(tmodule)["batch_stats"])
            for k, w in flat(upd.get("batch_stats", {})).items():
                np.testing.assert_allclose(got_stats[k], w, rtol=0,
                                           atol=STATS_ATOL, err_msg=str(k))
    return variables


def test_dilated_hourglass3d_matches_jax():
    rng = np.random.RandomState(1)
    x = rand(rng, 2, 8, 8, 8, 4)
    post = rand(rng, 2, 4, 4, 4, 8)
    module = layers_extra.DilatedHourglass3D(4)
    kernels.reset_launch_counts()
    # without and with the skips of a previous hourglass
    run_both(jextra.DilatedHourglass3D(4), module, (x,))
    run_both(jextra.DilatedHourglass3D(4), module, (x, post, post), seed=2)
    # the two stride-1 units are the trunk's fusable units; on the CPU
    # their wrappers run the plain versions and count no launch
    assert [n for n, m in module.named_modules()
            if getattr(m, "fusable", False)] == ["ConvUnit_1", "ConvUnit_3"]
    assert sum(kernels.launch_counts().values()) == 0


def test_hourglass2d_matches_jax():
    rng = np.random.RandomState(3)
    x = rand(rng, 2, 16, 16, 8)
    out = run_both(jextra.Hourglass2D(8), layers_extra.Hourglass2D(8), (x,))
    assert sorted(out["params"]) == [f"ConvUnit_{i}" for i in range(6)]


@pytest.mark.parametrize("batch_norm", [True, False])
def test_dense_aspp_matches_jax(batch_norm):
    rng = np.random.RandomState(4)
    x = rand(rng, 2, 16, 16, 16)
    variables = run_both(
        jextra.DenseAspp(16, 8, batch_norm=batch_norm),
        layers_extra.DenseAspp(16, 8, batch_norm=batch_norm), (x,))
    # the first block has no leading BN: its only BN is BatchNorm_0
    block = variables["params"]["DenseAsppBlock_0"]
    assert sorted(block) == (["BatchNorm_0", "Conv_0", "Conv_1"]
                             if batch_norm else ["Conv_0", "Conv_1"])


def test_warp_error_refinement_matches_jax():
    rng = np.random.RandomState(5)
    left, right = rand(rng, 2, 16, 16, 8), rand(rng, 2, 16, 16, 8)
    disp = (rng.rand(2, 8, 8, 1) * 4).astype(np.float32)
    run_both(jwarp_error.WarpErrorRefinement(C=4),
             WarpErrorRefinement(8, C=4), (disp, left, right))


@pytest.mark.parametrize("kind", ["range", "var", "std", "sigmoid"])
def test_cost_volume_norm_matches_jax(kind):
    x = rand(np.random.RandomState(6), 2, 16, 4, 4, scale=5.0)
    jmodule = jcost_norm.CostVolumeNorm(kind=kind, init_weight=1.5,
                                        init_bias=0.25)
    variables = jax.tree.map(np.asarray,
                             jmodule.init(jax.random.PRNGKey(0), x))
    variables["params"]["weight"] = np.array([0.8], np.float32)
    module = load_jax_variables(cost_norm.CostVolumeNorm(kind=kind),
                                variables)
    np.testing.assert_allclose(
        module(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jmodule.apply(variables, x)), rtol=1e-5, atol=1e-5)
    # frozen scalars: no parameters on either side
    fixed = cost_norm.CostVolumeNorm(kind=kind, affine=False,
                                     init_weight=1.5, init_bias=0.25)
    jfixed = jcost_norm.CostVolumeNorm(kind=kind, affine=False,
                                       init_weight=1.5, init_bias=0.25)
    assert not list(fixed.parameters())
    assert not jfixed.init(jax.random.PRNGKey(0), x)
    np.testing.assert_allclose(fixed(torch.from_numpy(x)).numpy(),
                               np.asarray(jfixed.apply({}, x)), rtol=1e-5,
                               atol=1e-5)
