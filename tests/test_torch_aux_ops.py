"""The port's auxiliary functions against the JAX package on the CPU:
the confidence measures (PKR, APKR, NLM, the GT confidence label), CSPN
affinity propagation in 2-D and 3-D, the bilateral filter, the
relative-rank loss, the self-supervised photometric losses (SSIM, the
left-right consistency masks, the inverse-warp loss) and the cost
normalisations. Each takes the same numpy inputs, drawn from a seed, on
both sides; float32 results within 1e-5 (absolute and relative).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.losses import relative_loss as jrelative
from densematchingbenchmark_tpu.losses import self_supervised as jself
from densematchingbenchmark_tpu.models import conf_measure as jconf
from densematchingbenchmark_tpu.models import cost_norm as jcost_norm
from densematchingbenchmark_tpu.ops import propagation as jprop

from densematchingbenchmark_tpu_torch.losses import relative_loss
from densematchingbenchmark_tpu_torch.losses import self_supervised
from densematchingbenchmark_tpu_torch.models import conf_measure, cost_norm
from densematchingbenchmark_tpu_torch.ops import propagation

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)   # float32 functions, other op order


def close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            close(got[k], want[k])
        return
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            close(g, w)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def both(jfn, tfn, *args, **kwargs):
    """The JAX function and the port's on the same numpy ``args``."""
    close(tfn(*map(torch.from_numpy, args), **kwargs),
          jfn(*map(jnp.asarray, args), **kwargs))


def rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("name", ["pkr_confidence", "apkr_confidence",
                                  "nlm_confidence"])
def test_confidence_measures_match_jax(name):
    rng = np.random.RandomState(0)
    cost = rand(rng, 2, 16, 6, 7, scale=3.0)
    # a flat column (no peak) and a single-peak column among random ones
    cost[0, :, 0, 0] = 1.0
    cost[1, :, 2, 3] = np.arange(16.0)
    both(getattr(jconf, name), getattr(conf_measure, name), cost)
    if name != "pkr_confidence":
        kw = ({"kernel_size": 5} if name == "apkr_confidence"
              else {"sigma": 1.5})
        both(getattr(jconf, name), getattr(conf_measure, name), cost, **kw)


@pytest.mark.parametrize("bounds", [{}, {"lb": 0}, {"lb": 0, "ub": 20.0}])
def test_gt_confidence_matches_jax(bounds):
    rng = np.random.RandomState(1)
    gt = (rng.rand(2, 8, 9, 1) * 24).astype(np.float32)
    gt[0, :2] = 0.0                      # invalid GT
    est = gt + rand(rng, 2, 8, 9, 1, scale=1.5)
    both(jconf.generate_gt_confidence, conf_measure.generate_gt_confidence,
         est, gt, theta=1.0, **bounds)


@pytest.mark.parametrize("iterations,kernel_size,dilation",
                         [(1, 3, 1), (3, 3, 2), (2, 5, 1)])
def test_affinity_propagation_matches_jax(iterations, kernel_size, dilation):
    rng = np.random.RandomState(2)
    kw = dict(iterations=iterations, kernel_size=kernel_size,
              dilation=dilation)
    both(jprop.affinity_propagate_2d, propagation.affinity_propagate_2d,
         rand(rng, 2, 7, 9, kernel_size ** 2), rand(rng, 2, 7, 9, 3), **kw)
    both(jprop.affinity_propagate_3d, propagation.affinity_propagate_3d,
         rand(rng, 1, 5, 6, 7, kernel_size ** 3), rand(rng, 1, 5, 6, 7, 2),
         **kw)


def test_affinity_propagation_refuses_a_mismatched_kernel():
    with pytest.raises(ValueError):
        propagation.affinity_propagate_2d(torch.ones(1, 4, 4, 8),
                                          torch.ones(1, 4, 4, 2))


@pytest.mark.parametrize("kernel_size,sigma_space,sigma_color",
                         [(5, 1.5, 10.0), (3, 0.8, 40.0)])
def test_bilateral_filter_matches_jax(kernel_size, sigma_space, sigma_color):
    rng = np.random.RandomState(3)
    disp = (rng.rand(2, 10, 12, 1) * 30).astype(np.float32)
    image = (rng.rand(2, 10, 12, 3) * 255).astype(np.float32)
    both(jprop.bilateral_filter, propagation.bilateral_filter, disp, image,
         kernel_size=kernel_size, sigma_space=sigma_space,
         sigma_color=sigma_color)


@pytest.mark.parametrize("sparse", [False, True])
def test_relative_loss_matches_jax(sparse):
    rng = np.random.RandomState(4)
    gt = (rng.rand(2, 16, 32, 1) * 150).astype(np.float32)
    gt[:, :3] = 0.0                      # invalid GT
    # two levels at full resolution under one label map, then a full and
    # a half resolution level with a label map each; differences past 66
    # (up to 85) take the linear term
    full = [gt + np.clip(rand(rng, 2, 16, 32, 1, scale=40.0), -85, 85)
            for _ in range(2)]
    half = (rng.rand(2, 8, 16, 1) * 80).astype(np.float32)
    labels = [rng.randint(-1, 2, s.shape).astype(np.float32)
              for s in (gt, half)]
    for est, lab, weights in ((full, labels[0], None),
                              ([full[0], half], labels, [1.0, 0.5])):
        args = dict(max_disp=192, weights=weights, sparse=sparse)
        want = jrelative.relative_loss(
            [jnp.asarray(e) for e in est], jnp.asarray(gt),
            [jnp.asarray(x) for x in lab] if isinstance(lab, list)
            else jnp.asarray(lab), **args)
        got = relative_loss.relative_loss(
            [torch.from_numpy(e) for e in est], torch.from_numpy(gt),
            [torch.from_numpy(x) for x in lab] if isinstance(lab, list)
            else torch.from_numpy(lab), **args)
        close(got, want)
        assert all(np.isfinite(float(v)) for v in got.values())


def test_relative_loss_overflows_as_jax():
    """A difference whose sign disagrees with its label by more than
    about 88 overflows exp() in the soft-margin term, which the linear
    branch does not mask: NaN on both sides."""
    gt = np.full((1, 4, 4, 1), 10.0, np.float32)
    est = gt.copy()
    est[0, 0, 0, 0] = 110.0
    label = np.ones_like(gt)
    got = relative_loss.relative_loss([torch.from_numpy(est)],
                                      torch.from_numpy(gt),
                                      torch.from_numpy(label), max_disp=192)
    want = jrelative.relative_loss([jnp.asarray(est)], jnp.asarray(gt),
                                   jnp.asarray(label), max_disp=192)
    assert np.isnan(float(want["relative_loss_lvl0"]))
    assert np.isnan(float(got["relative_loss_lvl0"]))
    label[0, 0, 0, 0] = -1.0           # the sign agrees: finite
    close(relative_loss.relative_loss([torch.from_numpy(est)],
                                      torch.from_numpy(gt),
                                      torch.from_numpy(label), max_disp=192),
          jrelative.relative_loss([jnp.asarray(est)], jnp.asarray(gt),
                                  jnp.asarray(label), max_disp=192))


def test_ssim_matches_jax():
    rng = np.random.RandomState(5)
    x, y = rng.rand(2, 12, 14, 3).astype(np.float32), rng.rand(
        2, 12, 14, 3).astype(np.float32)
    both(jself.ssim, self_supervised.ssim, x, y)
    mask = rng.rand(2, 12, 14, 3) > 0.3
    close(self_supervised.ssim(torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(mask)),
          jself.ssim(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)))


def test_lr_consistency_mask_matches_jax():
    rng = np.random.RandomState(6)
    left = (rng.rand(2, 8, 20, 1) * 6).astype(np.float32)
    right = left + rand(rng, 2, 8, 20, 1, scale=0.8)
    both(jself.lr_consistency_mask, self_supervised.lr_consistency_mask,
         left, right)
    both(jself.lr_consistency_mask, self_supervised.lr_consistency_mask,
         left, right, theta=0.5)


def test_inverse_warp_loss_matches_jax():
    rng = np.random.RandomState(7)
    left = rng.rand(2, 16, 32, 3).astype(np.float32)
    right = np.roll(left, -4, axis=2)
    disps = [(rng.rand(2, 16, 32, 1) * 8).astype(np.float32),
             (rng.rand(2, 8, 16, 1) * 4).astype(np.float32)]
    mask = rng.rand(2, 16, 32, 3) > 0.2
    for kw in ({}, {"weights": [1.0, 0.7], "ssim_weight": 0.3,
                    "rms_weight": 0.7}):
        close(self_supervised.inverse_warp_loss(
            [torch.from_numpy(d) for d in disps], torch.from_numpy(left),
            torch.from_numpy(right), **kw),
            jself.inverse_warp_loss([jnp.asarray(d) for d in disps],
                                    jnp.asarray(left), jnp.asarray(right),
                                    **kw))
    # a mask at the first level's size
    close(self_supervised.inverse_warp_loss(
        torch.from_numpy(disps[0]), torch.from_numpy(left),
        torch.from_numpy(right), mask=torch.from_numpy(mask)),
        jself.inverse_warp_loss(jnp.asarray(disps[0]), jnp.asarray(left),
                                jnp.asarray(right), mask=jnp.asarray(mask)))


@pytest.mark.parametrize("name", ["range_norm", "var_norm", "std_norm",
                                  "sigmoid_norm"])
@pytest.mark.parametrize("axis", [1, -1])
def test_cost_norms_match_jax(name, axis):
    x = rand(np.random.RandomState(8), 2, 12, 5, 6, scale=4.0)
    both(getattr(jcost_norm, name), getattr(cost_norm, name), x, axis=axis)
