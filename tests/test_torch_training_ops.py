"""The port's training-path pieces against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both sides: the packed conv (K4's
plain version, which the wrapper runs on the CPU) against the Pallas kernel
in interpret mode, forward and gradients (the Pallas kernel's custom VJP is
the XLA reference's VJP); the soft-argmin gradient; the losses; the
schedule, clip and RMSprop step against optax; the port's BatchNorm
statistics against Flax; the sampler, the synthetic dataset and the loader
against the JAX data pipeline. Every JAX result is computed once, in one
module-scoped fixture. Tolerances are stated per test.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import linen as fnn

from densematchingbenchmark_tpu.data import (DataLoader as JDataLoader,
                                             EpochSampler as JEpochSampler,
                                             SyntheticStereoDataset as JSynth)
from densematchingbenchmark_tpu.data import transforms as jtransforms
from densematchingbenchmark_tpu.losses import builder as jloss_builder
from densematchingbenchmark_tpu.losses import disp_losses as jdisp_losses
from densematchingbenchmark_tpu.ops import conv3d as jconv3d
from densematchingbenchmark_tpu.ops.pallas.packed_conv3d_kernel import (
    conv3d_packed_s1_pallas)
from densematchingbenchmark_tpu.ops.soft_argmin import (
    soft_argmin as jsoft_argmin)
from densematchingbenchmark_tpu.trainer import optim as joptim

from densematchingbenchmark_tpu_torch.data import (DataLoader, EpochSampler,
                                                   SyntheticStereoDataset,
                                                   build_dataset, transforms)
from densematchingbenchmark_tpu_torch.data import io as tio
from densematchingbenchmark_tpu_torch.losses import builder as tloss_builder
from densematchingbenchmark_tpu_torch.losses import disp_losses
from densematchingbenchmark_tpu_torch.models.layers import BatchNorm
from densematchingbenchmark_tpu_torch.ops import conv3d as tconv3d
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.ops.pooling import (
    adaptive_avg_pool2d, adaptive_max_pool2d)
from densematchingbenchmark_tpu_torch.ops.soft_argmin import soft_argmin
from densematchingbenchmark_tpu_torch.trainer import optim as toptim

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

# (pack, epilogue form, relu): every epilogue form at both packs
PACKED = [(2, "scalar", True), (2, "co", False), (2, "pco", True),
          (4, "scalar", False), (4, "co", True), (4, "pco", False)]
CI, CO = 4, 8
ARGMIN = dict(max_disp=12, start_disp=-2, dilation=2, alpha=1.5)
LOSS_CFG = {"l1_loss": dict(max_disp=16, weights=(1.0, 0.7, 0.5),
                            weight=1.0)}
SCHEDULE = dict(policy="step", warmup="linear", warmup_iters=5,
                warmup_ratio=1.0 / 3, step=(2,), gamma=0.1)
OPT_CFG = {"optimizer": dict(type="rmsprop", lr=0.01,
                             paramwise_options=dict(bias_lr_mult=2.0,
                                                    norm_lr_mult=0.5)),
           "grad_clip": dict(max_norm=35.0), "lr_schedule": SCHEDULE}
STEPS_PER_EPOCH = 3
MEAN, STD = (128.0,) * 3, (64.0,) * 3


def packed_inputs(pack, form, seed):
    rng = np.random.RandomState(seed)
    xp = rng.randn(1, 2, 8, 8, pack * CI).astype(np.float32)
    k = (rng.randn(3, 3, 3, CI, CO) * 0.1).astype(np.float32)
    n = {"scalar": (), "co": (CO,), "pco": (pack * CO,)}[form]
    scale = np.asarray(rng.rand(*n) + 0.5, np.float32)
    bias = np.asarray(rng.randn(*n), np.float32)
    ct = rng.randn(1, 2, 8, 8, pack * CO).astype(np.float32)
    return xp, k, scale, bias, ct


def loss_inputs(seed):
    rng = np.random.RandomState(seed)
    est = [rng.uniform(0, 18, (2, h, w, 1)).astype(np.float32)
           for h, w in ((8, 12), (4, 6), (2, 3))]
    gt = rng.uniform(-1, 20, (2, 8, 12, 1)).astype(np.float32)
    return est, gt


def fake_params(seed, scales=(20.0, 1e-3, 0.3)):
    """A flat parameter list with BN, bias and plain leaves, and one step
    of gradients per scale."""
    rng = np.random.RandomState(seed)
    names = ["Conv_0.weight", "Conv_0.bias", "BatchNorm_0.weight",
             "BatchNorm_0.bias", "Conv_1.weight"]
    shapes = [(4, 3), (4,), (4,), (4,), (2, 2, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    # the first step large enough to be clipped
    grads = [[rng.randn(*s).astype(np.float32) * scale for s in shapes]
             for scale in scales]
    grads[1][3][:] = 0.0         # a zero gradient: eps inside the root
    return names, params, grads


# optimizer settings held against optax over five steps: RMSprop's three
# options one at a time, Adam and SGD (their defaults and a variant)
OPT_VARIANTS = {
    "momentum-0.9": dict(type="rmsprop", momentum=0.9),
    "alpha-0.9": dict(type="rmsprop", alpha=0.9),
    "eps-1e-06": dict(type="rmsprop", eps=1e-6),
    "adam": dict(type="adam"),
    "adam-betas": dict(type="adam", beta1=0.8, beta2=0.99),
    "sgd": dict(type="sgd"),
    "sgd-0.5": dict(type="sgd", momentum=0.5),
}
OPT_SCALES = (20.0, 1e-3, 0.3, 1.0, 0.05)


def optimizer_cfg(variant):
    return dict(OPT_CFG, optimizer=dict(OPT_CFG["optimizer"],
                                        **OPT_VARIANTS[variant]))


def jax_tree(names, leaves):
    tree = {}
    for name, leaf in zip(names, leaves):
        mod, attr = name.split(".")
        attr = {"weight": "kernel" if mod.startswith("Conv") else "scale"
                }.get(attr, attr)
        tree.setdefault(mod, {})[attr] = jnp.asarray(leaf)
    return tree


def jax_leaves(names, tree):
    out = []
    for name in names:
        mod, attr = name.split(".")
        attr = {"weight": "kernel" if mod.startswith("Conv") else "scale"
                }.get(attr, attr)
        out.append(np.asarray(tree[mod][attr]))
    return out


def synth_pair(seed, length=5):
    j = JSynth(length=length, height=20, width=36, max_disp=6, seed=seed,
               with_right_disp=True)
    t = SyntheticStereoDataset(length=length, height=20, width=36,
                               max_disp=6, seed=seed, with_right_disp=True)
    j.transform = jtransforms.make_train_transform((16, 24), MEAN, STD)
    t.transform = transforms.make_train_transform((16, 24), MEAN, STD)
    return j, t


@pytest.fixture(scope="module")
def jax_results():
    """Every JAX reference of this file, computed once."""
    out = {}
    for pack, form, relu in PACKED:
        xp, k, s, b, ct = packed_inputs(pack, form, seed=pack)

        def f(xp, k, s, b, pack=pack, relu=relu, ct=ct):
            y = conv3d_packed_s1_pallas(xp, k, s, b, pack=pack, relu=relu,
                                        interpret=True)
            return jnp.sum(y * ct), y

        (_, y), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
            *map(jnp.asarray, (xp, k, s, b)))
        out["packed", pack, form] = (np.asarray(y),
                                     [np.asarray(g) for g in grads])

    cost = np.random.RandomState(3).randn(2, 6, 5, 7).astype(np.float32) * 3
    g = np.random.RandomState(4).randn(2, 5, 7, 1).astype(np.float32)
    out["argmin_grad"] = np.asarray(jax.grad(lambda c: jnp.sum(
        jsoft_argmin(c, **ARGMIN) * g))(jnp.asarray(cost)))

    est, gt = loss_inputs(5)
    jest = [jnp.asarray(e) for e in est]
    for sparse in (False, True):
        ev = jloss_builder.make_loss_evaluator(LOSS_CFG, sparse=sparse)
        d = ev(jest, None, jnp.asarray(gt))
        out["loss", sparse] = ({k: float(v) for k, v in d.items()},
                               float(jloss_builder.total_loss(d)))
    out["l1_single"] = {k: float(v) for k, v in jdisp_losses.smooth_l1_loss(
        jest[0], jnp.asarray(gt), max_disp=16, start_disp=1).items()}

    names, params, grads = fake_params(6)
    cfg = dict(OPT_CFG)
    tx, schedule = joptim.build_optimizer(cfg, STEPS_PER_EPOCH)
    p = jax_tree(names, params)
    opt_state = tx.init(p)
    traj = []
    for g in grads:
        updates, opt_state = tx.update(jax_tree(names, g), opt_state, p)
        p = optax.apply_updates(p, updates)
        traj.append(jax_leaves(names, p))
    out["optim"] = traj
    out["schedule"] = [float(schedule(i)) for i in range(10)]
    names, params, grads = fake_params(6, OPT_SCALES)
    for variant in OPT_VARIANTS:
        tx, _ = joptim.build_optimizer(optimizer_cfg(variant),
                                       STEPS_PER_EPOCH)
        p = jax_tree(names, params)
        opt_state = tx.init(p)
        traj = []
        for g in grads:
            updates, opt_state = tx.update(jax_tree(names, g), opt_state, p)
            p = optax.apply_updates(p, updates)
            traj.append(jax_leaves(names, p))
        out["optim", variant] = traj

    x = np.random.RandomState(7).randn(3, 4, 5, 6, 8).astype(np.float32) * 2
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))
    stats = variables["batch_stats"]
    ys = []
    for i in range(2):
        y, upd = bn.apply({"params": variables["params"],
                           "batch_stats": stats}, jnp.asarray(x * (i + 1)),
                          mutable=["batch_stats"])
        stats = upd["batch_stats"]
        ys.append(np.asarray(y))
    out["bn"] = (ys, np.asarray(stats["mean"]), np.asarray(stats["var"]))
    return out


@pytest.mark.parametrize("pack,form,relu", PACKED)
def test_packed_conv_matches_pallas(jax_results, pack, form, relu):
    xp, k, s, b, ct = packed_inputs(pack, form, seed=pack)
    want_y, want_grads = jax_results["packed", pack, form]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xp, k, s, b)]
    before = kernels.conv3d_packed_s1.launches
    y = kernels.conv3d_packed_s1(*leaves, pack=pack, relu=relu)
    assert kernels.conv3d_packed_s1.launches == before   # CPU: plain
    assert y.shape == want_y.shape == (1, 2, 8, 8, pack * CO)
    # 27 * 4 products summed in another order
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-5,
                               atol=1e-5)
    grads = torch.autograd.grad((y * torch.from_numpy(ct)).sum(), leaves)
    for got, want in zip(grads, want_grads):
        assert got.shape == want.shape
        # sums over up to 2*8*8*8 cotangent products: 1e-4 of the largest
        tol = 1e-4 * max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got.numpy(), want, atol=tol)


@pytest.mark.parametrize("pack", [1, 2, 4])
def test_pack_volume_matches_jax(pack):
    x = np.random.RandomState(pack).randn(2, 8, 3, 4, 5).astype(np.float32)
    xp = tconv3d.pack_volume(torch.from_numpy(x), pack)
    np.testing.assert_array_equal(
        xp.numpy(), np.asarray(jconv3d.pack_volume(jnp.asarray(x), pack)))
    np.testing.assert_array_equal(tconv3d.unpack_volume(xp, pack).numpy(),
                                  x)


def test_packed_conv_plain_is_the_unpacked_conv():
    # pack 1 with a [Co] epilogue is K1's function
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(1, 3, 5, 6, 4).astype(np.float32))
    k = torch.from_numpy(rng.randn(3, 3, 3, 4, 8).astype(np.float32))
    s = torch.from_numpy(rng.rand(8).astype(np.float32))
    b = torch.from_numpy(rng.randn(8).astype(np.float32))
    got = kernels.conv3d_packed_s1(x, k, s, b, pack=1, relu=True)
    want = kernels.conv3d_plain(x, k, s, b, True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_packed_conv_rejects_bad_epilogue_and_device():
    x = torch.zeros(1, 1, 2, 2, 8)
    k = torch.zeros(3, 3, 3, 4, 4)
    with pytest.raises(ValueError, match="epilogue"):
        kernels.conv3d_packed_s1(x, k, scale=torch.ones(3), pack=2)
    with pytest.raises(ValueError):
        kernels.conv3d_packed_s1(x.to("meta"), k.to("meta"), pack=2)


def test_soft_argmin_grad_matches_jax(jax_results):
    cost = np.random.RandomState(3).randn(2, 6, 5, 7).astype(np.float32) * 3
    g = np.random.RandomState(4).randn(2, 5, 7, 1).astype(np.float32)
    c = torch.from_numpy(cost).requires_grad_()
    before = kernels.fused_soft_argmin_backward.launches
    (got,) = torch.autograd.grad(
        (soft_argmin(c, **ARGMIN) * torch.from_numpy(g)).sum(), c)
    assert kernels.fused_soft_argmin_backward.launches == before
    # softmax sums in another order: 1e-5 of gradients of order 1
    np.testing.assert_allclose(got.numpy(), jax_results["argmin_grad"],
                               rtol=1e-5, atol=1e-5)


def test_soft_argmin_backward_refuses_cpu():
    cost = torch.zeros(1, 3, 2, 2)
    vals = torch.zeros(3)
    with pytest.raises(ValueError, match="device"):
        kernels.fused_soft_argmin_backward(cost, vals, 1.0, None, None,
                                           None, torch.zeros(1, 2, 2, 1))


@pytest.mark.parametrize("sparse", [False, True])
def test_loss_evaluator_and_total_match_jax(jax_results, sparse):
    est, gt = loss_inputs(5)
    ev = tloss_builder.make_loss_evaluator(LOSS_CFG, sparse=sparse)
    d = ev([torch.from_numpy(e) for e in est], None, torch.from_numpy(gt))
    want, want_total = jax_results["loss", sparse]
    assert sorted(d) == sorted(want) == [f"l1_loss_lvl{i}" for i in range(3)]
    for k in d:
        np.testing.assert_allclose(float(d[k]), want[k], rtol=1e-6)
    np.testing.assert_allclose(float(tloss_builder.total_loss(d)),
                               want_total, rtol=1e-6)


def test_smooth_l1_single_level_and_start_disp(jax_results):
    est, gt = loss_inputs(5)
    got = disp_losses.smooth_l1_loss(torch.from_numpy(est[0]),
                                     torch.from_numpy(gt), max_disp=16,
                                     start_disp=1)
    assert list(got) == ["l1_loss_lvl0"]
    np.testing.assert_allclose(float(got["l1_loss_lvl0"]),
                               jax_results["l1_single"]["l1_loss_lvl0"],
                               rtol=1e-6)


@pytest.mark.parametrize("names", [("gerf_loss", "quantile_loss"),
                                   ("quantile_loss",)])
def test_unported_losses_raise(names):
    """Every loss of the JAX builder is ported (DeepPruner's quantile loss
    last, tests/test_torch_deeppruner.py holds it against JAX's): a loss
    name the JAX builder does not know raises as JAX's does (ValueError),
    also after the quantile loss and a ported loss (the GERF loss,
    StereoNet's) have run."""
    ev = tloss_builder.make_loss_evaluator(
        {**{n: dict(max_disp=4) for n in names}, "relative_loss": {}})
    zeros = torch.zeros(1, 2, 2, 1)
    with pytest.raises(ValueError, match="unknown loss 'relative_loss'"):
        ev([zeros], None, zeros, min_disparity=zeros, max_disparity=zeros)


def test_adaptive_pools_match_jax():
    from densematchingbenchmark_tpu.ops import pooling as jpool
    x = np.random.RandomState(9).randn(2, 8, 12, 1).astype(np.float32)
    for tfn, jfn in ((adaptive_avg_pool2d, jpool.adaptive_avg_pool2d),
                     (adaptive_max_pool2d, jpool.adaptive_max_pool2d)):
        # a mean of 6 in another order: ulps
        np.testing.assert_allclose(tfn(torch.from_numpy(x), 4, 3).numpy(),
                                   np.asarray(jfn(jnp.asarray(x), 4, 3)),
                                   rtol=1e-6, atol=1e-7)


def test_schedule_matches_jax(jax_results):
    schedule = toptim.make_lr_schedule(0.01, SCHEDULE, STEPS_PER_EPOCH)
    # JAX evaluates the schedule in float32
    np.testing.assert_allclose([schedule(i) for i in range(10)],
                               jax_results["schedule"], rtol=1e-6)


def test_rmsprop_clip_and_paramwise_match_optax(jax_results):
    names, params, grads = fake_params(6)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy()))
               for p in params]
    schedule = toptim.make_lr_schedule(0.01, SCHEDULE, STEPS_PER_EPOCH)
    opt = toptim.RMSprop(zip(names, tparams), schedule, max_norm=35.0,
                         paramwise=OPT_CFG["optimizer"]["paramwise_options"])
    assert opt.mults == [1.0, 2.0, 0.5, 0.5, 1.0]
    for step, g in enumerate(grads):
        opt.step([torch.from_numpy(x) for x in g])
        for got, want in zip(tparams, jax_results["optim"][step]):
            # rsqrt vs 1 / sqrt and the clip's product order: ulps of an
            # update of ~10 * lr
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       rtol=1e-6, atol=1e-7)
    assert opt.count == 3


def run_optimizer(variant):
    """The port's optimizer of ``variant`` through OPT_SCALES' steps;
    returns the parameters after each step and the optimizer."""
    names, params, grads = fake_params(6, OPT_SCALES)
    module = torch.nn.Module()
    for name, value in zip(names, params):
        mod, attr = name.split(".")
        if not hasattr(module, mod):
            module.add_module(mod, torch.nn.Module())
        setattr(getattr(module, mod), attr,
                torch.nn.Parameter(torch.from_numpy(value.copy())))
    opt, _ = toptim.build_optimizer(optimizer_cfg(variant), module,
                                    STEPS_PER_EPOCH)
    assert opt.names == names
    traj = []
    for g in grads:
        opt.step([torch.from_numpy(x) for x in g])
        traj.append([p.detach().numpy().copy() for p in opt.params])
    return traj, opt


def assert_trajectory(got, want):
    for step, (gs, ws) in enumerate(zip(got, want)):
        for g, w in zip(gs, ws):
            # rsqrt vs 1 / sqrt, the clip's and the bias correction's
            # products in another order: ulps of updates of ~lr
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {step}")


@pytest.mark.parametrize("key,value", [("momentum", 0.9), ("alpha", 0.9),
                                       ("eps", 1e-6)])
def test_rmsprop_options_not_ported_raise(jax_results, key, value):
    """RMSprop's options, once refused, now follow optax.rmsprop over five
    steps (the momentum trace of the learning-rate-scaled updates, eps
    inside the root), with the clip and the paramwise scales."""
    variant = f"{key}-{value}"
    assert OPT_VARIANTS[variant] == {"type": "rmsprop", key: value}
    traj, opt = run_optimizer(variant)
    assert_trajectory(traj, jax_results["optim", variant])
    assert isinstance(opt, toptim.RMSprop) and opt.count == 5
    state = opt.state_dict()
    assert set(state) == ({"nu", "trace", "count"} if key == "momentum"
                          else {"nu", "count"})


@pytest.mark.parametrize("variant", ["adam", "adam-betas", "sgd",
                                     "sgd-0.5"])
def test_adam_and_sgd_match_optax(jax_results, variant):
    traj, opt = run_optimizer(variant)
    assert_trajectory(traj, jax_results["optim", variant])
    # the state round-trips through a checkpoint
    other = run_optimizer(variant)[1]
    other.load_state_dict(opt.state_dict())
    assert all(torch.equal(a, b) for key in opt._STATE
               for a, b in zip(getattr(opt, key), getattr(other, key)))


def test_unknown_optimizer_raises():
    cfg = dict(OPT_CFG, optimizer=dict(type="lamb", lr=0.01))
    with pytest.raises(ValueError, match="lamb"):
        toptim.build_optimizer(cfg, torch.nn.Linear(2, 2), STEPS_PER_EPOCH)


def test_rmsprop_is_not_torch_rmsprop():
    # eps inside the root: for a zero first gradient and a tiny second one
    # the two optimizers part ways by orders of magnitude
    p = torch.nn.Parameter(torch.zeros(1))
    opt = toptim.RMSprop([("w", p)], lambda step: 1.0)
    opt.step([torch.tensor([1e-6])])
    ours = float(p.detach())
    q = torch.nn.Parameter(torch.zeros(1))
    ref = torch.optim.RMSprop([q], lr=1.0, alpha=0.99, eps=1e-8)
    q.grad = torch.tensor([1e-6])
    ref.step()
    np.testing.assert_allclose(ours, -1e-6 / np.sqrt(1e-14 + 1e-8),
                               rtol=1e-5)
    assert abs(float(q.detach()) / ours) > 5


def test_batchnorm_running_stats_match_flax(jax_results):
    x = np.random.RandomState(7).randn(3, 4, 5, 6, 8).astype(np.float32) * 2
    bn = BatchNorm(8, eps=1e-5, momentum=0.1).train()
    want_ys, want_mean, want_var = jax_results["bn"]
    for i in range(2):
        # the port's modules normalise the logical [B, C, ...] view
        y = bn(torch.from_numpy(x * (i + 1)).movedim(-1, 1)).movedim(1, -1)
        # Flax: E[x^2] - E[x]^2 in float32, torch: two-pass variance
        np.testing.assert_allclose(y.detach().numpy(), want_ys[i],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_mean,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), want_var, rtol=1e-5)
    # torch's own BN would have moved running_var with the unbiased one
    ref = torch.nn.BatchNorm3d(8, momentum=0.1).train()
    for i in range(2):
        ref(torch.from_numpy(x * (i + 1)).movedim(-1, 1))
    assert not np.allclose(ref.running_var.numpy(), want_var, rtol=1e-5)
    bn.eval()
    y = bn(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1)
    np.testing.assert_allclose(
        y.detach().numpy(), (x - want_mean) / np.sqrt(want_var + 1e-5),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,batch,epoch", [(10, 4, 0), (10, 4, 3),
                                           (7, 3, 1)])
def test_epoch_sampler_matches_jax(n, batch, epoch):
    # the trainer's sampler: one host, shuffled
    t = EpochSampler(n, batch, seed=5)
    j = JEpochSampler(n, batch, True, 1, 0, seed=5)
    np.testing.assert_array_equal(t.epoch_indices(epoch),
                                  j.epoch_indices(epoch))
    assert t.steps_per_epoch() == j.steps_per_epoch()


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_samples_match_jax(seed):
    j, t = synth_pair(seed)
    for idx in range(len(t)):
        want = j.load(idx)
        got = t.load(idx)
        assert sorted(got) == sorted(want)
        for k in ("leftImage", "rightImage", "leftDisp", "rightDisp"):
            np.testing.assert_array_equal(got[k], want[k])
        # the train transform's random crop, from equal generators
        got = t.__getitem__(idx, np.random.default_rng((1, 2, idx)))
        want = j.__getitem__(idx, np.random.default_rng((1, 2, idx)))
        for k in ("leftImage", "rightImage", "leftDisp"):
            np.testing.assert_array_equal(got[k], want[k])


def test_loader_batches_match_jax():
    j, t = synth_pair(1, length=7)
    jl = JDataLoader(j, 3, seed=2, num_workers=2)
    tl = DataLoader(t, 3, seed=2, num_workers=2)
    assert tl.steps_per_epoch() == jl.steps_per_epoch() == 3
    for epoch, start in ((0, 0), (1, 1)):
        jb = list(jl.epoch(epoch, start=start))
        tb = list(tl.epoch(epoch, start=start))
        assert len(tb) == len(jb) == 3 - start
        for a, b in zip(tb, jb):
            for k in ("leftImage", "rightImage", "leftDisp", "rightDisp"):
                np.testing.assert_array_equal(a[k], b[k])


def test_loader_stops_its_thread_when_left_early():
    import threading
    _, t = synth_pair(2, length=12)
    before = threading.active_count()
    loader = DataLoader(t, 2, seed=0, num_workers=2, prefetch=1)
    for _ in loader.epoch(0):
        break
    assert threading.active_count() == before


def test_loader_raises_a_failing_sample():
    _, t = synth_pair(2, length=4)

    def transform(sample, rng):
        raise OSError("unreadable sample")

    t.transform = transform
    with pytest.raises(OSError, match="unreadable"):
        list(DataLoader(t, 2, seed=0, num_workers=2).epoch(0))


def test_file_datasets_raise(tmp_path):
    """build_dataset builds each file dataset from an annotation file (and
    the synthetic one from its split's fields)."""
    img = np.arange(8 * 12 * 3, dtype=np.uint8).reshape(8, 12, 3)
    tio.save_png(str(tmp_path / "l.png"), img)
    tio.save_png(str(tmp_path / "r.png"), img[:, ::-1])
    tio.save_pfm(str(tmp_path / "d.pfm"), np.full((8, 12), 3.0, np.float32))
    tio.save_kitti_disp(str(tmp_path / "d.png"), np.full((8, 12), 2.5))
    for kind, disp in (("SceneFlow", "d.pfm"), ("KITTI-2012", "d.png"),
                       ("KITTI-2015", "d.png")):
        ann = tmp_path / f"{kind}.json"
        ann.write_text(json.dumps([{"left_image_path": "l.png",
                                    "right_image_path": "r.png",
                                    "left_disp_map_path": disp}]))
        ds = build_dataset({"type": kind, "data_root": str(tmp_path),
                            "train": {"annfile": str(ann)}}, "train")
        assert ds.name == kind and len(ds) == 1
        sample = ds[0]
        np.testing.assert_array_equal(sample["leftImage"], img)
        assert sample["leftDisp"].shape == (8, 12, 1)
        assert float(sample["leftDisp"].max()) == (3.0 if disp == "d.pfm"
                                                   else 2.5)
        assert "rightDisp" not in sample
    ds = build_dataset({"type": "Synthetic",
                        "train": {"length": 3, "height": 8, "width": 12,
                                  "max_disp": 4}}, "train")
    assert len(ds) == 3 and ds[0]["leftImage"].shape == (8, 12, 3)
    # FlyingChairs without an annotation file: JAX's KeyError
    with pytest.raises(KeyError, match="annfile"):
        build_dataset({"type": "FlyingChairs", "train": {}}, "train")
