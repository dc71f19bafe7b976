"""Measurements behind the bfloat16 tolerances of the port's tests and of
chip_smoke.py, on the CPU, with JAX and the port on the same weights.

    JAX_PLATFORMS=cpu python tests/bf16_gap_study.py [--size H W] [--grads]

Prints, per section:

1. the values the bf16 test files report in their docstrings: each unit's
   largest gap to JAX's bf16 unit in bf16 steps and its running
   statistics' (tests/test_torch_bf16_units.py), the slice's disparity
   gaps to JAX's bf16 and JAX's own float32-vs-bf16 gap
   (tests/test_torch_bf16_slice.py), the train step's loss against JAX's
   (tests/test_torch_bf16_train.py);
2. the full-width PSMNet (max_disp 192, seed 0, default BN) on one random
   pair of ``--size`` (default 96x192): the bf16-vs-float32 disparity gap
   of JAX and of the port, the port's bf16 against JAX's bf16, the port
   with only its backbone or only its trunk in bf16, and the relative gap
   of its bf16 backbone features and low-resolution costs;
3. chip_smoke.py's small bf16 model (max_disp 32, seed 3) with its BN
   drawn as the CPU tests draw it (``chip_smoke.damp_bn``) and with the
   default BN: its bf16-vs-float32 gap on the CPU;
4. with ``--grads``: the bfloat16-vs-float32 cosine and norms of JAX's
   and the port's gradients at the bf16 train test's configuration (JAX's
   bf16 gradient takes about 34 s to compile).

Not a test: pytest does not collect it. It runs at small sizes only.
"""

import argparse
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import chip_smoke  # noqa: E402
import test_torch_bf16_slice as slice_test  # noqa: E402
import test_torch_bf16_train as train_test  # noqa: E402
import test_torch_bf16_units as unit_test  # noqa: E402
from densematchingbenchmark_tpu import apis as japis  # noqa: E402
from densematchingbenchmark_tpu.configs import get_config as jget  # noqa: E402
from densematchingbenchmark_tpu.losses import (  # noqa: E402
    make_loss_evaluator as jmake_ev)
from densematchingbenchmark_tpu.losses.builder import (  # noqa: E402
    total_loss as jtotal)
from densematchingbenchmark_tpu.models import (  # noqa: E402
    build_model as jbuild_model)
from densematchingbenchmark_tpu_torch import apis as tapis  # noqa: E402
from densematchingbenchmark_tpu_torch.configs import get_config  # noqa: E402
from densematchingbenchmark_tpu_torch.data import transforms  # noqa: E402
from densematchingbenchmark_tpu_torch.models import build_model  # noqa: E402
from densematchingbenchmark_tpu_torch.utils import (  # noqa: E402
    flax_variables, load_jax_variables)

F32, BF16 = "PSMNet/scene_flow_f32", "PSMNet/scene_flow_bf16"


def gaps(a, b):
    """Per disparity map (mean, largest) |a - b|, rounded."""
    return [(round(float(np.abs(x - y).mean()), 4),
             round(float(np.abs(x - y).max()), 3)) for x, y in zip(a, b)]


def rel(a, b):
    return round(float((a.float() - b.float()).norm() / b.float().norm()),
                 4)


def tests_section():
    for kind, pack, relu, train in unit_test.UNIT_CASES:
        junit, variables, jx, tunit, x = unit_test.unit_pair(
            kind, pack, relu, seed=3)
        jv = jax.tree.map(jnp.asarray, variables)
        tunit.train(train)
        if train:
            want, updates = junit.apply(jv, jx, train=True,
                                        mutable=["batch_stats"])
        else:
            want = junit.apply(jv, jx, train=False)
        if pack > 1:
            want = unit_test.jconv3d.unpack_volume(want, pack)
        want = np.asarray(want.astype(jnp.float32))
        got = tunit(torch.from_numpy(x)).detach().float().numpy()
        steps = np.abs(got - want).max() / (unit_test.BF16_STEP
                                            * np.abs(want).max())
        line = (f"unit {kind} JAX pack {pack} relu {relu} train {train}: "
                f"{steps:.3f} steps")
        if train:
            st = updates["batch_stats"]["BatchNorm_0"]
            bn = tunit.BatchNorm_0
            stats = []
            for k, b in (("mean", bn.running_mean), ("var", bn.running_var)):
                w = np.asarray(st[k])
                gap = np.abs(b.numpy() - w).max() / np.abs(w).max()
                stats.append(f"{k} {gap:.2e}")
            line += "; stats " + ", ".join(stats)
        print(line)
    batch = slice_test.pairs(2, (50, 60), seed=1)
    for fused in (False, True):
        over = dict(slice_test.SMALL,
                    **{"model.eval.fused_upsample_argmin": fused})
        tmodel = tapis.init_model(BF16, device="cpu", **over)
        variables = slice_test.randomize_bn(flax_variables(tmodel.module),
                                            np.random.RandomState(0))
        load_jax_variables(tmodel.module, variables)
        jv = jax.tree.map(jnp.asarray, variables)
        out = {name: [r["disps"] for r in japis.inference_stereo(
            japis.StereoModel(jget(name, **over), jv), batch,
            pad_to_shape=(64, 64))] for name in (F32, BF16)}
        got = [r["disps"] for r in tapis.inference_stereo(
            tmodel, batch, pad_to_shape=(64, 64))]
        for i in range(len(batch)):
            print(f"slice fused={fused} pair {i}: port bf16 vs JAX bf16 "
                  f"{gaps(got[i], out[BF16][i])}, JAX f32 vs JAX bf16 "
                  f"{gaps(out[F32][i], out[BF16][i])}")
    port, want = train_test.one_step.__wrapped__()
    print(f"train step loss: port {port['metrics']['loss']:.4f}, JAX "
          f"{want['loss']:.4f}")


def full_width_section(h, w):
    over = {"data.test.input_shape": (h, w)}
    rng = np.random.RandomState(0)
    pair = [{"leftImage": rng.rand(h, w, 3).astype(np.float32) * 255,
             "rightImage": rng.rand(h, w, 3).astype(np.float32) * 255}]
    port, jaxd = {}, {}
    for name in (F32, BF16):
        model = tapis.init_model(name, device="cpu", seed=0, **over)
        port[name] = tapis.inference_stereo(model, pair)[0]["disps"]
        jv = jax.tree.map(jnp.asarray, flax_variables(model.module))
        jaxd[name] = [np.asarray(d) for d in japis.inference_stereo(
            japis.StereoModel(jget(name, **over), jv), pair)[0]["disps"]]
    print(f"full width {h}x{w}: JAX bf16 vs f32 {gaps(jaxd[BF16], jaxd[F32])}"
          f"; port bf16 vs f32 {gaps(port[BF16], port[F32])}; port bf16 vs "
          f"JAX bf16 {gaps(port[BF16], jaxd[BF16])}; port f32 vs JAX f32 "
          f"{gaps(port[F32], jaxd[F32])}")
    for part in ("backbone", "trunk"):
        model = tapis.init_model(F32, device="cpu", seed=0, **over)
        mod = (model.module.backbone if part == "backbone"
               else model.module.cost_processor.aggregator)
        for sub in mod.modules():
            if hasattr(sub, "dtype"):
                sub.dtype = torch.bfloat16
        disps = tapis.inference_stereo(model, pair)[0]["disps"]
        print(f"  only the {part} in bf16: vs f32 {gaps(disps, port[F32])}")
    feats = {}
    for name in (F32, BF16):
        model = tapis.init_model(name, device="cpu", seed=0, **dict(
            over, **{"model.eval.fused_upsample_argmin": True}))
        s = transforms.normalize(dict(pair[0]), model.cfg["data"]["mean"],
                                 model.cfg["data"]["std"])
        left, right = (torch.from_numpy(s[k])[None]
                       for k in ("leftImage", "rightImage"))
        with torch.inference_mode():
            feats[name] = (model.module.backbone(left, right),
                           model.module(left, right)["costs"])
    print(f"  bf16 vs f32 relative gap: backbone features "
          f"{[rel(a, b) for a, b in zip(feats[BF16][0], feats[F32][0])]}, "
          f"low-resolution costs "
          f"{[rel(a, b) for a, b in zip(feats[BF16][1], feats[F32][1])]}")


def small_model_section():
    rng = np.random.RandomState(2)
    pair = chip_smoke.random_pairs(rng, 1, chip_smoke.SMALL_IMAGE)
    for drawn in (True, False):
        for fused in (False, True):
            over = dict(chip_smoke.SMALL,
                        **{"model.eval.fused_upsample_argmin": fused})
            out = {}
            for name in (F32, BF16):
                model = tapis.init_model(name, device="cpu", seed=3, **over)
                if drawn:
                    chip_smoke.damp_bn(model.module, 3)
                out[name] = tapis.inference_stereo(
                    model, pair, pad_to_shape=(64, 128))[0]["disps"]
            print(f"small model, BN {'drawn' if drawn else 'default'}, "
                  f"fused={fused}: bf16 vs f32 {gaps(out[BF16], out[F32])}")


def grads_section():
    cfg = get_config(BF16, **train_test.TINY)
    module = build_model(cfg, torch.Generator().manual_seed(0))
    variables = train_test.randomize_bn(flax_variables(module),
                                        np.random.RandomState(0))
    batch = train_test.make_batch(1)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ev = train_test.make_loss_evaluator(cfg["model"]["losses"])
    flat = {}
    for name in (F32, BF16):
        m = build_model(get_config(name, **train_test.TINY))
        load_jax_variables(m, variables)
        _, grads = train_test.port_grads(m, tbatch, ev)
        flat["port", name] = torch.cat(
            [grads[n].flatten().double() for n in sorted(grads)])
        jcfg = jget(name, **train_test.TINY)
        jmodel = jbuild_model(jcfg)
        jev = jmake_ev(jcfg["model"]["losses"])
        jv = jax.tree.map(jnp.asarray, variables)

        def loss_fn(params):
            o, _ = jmodel.apply(
                {"params": params, "batch_stats": jv["batch_stats"]},
                jnp.asarray(batch["leftImage"]),
                jnp.asarray(batch["rightImage"]), train=True,
                mutable=["batch_stats"])
            return jtotal(jev(o["disps"], o["costs"],
                              jnp.asarray(batch["leftDisp"])))

        jgrads = jax.jit(jax.grad(loss_fn))(jv["params"])
        flat["jax", name] = torch.from_numpy(np.concatenate(
            [np.asarray(g, np.float64).ravel()
             for g in jax.tree.leaves(jgrads)]))
    for side in ("port", "jax"):
        a, b = flat[side, BF16], flat[side, F32]
        print(f"gradients, {side}: bf16 vs f32 cosine "
              f"{float(a @ b / (a.norm() * b.norm())):.3f}, norms "
              f"{float(a.norm()):.3f} / {float(b.norm()):.3f}")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, nargs=2, default=(96, 192),
                   metavar=("H", "W"))
    p.add_argument("--grads", action="store_true")
    args = p.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    tests_section()
    full_width_section(*args.size)
    small_model_section()
    if args.grads:
        grads_section()


if __name__ == "__main__":
    main()
