"""Shared set-up of the AcfNet parity tests (tests/test_torch_acfnet*.py):
the tiny configurations on both sides and the weights they share.

Both packages build AcfNet at max_disp 16 (4 cost-volume disparities,
cmn in_planes 16). The JAX side runs its plain schedule (``pack`` 0 for
the backbone and the trunk: the same parameter tree, no Pallas interpret
run), jitted once per function with XLA's cheaper CPU back end
(``jit_call``). The weights are the port's seeded tree,
with every BatchNorm's parameters and statistics and every conv bias drawn
at random (identity BN or a zero bias would hide a fold bug: AcfNet's 7
aggregator units outside the hourglasses carry a conv bias into the
trunk's epilogue), carried to JAX as a Flax tree.
"""

import jax
import numpy as np
import torch

from densematchingbenchmark_tpu.configs import get_config as jget_config

from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

M = 16
B, H, W = 2, 32, 64


def overrides(name, **extra):
    over = {"model.max_disp": M,
            "model.cost_processor.cost_computation.max_disp": M // 4,
            "model.cost_processor.cost_aggregator.max_disp": M,
            "model.disp_predictor.max_disp": M,
            "model.losses.l1_loss.max_disp": M,
            "model.losses.focal_loss.max_disp": M,
            "model.eval.upper_bound": M,
            "model.backbone.pack": 0,
            "model.cost_processor.cost_aggregator.pack": 0}
    if "adaptive" in name:
        over.update({"model.cmn.in_planes": M,
                     "model.cmn.losses.nll_loss.max_disp": M})
    over.update(extra)
    return over


def configs(name, **extra):
    """(JAX config, port config) of ``name`` at the tiny size."""
    return (jget_config(name, **overrides(name, **extra)),
            get_config(name, **overrides(name, **extra)))


def randomize(variables, rng):
    """Numpy copy of a Flax tree with every BatchNorm's scale / bias /
    mean / var and every conv bias drawn at random: BN scale in [0.7,
    1.1], var in [0.9, 1.4], bias and mean ~ 0.1 N(0, 1) (as
    tests/test_torch_psmnet.py), conv biases ~ 0.1 N(0, 1)."""
    def walk(tree, parent):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, k)
            elif parent == "BatchNorm_0" and k == "scale":
                out[k] = rng.uniform(0.7, 1.1, v.shape).astype(np.float32)
            elif parent == "BatchNorm_0" and k == "var":
                out[k] = rng.uniform(0.9, 1.4, v.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.array(v)
        return out
    return walk(variables, None)


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


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


# XLA's CPU back end without its expensive LLVM passes: measured on a CPU
# with one thread, the compile of the tiny adaptive train step falls from
# about 11 s to 5 s (its tracing takes 7 s more either way), and its loss
# is the same to float32 rounding
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jit_call(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with FAST_COMPILE."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)
