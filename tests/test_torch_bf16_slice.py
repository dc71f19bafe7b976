"""The port's bfloat16 PSMNet inference slice end to end against the JAX
package's, on the CPU.

Both sides go through their own ``inference_stereo`` on
``PSMNet/scene_flow_bf16`` at max_disp 32 (8 cost-volume disparities; JAX
then runs its trunk unpacked, its D-packed schedule needing a multiple of
16, and its backbone row-packed), two random 50x60 pairs padded to 64x64,
in both eval modes. The weights are the port's seeded tree with every
BatchNorm made random, carried to JAX as a Flax tree (a Flax init of
PSMNet takes tens of seconds on the CPU).

The tolerance, a mean |difference| of 0.05 px and a largest of 0.3 px,
is sized from the JAX package's own bfloat16-vs-float32 gap on this
network with random BN (max_disp 64, three 50x60 pairs): 0.013-0.025 px
mean and 0.066-0.135 px at most, on disparities of 28-40 px; at this
file's size JAX's own gap is 0.007-0.014 px mean
(tests/bf16_gap_study.py). The two bfloat16 sides round at other points
(the port's fused trunk unit once after its epilogue, JAX's conv and BN
each), so they may differ by about as much as bfloat16 differs from
float32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu import apis as japis
from densematchingbenchmark_tpu.configs import get_config as jget_config

from densematchingbenchmark_tpu_torch import apis as tapis
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.utils import (flax_variables,
                                                    load_jax_variables)

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

M = 32
SMALL = {"model.max_disp": M,
         "model.cost_processor.cost_computation.max_disp": M // 4,
         "model.cost_processor.cost_aggregator.max_disp": M,
         "model.disp_predictor.max_disp": M,
         "data.test.input_shape": (64, 64)}
MEAN_ATOL, MAX_ATOL = 0.05, 0.3


def randomize_bn(variables, rng):
    """Numpy copy of ``variables`` with every BatchNorm's scale / bias /
    mean / var drawn at random, as tests/test_torch_psmnet.py does."""
    def walk(tree, in_bn):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, in_bn or k == "BatchNorm_0")
            elif in_bn and k == "scale":
                out[k] = rng.uniform(0.7, 1.1, v.shape).astype(np.float32)
            elif in_bn and k == "var":
                out[k] = rng.uniform(0.9, 1.4, v.shape).astype(np.float32)
            elif in_bn and k in ("bias", "mean"):
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.array(v)
        return out
    return walk(variables, False)


def pairs(n, shape, seed):
    rng = np.random.RandomState(seed)
    return [{"leftImage": rng.rand(*shape, 3).astype(np.float32) * 255,
             "rightImage": rng.rand(*shape, 3).astype(np.float32) * 255}
            for _ in range(n)]


@pytest.mark.parametrize("fused", [False, True])
def test_psmnet_bf16_inference_matches_jax(fused):
    """Measured per disparity map (tests/bf16_gap_study.py): mean
    |difference| 0.0084-0.0149 px (plain) and 0.0083-0.0148 (fused),
    largest 0.042-0.106 and 0.037-0.099, on disparities of 12.5-17.5 px;
    JAX's own float32 run of the same weights lies 0.007-0.014 px mean,
    0.031-0.072 px at most, from its bfloat16 one."""
    over = dict(SMALL, **{"model.eval.fused_upsample_argmin": fused})
    tmodel = tapis.init_model("PSMNet/scene_flow_bf16", device="cpu", **over)
    assert tmodel.cfg["model"]["dtype"] == "bfloat16"
    variables = randomize_bn(flax_variables(tmodel.module),
                             np.random.RandomState(0))
    load_jax_variables(tmodel.module, variables)
    jmodel = japis.StereoModel(jget_config("PSMNet/scene_flow_bf16", **over),
                               jax.tree.map(jnp.asarray, variables))
    batch = pairs(2, (50, 60), seed=1)
    want = japis.inference_stereo(jmodel, batch, pad_to_shape=(64, 64))
    kernels.reset_launch_counts()
    got = tapis.inference_stereo(tmodel, batch, pad_to_shape=(64, 64))
    # on the CPU every wrapper ran its plain version and counted nothing
    assert set(kernels.launch_counts().values()) == {0}
    assert all(p.dtype == torch.float32 for p in tmodel.module.parameters())
    for w, g in zip(want, got):
        assert len(g["disps"]) == len(w["disps"]) == 3
        for wd, gd in zip(w["disps"], g["disps"]):
            assert gd.shape == wd.shape == (1, 50, 60, 1)
            assert gd.dtype == np.float32
            diff = np.abs(gd - np.asarray(wd, np.float32))
            assert diff.mean() <= MEAN_ATOL and diff.max() <= MAX_ATOL, (
                diff.mean(), diff.max())
