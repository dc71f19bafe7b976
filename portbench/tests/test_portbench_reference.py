"""The plain reference against the port's float32 models on the CPU at
a small size, on the benchmark's seeded weights: the reference is written
anew, so agreement here says both compute the published function."""

import numpy as np
import pytest
import torch

from portbench import scenes
from portbench.check import reference_maps
from portbench.reference import stereo
from portbench.reference.precision import fp8_e4m3, identity
from portbench.weights import load_into, seeded_state

M = 16
OVERRIDES = {"model.max_disp": M,
             "model.cost_processor.cost_computation.max_disp": M // 4,
             "model.cost_processor.cost_aggregator.max_disp": M,
             "model.disp_predictor.max_disp": M}
MEAN, STD = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)


@pytest.mark.parametrize("name,family", [
    ("PSMNet/kitti_2015_f32", "PSMNet"),
    ("AcfNet/kitti_2015_uniform_f32", "AcfNet-uniform")])
def test_reference_matches_the_port_in_float32(name, family):
    from densematchingbenchmark_tpu_torch.apis import (inference_stereo,
                                                       init_model)
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    model = init_model(name, device="cpu", seed=5, **OVERRIDES)
    weights = seeded_state(model.module, 2 ** 31 + 3, cpu)
    load_into(model.module, weights)
    s = scenes.scene(9, 60, 120, 1.0, 12.0)
    port = inference_stereo(model, [{"leftImage": s["left"],
                                     "rightImage": s["right"]}],
                            pad_to_shape=(64, 128))[0]["disps"]
    ref = stereo.build(family, M, weights, cpu)
    maps = reference_maps(ref, s, (64, 128), MEAN, STD, cpu, identity)
    for p, r in zip(port, maps):
        r = r[4:, :120].numpy()
        assert np.abs(p[0, ..., 0] - r).max() < 1e-3
        assert np.ptp(r) > 0.1          # the maps are not flat


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([1.0, 1.1, 300.0, -448.0, 0.0])
    y = fp8_e4m3(x)
    assert y[3] == -448.0 and y[4] == 0.0
    # e4m3 steps are 1/8 of the binade: 1.1 * scale rounds to 1.125 there
    assert float((y - x).abs().max()) <= 448.0 / 16
    assert not torch.equal(y, x)
    assert torch.equal(identity(x), x)
