"""The roofline and FLOP arithmetic against hand counts."""

import pytest

from portbench import roofline


def test_trunk_call_bound_by_hand():
    # PSMNet's first trunk unit at 384x1248, batch 4: 4 x 48 x 96 x 312
    # voxels, 64 -> 32 channels
    vox = 4 * 48 * 96 * 312
    flops = 2 * 27 * 64 * 32 * vox                  # 635.9 GFLOP
    nbytes = 2 * vox * 96 + 2 * 27 * 64 * 32 + 8 * 32
    assert flops / 989e12 > nbytes / 3.35e12         # bound by operations
    assert roofline.trunk_call_bound_s(vox, 64, 32) == pytest.approx(
        flops / 989e12)
    # a 1-channel volume is bound by its bytes
    assert roofline.trunk_call_bound_s(1000, 1, 8) == pytest.approx(
        (2 * 1000 * 9 + 2 * 27 * 8 + 64) / 3.35e12)
    assert roofline.trunk_bound_s([(vox, 64, 32)] * 3) == pytest.approx(
        3 * flops / 989e12)


def test_count_flops_matches_the_zoo():
    # the port's tools/benchmark.py counts 1350.6 and 1355.0 GFLOPs a
    # 384x1248 forward (PERF.md's zoo); the reference's convolutions
    # give the same
    assert roofline.count_flops("PSMNet", 192, 384, 1248) == 1350585499648
    assert roofline.count_flops("AcfNet-uniform", 192, 384,
                                1248) == 1355002101760


def test_count_flops_by_hand_at_a_small_size():
    # AcfNet uniform is PSMNet with three learned ConvTranspose3d(1, 1, 8,
    # stride 4) upsamplers where PSMNet upsamples trilinearly (not
    # counted): each multiplies every input voxel of the 1/4-scale cost
    # by 8^3 taps
    d, h, w = 16, 64, 128
    diff = (roofline.count_flops("AcfNet-uniform", d, h, w)
            - roofline.count_flops("PSMNet", d, h, w))
    inputs = (d // 4) * (h // 4) * (w // 4)
    assert diff == 3 * 2 * 8 ** 3 * inputs
