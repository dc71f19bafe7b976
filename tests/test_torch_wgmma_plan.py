"""The launch plan of the bfloat16 (tensor-core) route of K4 and K5, on the
CPU: ``wgmma_plan`` is pure Python, so its shared-memory budget, the blocks'
cover of the output and the width rule are checked here; the kernels
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import itertools

import pytest
import torch

from densematchingbenchmark_tpu_torch.ops.cuda import packed_conv3d_kernel as pk

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

# An H100's SMs, and the most registers a thread that ptxas gave each
# order's kernels on sm_90a over the channel slices (chip_smoke.py prints
# its report; on the card the wrapper reads the built kernel's own)
SMS = 132
REGS = {"K4": 115, "K5": 222}

# (B, R, pack, H, W, Ci, Co): the microbench's three cases (pack 4), the
# four training trunk shapes (pack 1, batch 3), and small ragged ones
SHAPES = [(1, 12, 4, 96, 312, 32, 32), (1, 12, 4, 96, 312, 64, 32),
          (1, 6, 4, 48, 156, 64, 64),
          (3, 48, 1, 64, 128, 64, 32), (3, 48, 1, 64, 128, 32, 32),
          (3, 24, 1, 32, 64, 64, 64), (3, 12, 1, 16, 32, 64, 64),
          (2, 5, 1, 7, 70, 32, 40), (1, 17, 1, 5, 33, 32, 40),
          (1, 1, 4, 4, 5, 32, 32), (2, 3, 2, 3, 64, 48, 8),
          (1, 5, 4, 9, 130, 16, 64)]


def covered(axis_len, tile, count):
    """Each index of [0, axis_len) covered once by ``count`` tiles."""
    hits = [0] * axis_len
    for i in range(count):
        for j in range(i * tile, min((i + 1) * tile, axis_len)):
            hits[j] += 1
    return hits == [1] * axis_len


@pytest.mark.parametrize("order", ["K4", "K5"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_fits_and_covers_every_output_once(order, shape):
    b, r, pack, h, w, ci, co = shape
    plan = pk.wgmma_plan(order, b, r, pack, h, w, ci, co, SMS, REGS[order])
    assert plan["smem"] <= pk.SMEM_PER_BLOCK
    assert 2 <= plan["stages"] <= 4 and ci % plan["ck"] == 0
    d = r * pack
    if order == "K4":
        assert (plan["dc"], plan["chunks"]) == (1, d)   # depth fastest
    assert covered(d, plan["dc"], plan["chunks"])
    assert covered(h, pk.WGMMA_TH, plan["tiles_h"])
    assert covered(w, pk.WGMMA_TW, plan["tiles_w"])
    assert covered(co, pk.WGMMA_N, plan["cout_tiles"])
    # the kernel's decode of blockIdx.x (depth chunk fastest, then batch,
    # W tile, H tile, Cout tile) is a bijection onto those tiles
    sizes = (plan["chunks"], b, plan["tiles_w"], plan["tiles_h"],
             plan["cout_tiles"])
    assert plan["blocks"] == b * plan["chunks"] * plan["tiles_h"] \
        * plan["tiles_w"] * plan["cout_tiles"]
    seen = set()
    for idx in range(plan["blocks"]):
        key = []
        for n in sizes:
            key.append(idx % n)
            idx //= n
        seen.add(tuple(key))
    assert seen == set(itertools.product(*map(range, sizes)))


def test_plan_at_the_microbench_cases():
    # K4's blocks fit two to an SM at Ci 32 (its shared memory and
    # registers), one at Ci 64; K5's registers allow one, so at Ci 32 it
    # takes four ring stages, and the chunk that wastes the least of the
    # last wave
    k4 = [pk.wgmma_plan("K4", *s, SMS, REGS["K4"]) for s in SHAPES[:3]]
    k5 = [pk.wgmma_plan("K5", *s, SMS, REGS["K5"]) for s in SHAPES[:3]]
    assert [p["ck"] for p in k5] == [32, 64, 64]
    assert pk.SMEM_PER_SM // (k4[0]["smem"] + 1024) == 2
    assert pk.SMEM_PER_SM // (k4[1]["smem"] + 1024) == 1
    assert [p["stages"] for p in k4] == [2, 2, 2]
    assert [p["stages"] for p in k5] == [4, 2, 2]
    assert [p["dc"] for p in k5] == [16, 16, 8]


@pytest.mark.parametrize("regs,stages", [
    (96, 2), (115, 2), (128, 2),     # two blocks an SM: two stages
    (129, 4), (222, 4), (255, 4),    # one: as many stages as fit
])
def test_plan_follows_the_kernels_registers(regs, stages):
    # K4 at the microbench's 32->32 case: shared memory fits two blocks an
    # SM at two stages; registers past 128 a thread (allocated in units of
    # 8) fit one block, which then takes four stages
    plan = pk.wgmma_plan("K4", *SHAPES[0], SMS, regs)
    assert plan["stages"] == stages


@pytest.mark.parametrize("ci,co,ok", [
    (16, 8, True), (32, 40, True), (48, 64, True), (112, 32, True),
    (4, 8, False), (8, 32, False), (24, 32, False), (32, 12, False),
    (128, 32, False),
])
def test_width_rule(ci, co, ok):
    if ok:
        pk.check_wgmma_widths(ci, co)
        pk.wgmma_plan("K5", 1, 2, 2, 4, 8, ci, co, SMS, REGS["K5"])
    else:
        with pytest.raises(ValueError, match="bfloat16"):
            pk.wgmma_plan("K5", 1, 2, 2, 4, 8, ci, co, SMS, REGS["K5"])


@pytest.mark.parametrize("ci,co", [(16, 8), (32, 40), (48, 64)])
def test_weight_image_is_the_kernels_slab_layout(ci, co):
    # element (tap, c, o) of the kernel sits where csrc/conv3d_wgmma.cuh
    # reads it: Cout tile, slab (tap, c / 16), core matrix (o / 8 within
    # the tile, (c % 16) / 8), row o % 8, column c % 8; zeros past Co
    k = torch.randn(3, 3, 3, ci, co)
    tiles = -(-co // pk.WGMMA_N)
    image = pk.wgmma_weights(k, tiles).reshape(-1)
    tap, c, o = torch.meshgrid(torch.arange(27), torch.arange(ci),
                               torch.arange(co), indexing="ij")
    n, kc = o % pk.WGMMA_N, c % 16
    offset = ((o // pk.WGMMA_N) * 27 * ci * pk.WGMMA_N
              + (tap * (ci // 16) + c // 16) * 16 * pk.WGMMA_N
              + (n // 8) * 128 + (kc // 8) * 64 + (n % 8) * 8 + kc % 8)
    want = torch.zeros(tiles * 27 * ci * pk.WGMMA_N)
    want[offset.reshape(-1)] = k.reshape(-1)
    assert torch.equal(image, want)
