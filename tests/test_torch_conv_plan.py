"""The launch plan and weight image of the float32 conv block (K1, and K4 in
float32), on the CPU: ``conv3d_f32_plan`` and ``conv3d_f32_weights`` are
pure Python, so the shared-memory budget, the grid, the blocks' and
threads' cover of the output and the image's layout are checked here; the
kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from densematchingbenchmark_tpu_torch.ops.cuda import packed_conv3d_kernel as pk

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

# An H100: its SMs, and what an SM holds (registers, threads, blocks and
# shared memory, 1 KB of it kept per resident block)
SMS = 132
SM_REGS, SM_THREADS, SM_BLOCKS = 65536, 2048, 32
GRID_X = 2 ** 31 - 1


def residency(regs=232):
    """Blocks an SM holds of a kernel of ``regs`` registers a thread (ptxas
    gave the float32 block 232 on sm_90a; on the card the wrapper reads
    the built kernel's own residency), as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor counts them."""
    def blocks(cob, th, smem):
        threads = pk.f32_threads(cob, th)
        return min(SM_THREADS // threads, SM_BLOCKS,
                   SM_REGS // (threads * regs),
                   pk.SMEM_PER_SM // (smem + 1024))
    return blocks


# (B, R, pack, H, W, Ci, Co): the eval trunk at 384x1248 (K1, pack 1,
# batch 1), the training trunk at 256x512 (K4, pack 1, batch 3), the
# microbench's three cases (K4, pack 4) and ragged ones (H, W not multiples
# of a tile, Ci and Co of every width class)
EVAL = [(1, 48, 1, 96, 312, 64, 32), (1, 48, 1, 96, 312, 32, 32),
        (1, 24, 1, 48, 156, 64, 64), (1, 12, 1, 24, 78, 64, 64)]
TRAIN = [(3, 48, 1, 64, 128, 64, 32), (3, 48, 1, 64, 128, 32, 32),
         (3, 24, 1, 32, 64, 64, 64), (3, 12, 1, 16, 32, 64, 64)]
MICRO = [(1, 12, 4, 96, 312, 32, 32), (1, 12, 4, 96, 312, 64, 32),
         (1, 6, 4, 48, 156, 64, 64)]
RAGGED = [(1, 5, 1, 7, 45, 4, 4), (2, 3, 2, 9, 33, 12, 40),
          (1, 5, 4, 6, 70, 36, 68), (1, 4, 1, 13, 78, 64, 36),
          (1, 1, 4, 4, 5, 64, 64), (2, 3, 1, 7, 312, 12, 4)]


def covered(axis_len, tile, count):
    """Each index of [0, axis_len) covered once by ``count`` tiles."""
    hits = np.zeros(axis_len, int)
    for i in range(count):
        hits[i * tile:min((i + 1) * tile, axis_len)] += 1
    return (hits == 1).all()


def outputs_of(plan, b, d, h, w, co, blocks):
    """The (batch, depth, row, column, channel) outputs each of the
    ``blocks`` stores, as the kernel decodes its block and thread indices:
    block fastest first depth, batch, W tile, H tile, Cout tile; thread
    channel group fastest, then row, then column group; a thread's 16
    columns and its 4 channels. Masked at H, W, Co."""
    cob, th = plan["cob"], plan["th"]
    cg_n = cob // pk.F32_CO_T
    idx = np.asarray(blocks)[:, None]
    t = np.arange(plan["threads"])[None, :]
    dd = idx % d
    rest = idx // d
    bb = rest % b
    rest //= b
    x0 = rest % plan["tiles_w"] * pk.F32_TW
    rest //= plan["tiles_w"]
    y0 = rest % plan["tiles_h"] * th
    ct = rest // plan["tiles_h"]
    cg, row = t % cg_n, t // cg_n % th
    col = t // cg_n // th * pk.F32_CW
    n = np.broadcast(idx, t).shape
    j = np.arange(pk.F32_CW)
    k = np.arange(pk.F32_CO_T)
    yy = np.broadcast_to(y0 + row, n)[..., None, None]
    xx = (x0 + col)[..., None, None] + j[:, None]
    ch = (ct * cob + cg * pk.F32_CO_T)[..., None, None] + k
    shape = np.broadcast(yy, xx, ch).shape
    out = [np.broadcast_to(a[..., None, None], shape) for a in (bb, dd)]
    out += [np.broadcast_to(a, shape) for a in (yy, xx, ch)]
    keep = (out[2] < h) & (out[3] < w) & (out[4] < co)
    return [a[keep] for a in out]


@pytest.mark.parametrize("shape", EVAL + TRAIN + MICRO + RAGGED)
def test_plan_fits_the_card_and_its_grid(shape):
    b, r, pack, h, w, ci, co = shape
    plan = pk.conv3d_f32_plan(*shape, SMS, residency())
    assert plan["smem"] == pk.f32_smem(plan["cob"], plan["th"],
                                       plan["stages"])
    assert plan["smem"] <= pk.SMEM_PER_BLOCK          # 227 KB a block
    assert residency()(plan["cob"], plan["th"], plan["smem"]) >= 1
    assert plan["stages"] in (2, 3)
    assert plan["cob"] == (32 if co <= 32 else 64)
    assert plan["threads"] == pk.f32_threads(plan["cob"], plan["th"])
    assert plan["threads"] <= pk.F32_MAX_THREADS and plan["threads"] % 32 == 0
    assert plan["blocks"] <= GRID_X
    assert plan["blocks"] == (b * r * pack * plan["tiles_h"]
                              * plan["tiles_w"] * plan["cout_tiles"])
    assert covered(h, plan["th"], plan["tiles_h"])
    assert covered(w, pk.F32_TW, plan["tiles_w"])
    assert covered(co, plan["cob"], plan["cout_tiles"])


@pytest.mark.parametrize("shape", RAGGED)
def test_every_output_is_stored_once(shape):
    b, r, pack, h, w, ci, co = shape
    plan = pk.conv3d_f32_plan(*shape, SMS, residency())
    d = r * pack
    got = outputs_of(plan, b, d, h, w, co, range(plan["blocks"]))
    hits = np.zeros((b, d, h, w, co), int)
    np.add.at(hits, tuple(got), 1)
    assert (hits == 1).all()


@pytest.mark.parametrize("shape", EVAL + TRAIN)
def test_a_block_stores_its_tile_once(shape):
    # the path's shapes are too large to walk every block here: one
    # block's threads cover its tile (th rows x 32 columns x cob channels)
    # once, and the tiles cover the volume (the test above)
    b, r, pack, h, w, ci, co = shape
    plan = pk.conv3d_f32_plan(*shape, SMS, residency())
    yy, xx, ch = outputs_of(plan, 1, 1, plan["th"], pk.F32_TW, plan["cob"],
                            [0])[2:]
    hits = np.zeros((plan["th"], pk.F32_TW, plan["cob"]), int)
    np.add.at(hits, (yy, xx, ch), 1)
    assert (hits == 1).all()


def test_plan_at_the_path_shapes():
    # the eval and training trunks: the 32-channel units in 256-thread
    # blocks of 16 rows, the 64-channel units keep all of Cout in one
    # block of 8 rows; at 232 registers one such block fills an SM's
    # register file
    plans = [pk.conv3d_f32_plan(*s, SMS, residency()) for s in EVAL + TRAIN]
    assert [p["cob"] for p in plans] == [32, 32, 64, 64] * 2
    assert [p["cout_tiles"] for p in plans] == [1] * 8
    assert [p["th"] for p in plans] == [16, 16, 8, 8] * 2
    assert all(p["threads"] == 256 for p in plans)
    assert all(residency()(p["cob"], p["th"], p["smem"]) == 1
               for p in plans)
    for p in (plans[0], plans[1], plans[4], plans[5]):
        assert p["blocks"] >= 10 * SMS


def test_plan_follows_the_kernels_residency():
    # only the configurations an SM holds are candidates: a kernel whose
    # blocks of more than 2 rows fit no SM gets blocks of 2 rows
    plan = pk.conv3d_f32_plan(*TRAIN[2], SMS,
                              lambda cob, th, smem: 4 if th <= 2 else 0)
    assert plan["th"] == 2 and plan["threads"] == 64


def test_plan_refuses_a_kernel_no_sm_holds():
    with pytest.raises(RuntimeError, match="no launch plan"):
        pk.conv3d_f32_plan(*TRAIN[0], SMS, lambda cob, th, smem: 0)


@pytest.mark.parametrize("ci,co,cob", [(4, 4, 32), (12, 40, 64),
                                       (64, 68, 64), (32, 32, 32)])
def test_weight_image_is_the_kernels_layout(ci, co, cob):
    # element (dd, dh, dw, c, o) of the kernel sits where csrc/
    # conv3d_tile.cuh reads it: Cout tile o / cob, depth tap dd, slice
    # c / 8, tap 3 dh + dw, channel c % 8, output o % cob; zeros past Ci and
    # Co
    k = torch.randn(3, 3, 3, ci, co)
    image = pk.conv3d_f32_weights(k, cob)
    slices, tiles = -(-ci // 8), -(-co // cob)
    assert image.shape == (tiles, 3, slices, 9, 8, cob)
    image = image.reshape(-1)
    dd, tap, c, o = torch.meshgrid(torch.arange(3), torch.arange(9),
                                   torch.arange(ci), torch.arange(co),
                                   indexing="ij")
    offset = (((((o // cob) * 3 + dd) * slices + c // 8) * 9 + tap) * 8
              + c % 8) * cob + o % cob
    want = torch.zeros(tiles * 3 * slices * 9 * 8 * cob)
    want[offset.reshape(-1)] = k.reshape(-1)
    assert torch.equal(image, want)
