"""The launch plan of the bfloat16 (tensor-core) route of K4 and K5, on the
CPU: ``wgmma_plan`` is pure Python, so its shared-memory budget, the blocks'
cover of the output and the width rule are checked here; the kernels
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import pytest
import torch

from densematchingbenchmark_tpu_torch.ops.cuda import packed_conv3d_kernel as pk

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

# An H100's SMs, and the most registers a thread that ptxas gave each
# order's kernels on sm_90a over the channel slices (chip_smoke.py prints
# its report; on the card the wrapper reads the built kernel's own): K4's
# block of 512 threads takes at most 128
SMS = 132
REGS = {"K4": 128, "K5": 222}

# (B, R, pack, H, W, Ci, Co): the microbench's three cases (pack 4), the
# four training trunk shapes (pack 1, batch 3), small ragged ones, and the
# four inference trunk shapes at 384x1248 (pack 1) at batch 1, 3 and 4
TRUNK = [(48, 96, 312, 64, 32), (48, 96, 312, 32, 32), (24, 48, 156, 64, 64),
         (12, 24, 78, 64, 64)]
SHAPES = [(1, 12, 4, 96, 312, 32, 32), (1, 12, 4, 96, 312, 64, 32),
          (1, 6, 4, 48, 156, 64, 64),
          (3, 48, 1, 64, 128, 64, 32), (3, 48, 1, 64, 128, 32, 32),
          (3, 24, 1, 32, 64, 64, 64), (3, 12, 1, 16, 32, 64, 64),
          (2, 5, 1, 7, 70, 32, 40), (1, 17, 1, 5, 33, 32, 40),
          (1, 1, 4, 4, 5, 32, 32), (2, 3, 2, 3, 64, 48, 8),
          (1, 5, 4, 9, 130, 16, 64),
          (1, 1, 1, 6, 45, 112, 8), (2, 2, 1, 5, 78, 16, 40),
          (3, 13, 1, 7, 130, 64, 64)] + [
    (b, d, 1, h, w, ci, co) for b in (1, 3, 4) for d, h, w, ci, co in TRUNK]


def block_items(plan, d):
    """(Cout tile, first item, end) of each block, as csrc/conv3d_wgmma.cuh
    decodes blockIdx.x: Cout tile = index // per_tile; K5 (dc > 0) a chunk
    of dc depths of one tile, K4 a balanced share of the tile's items."""
    per = plan["per_tile"]
    for idx in range(plan["blocks"]):
        ct, share = divmod(idx, per)
        if plan["dc"]:
            chunks = -(-d // plan["dc"])
            d0 = share % chunks * plan["dc"]
            lo = share // chunks * d + d0
            yield ct, lo, lo + min(plan["dc"], d - d0)
        else:
            yield (ct, share * plan["items"] // per,
                   (share + 1) * plan["items"] // per)


def runs(lo, hi, d):
    """The runs (tile, d0, d1, zs, ze) of items [lo, hi), as the kernel's
    ``run_at`` walks them."""
    i = lo
    while i < hi:
        d0 = i % d
        d1 = min(d, d0 + hi - i)
        yield i // d, d0, d1, max(d0 - 1, 0), min(d1, d - 1)
        i += d1 - d0


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
    tiles = b * plan["tiles_h"] * plan["tiles_w"]
    th, tw, threads = pk.WGMMA_TILES[order]
    assert covered(h, th, plan["tiles_h"])
    assert covered(w, tw, plan["tiles_w"])
    assert covered(co, pk.WGMMA_N, plan["cout_tiles"])
    assert plan["items"] == tiles * d
    assert plan["blocks"] == plan["per_tile"] * plan["cout_tiles"]
    if order == "K4":
        # persistent: at most the blocks resident on the card, every block
        # with work
        assert plan["dc"] == 0 and plan["per_tile"] <= plan["items"]
        assert plan["blocks"] <= SMS * 4
    # every (Cout tile, work item) once over the blocks, and every output
    # depth of a run with its input planes staged
    hits = [0] * (plan["cout_tiles"] * plan["items"])
    for ct, lo, hi in block_items(plan, d):
        assert lo < hi
        for tile, d0, d1, zs, ze in runs(lo, hi, d):
            assert tile < tiles
            for o in range(d0, d1):
                hits[ct * plan["items"] + tile * d + o] += 1
                assert zs <= max(o - 1, 0) and min(o + 1, d - 1) <= ze
    assert hits == [1] * len(hits)


@pytest.mark.parametrize("order", ["K4", "K5"])
@pytest.mark.parametrize("shape", SHAPES[-12:])
def test_cached_plan_equals_a_fresh_one(order, shape):
    # the wrapper's plan, kept per (plan function, library, SMs, shape),
    # with the registers the library reports (a stand-in here)
    class Library:
        stand_in_K4_bf16_regs = stand_in_K5_bf16_regs = staticmethod(
            lambda ck: REGS[order])

    lib, prefix = Library(), f"stand_in_{order}"
    first = pk.bf16_plan(pk.wgmma_plan, lib, prefix, order, SMS, *shape)
    assert first == pk.wgmma_plan(order, *shape, SMS, REGS[order])
    assert pk.bf16_plan(pk.wgmma_plan, lib, prefix, order, SMS,
                        *shape) is first


def test_plan_at_the_microbench_cases():
    # shared memory would fit two blocks an SM at Ci 32, one at Ci 64; the
    # registers of both blocks allow one, so at Ci 32 both take four ring
    # stages; K5 the chunk that wastes the least of the last wave, K4 one
    # block an SM for each Cout tile
    k4 = [pk.wgmma_plan("K4", *s, SMS, REGS["K4"]) for s in SHAPES[:3]]
    k5 = [pk.wgmma_plan("K5", *s, SMS, REGS["K5"]) for s in SHAPES[:3]]
    assert [p["ck"] for p in k5] == [32, 64, 64]
    assert pk.SMEM_PER_SM // (k4[0]["smem"] + 1024) == 1
    assert pk.SMEM_PER_SM // (pk._wgmma_smem(32, 2, "K4") + 1024) == 2
    assert pk.SMEM_PER_SM // (k4[1]["smem"] + 1024) == 1
    assert [p["stages"] for p in k4] == [4, 2, 2]
    assert [p["stages"] for p in k5] == [4, 2, 2]
    assert [p["dc"] for p in k5] == [16, 16, 8]
    assert [(p["per_tile"], p["blocks"]) for p in k4] == [
        (132, 132), (132, 132), (66, 132)]


@pytest.mark.parametrize("regs,stages", [
    (48, 2), (56, 2), (64, 2),       # two blocks an SM: two stages
    (65, 4), (96, 4), (128, 4),      # one: as many stages as fit
])
def test_plan_follows_the_kernels_registers(regs, stages):
    # K4 at the microbench's 32->32 case: shared memory fits two blocks an
    # SM at two stages; registers past 64 a thread (allocated in units of
    # 8, 512 threads a block) fit one block, which then takes four stages
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


# (Ci, Co, the bfloat16 block takes them, the float32 block takes them):
# every boundary of both rules, GCNet's 128 -> 128 units, DeepPruner's odd
# 2C + 1 raw-cost channels, and the trunks' widths
WIDTHS = [
    (16, 8, True, True), (32, 32, True, True), (64, 32, True, True),
    (64, 64, True, True), (96, 32, True, True), (112, 8, True, True),
    (112, 112, True, True), (128, 128, False, True), (128, 32, False, True),
    (144, 32, False, True), (32, 12, False, True), (32, 4, False, True),
    (8, 32, False, True), (24, 32, False, True), (4, 4, False, True),
    (65, 64, False, False), (64, 65, False, False), (33, 32, False, False),
    (1, 32, False, False), (32, 1, False, False), (6, 8, False, False),
    (2, 2, False, False), (113, 64, False, False), (256, 256, False, True),
]


@pytest.mark.parametrize("ci,co,bf16,f32", WIDTHS)
def test_route_widths(ci, co, bf16, f32):
    """Both blocks' width rule is one function, ``route_width_fault``,
    which the bfloat16 check raises on; ``route_widths`` runs any Ci -> Co
    at widths the block takes: Ci and Co padded to the least multiples
    of 16 and 8 (bfloat16) or of 4 (float32), unchanged where the block
    takes them, and the padded Ci in the fewest contiguous slices (the
    block takes up to 112: one in float32) that each the block takes."""
    assert (pk.route_width_fault(torch.bfloat16, ci, co) is None) is bf16
    assert (pk.route_width_fault(torch.float32, ci, co) is None) is f32
    if bf16:
        pk.check_wgmma_widths(ci, co)
    else:
        with pytest.raises(ValueError, match="bfloat16 route"):
            pk.check_wgmma_widths(ci, co)
    for dtype, takes, (mi, mo) in ((torch.bfloat16, bf16, (16, 8)),
                                   (torch.float32, f32, (4, 4))):
        widths = pk.route_widths(dtype, ci, co)
        assert widths.ci == -(-ci // mi) * mi
        assert widths.co == -(-co // mo) * mo
        if takes:
            assert widths == (ci, co, ((0, ci),))
        slices = widths.slices
        assert slices[0][0] == 0 and slices[-1][1] == widths.ci
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
        assert len(slices) == (-(-widths.ci // 112)
                               if dtype == torch.bfloat16 else 1)
        for lo, hi in slices:
            assert pk.route_width_fault(dtype, hi - lo, widths.co) is None


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


@pytest.mark.parametrize("ci,co", [(16, 8), (32, 40), (64, 64)])
def test_prepared_operands_are_the_image_of_the_kernel(ci, co):
    # wgmma_operands: the bfloat16 image the per-call route builds, its Cout
    # tiles and widths, the epilogue as the route fills it; a width the
    # route does not take raises
    k = torch.randn(3, 3, 3, ci, co)
    scale = torch.rand(co)
    prepared = pk.wgmma_operands(k, scale, 0.5, pack=2)
    tiles = -(-co // pk.WGMMA_N)
    assert (prepared.cout_tiles, prepared.ci, prepared.co,
            prepared.pack) == (tiles, ci, co, 2)
    assert prepared.image.dtype == torch.bfloat16
    assert torch.equal(prepared.image,
                       pk.wgmma_weights(k.bfloat16(), tiles))
    assert torch.equal(prepared.scale, scale.repeat(2))
    assert torch.equal(prepared.bias, torch.full((2 * co,), 0.5))
    with pytest.raises(ValueError, match="bfloat16"):
        pk.wgmma_operands(torch.randn(3, 3, 3, 24, co))


@pytest.mark.parametrize("pack", [1, 4])
def test_full_epilogue_at_pack_1_is_a_view(pack):
    # a [Co] term at pack 1 is the caller's tensor, not a copy
    v = torch.rand(8)
    full = pk.full_epilogue(v, pack, 8, "cpu")
    assert torch.equal(full, v.repeat(pack))
    assert (full.data_ptr() == v.data_ptr()) == (pack == 1)
