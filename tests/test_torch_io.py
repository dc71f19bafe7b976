"""The port's file IO, file datasets, grouped sampler, colour maps and metric
table against the JAX package's, on the CPU.

The port reads PNG with its own numpy + zlib codec. It must read files
written by imageio (Pillow, which picks a row filter per row) bit for bit,
write files that imageio and the JAX package's reader read bit for bit,
and do both for each of the five row filters. Everything here is exact.
"""

import io as pyio
import json
import os
import struct
import sys
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from densematchingbenchmark_tpu.data import io as jio
from densematchingbenchmark_tpu.data import build_dataset as jbuild_dataset
from densematchingbenchmark_tpu.data import transforms as jtransforms
from densematchingbenchmark_tpu.data.loader import DataLoader as JDataLoader
from densematchingbenchmark_tpu.data.sampler import (
    GroupedEpochSampler as JGrouped, aspect_group_flags as jflags)
from densematchingbenchmark_tpu.evaluation import format as jformat
from densematchingbenchmark_tpu.visualization import colormap as jcolormap

from densematchingbenchmark_tpu_torch.data import (DataLoader,
                                                   GroupedEpochSampler,
                                                   aspect_group_flags,
                                                   build_dataset, io,
                                                   transforms)
from densematchingbenchmark_tpu_torch.evaluation import format as tformat
from densematchingbenchmark_tpu_torch.visualization import (SaveResultTool,
                                                            colormap)

torch.set_num_threads(1)

MEAN, STD = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)


def photo(shape, dtype, seed):
    """A smooth random image: Pillow's per-row filter choice then uses
    several filter types, Average and Paeth among them."""
    rng = np.random.RandomState(seed)
    top = np.iinfo(dtype).max
    x = np.cumsum(rng.randn(*shape), axis=1) + np.cumsum(
        rng.randn(*shape), axis=0)
    x = (x - x.min()) / (np.ptp(x) + 1e-9)
    x[rng.rand(*shape) < 0.05] = rng.rand()     # some noise rows too
    return (x * top).astype(dtype)


def row_filters(png):
    """The filter byte of every row of a PNG (one IDAT chunk or many)."""
    pos, idat, header = 8, b"", None
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        kind, body = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        header = struct.unpack(">IIBBBBB", body) if kind == b"IHDR" else header
        idat += body if kind == b"IDAT" else b""
        pos += 12 + n
    w, h, depth, color = header[:4]
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[color] * depth // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, w * bpp + 1)[:, 0].tolist())


KINDS = {"rgb8": ((37, 53, 3), np.uint8), "gray8": ((37, 53), np.uint8),
         "rgba8": ((37, 53, 4), np.uint8), "gray16": ((37, 53), np.uint16)}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_png_decoder_reads_imageio_files(kind):
    img = photo(*KINDS[kind], seed=len(kind))
    buf = pyio.BytesIO()
    imageio.imwrite(buf, img, format="png")
    png = buf.getvalue()
    if kind == "rgb8":                # Pillow chose sequential filters too
        assert {3, 4} & row_filters(png), row_filters(png)
    got = io.decode_png(png)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("kind", ["rgb8", "gray16"])
def test_png_encoder_each_filter_round_trips(tmp_path, kind, filter_type):
    img = photo(*KINDS[kind], seed=filter_type)
    path = str(tmp_path / "x.png")
    io.save_png(path, img, filter_type=filter_type)
    with open(path, "rb") as fp:
        assert row_filters(fp.read()) == {filter_type}
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(io.load_png(path), img)
    if kind == "rgb8":
        np.testing.assert_array_equal(io.load_image(path), jio.load_image(path))
    else:
        np.testing.assert_array_equal(io.load_kitti_disp(path),
                                      jio.load_kitti_disp(path))


def test_png_decoder_refuses_palette_and_interlace(tmp_path):
    buf = pyio.BytesIO()
    imageio.imwrite(buf, photo((8, 9, 3), np.uint8, 0), format="png")
    from PIL import Image
    pal = pyio.BytesIO()
    Image.open(pyio.BytesIO(buf.getvalue())).convert("P").save(pal, "png")
    with pytest.raises(ValueError, match="palette"):
        io.decode_png(pal.getvalue())
    png = bytearray(io.encode_png(photo((8, 9), np.uint8, 0)))
    png[28] = 1                        # IHDR's interlace method: Adam7
    png[29:33] = struct.pack(">I", zlib.crc32(bytes(png[12:29])))
    with pytest.raises(ValueError, match="Adam7"):
        io.decode_png(bytes(png))
    png[30] ^= 1                       # a corrupt chunk
    with pytest.raises(ValueError, match="CRC"):
        io.decode_png(bytes(png))


def adam7_png(img):
    """An 8-bit RGB image as an Adam7-interlaced PNG (every row of the
    seven passes unfiltered), which Pillow does not write."""
    h, w, _ = img.shape
    rows = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = img[y0::dy, x0::dx]
        if sub.size:
            rows += b"".join(b"\0" + r.tobytes() for r in sub)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["jpeg", "palette_png", "adam7_png"])
def test_load_image_reads_what_the_codec_refuses_as_jax(tmp_path, kind):
    """A file the port's codec refuses (another format, a palette or an
    Adam7 PNG) is read through imageio, as JAX's load_image reads it:
    float32 [H, W, 3], equal to JAX's exactly."""
    from PIL import Image
    img = Image.fromarray(photo((8, 9, 3), np.uint8, 1))
    path = str(tmp_path / ("x.jpg" if kind == "jpeg" else "x.png"))
    if kind == "jpeg":
        img.save(path, "jpeg")
    elif kind == "palette_png":
        img.convert("P").save(path, "png")
    else:
        with open(path, "wb") as fp:
            fp.write(adam7_png(np.asarray(img)))
    if kind != "jpeg":
        with open(path, "rb") as fp, pytest.raises(ValueError):
            io.decode_png(fp.read())
    got = io.load_image(path)
    assert got.dtype == np.float32 and got.shape == (8, 9, 3)
    np.testing.assert_array_equal(got, jio.load_image(path))


def test_load_image_keeps_the_refusal_without_imageio(tmp_path,
                                                      monkeypatch):
    """Where imageio does not import (the card's machine), a file the
    codec refuses raises the codec's ValueError; a PNG it takes is read
    as before."""
    from PIL import Image
    path = str(tmp_path / "x.jpg")
    Image.fromarray(photo((8, 9, 3), np.uint8, 2)).save(path, "jpeg")
    png = str(tmp_path / "x.png")
    io.save_png(png, photo((8, 9, 3), np.uint8, 2))
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ValueError, match="PNG images only"):
        io.load_image(path)
    np.testing.assert_array_equal(io.load_image(png),
                                  photo((8, 9, 3), np.uint8, 2))


@pytest.mark.parametrize("shape", [(6, 7), (6, 7, 3)])
def test_pfm_round_trips_with_jax(tmp_path, shape):
    data = np.random.RandomState(0).randn(*shape).astype(np.float32)
    io.save_pfm(str(tmp_path / "a.pfm"), data)
    jio.save_pfm(str(tmp_path / "b.pfm"), data)
    for path in ("a.pfm", "b.pfm"):
        got, scale = io.load_pfm(str(tmp_path / path))
        want, _ = jio.load_pfm(str(tmp_path / path))
        np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(want, data)
        assert scale == 1.0


def test_kitti_disp_round_trips_with_jax(tmp_path):
    disp = np.random.RandomState(1).uniform(0, 200, (9, 11)).astype(
        np.float32)
    disp[0, 0] = 300.0                 # clipped to 65535 / 256
    io.save_kitti_disp(str(tmp_path / "a.png"), disp)
    jio.save_kitti_disp(str(tmp_path / "b.png"), disp)
    for path in ("a.png", "b.png"):
        np.testing.assert_array_equal(io.load_disp(str(tmp_path / path)),
                                      jio.load_disp(str(tmp_path / path)))
    np.testing.assert_array_equal(io.load_disp(str(tmp_path / "a.png")),
                                  io.load_disp(str(tmp_path / "b.png")))


def write_dataset(root, kind, sizes):
    """A tiny annotated dataset of ``kind`` (PFM GT for SceneFlow, KITTI
    PNG GT otherwise). Returns the annotation file's path."""
    rng = np.random.RandomState(len(kind))
    items = []
    for i, (h, w) in enumerate(sizes):
        item = {"height": h, "width": w}
        for side in ("left", "right"):
            rel = f"{side}_{i}.png"
            io.save_png(os.path.join(root, rel),
                        (rng.rand(h, w, 3) * 255).astype(np.uint8))
            item[f"{side}_image_path"] = rel
            disp = rng.uniform(0, 30, (h, w)).astype(np.float32)
            if kind == "SceneFlow":
                rel = f"{side}_{i}.pfm"
                io.save_pfm(os.path.join(root, rel), disp)
            else:
                rel = f"{side}_disp_{i}.png"
                io.save_kitti_disp(os.path.join(root, rel), disp)
            item[f"{side}_disp_map_path"] = rel
        items.append(item)
    ann = os.path.join(root, "ann.json")
    with open(ann, "w") as fp:
        json.dump(items, fp)
    return ann


@pytest.mark.parametrize("kind", ["SceneFlow", "KITTI-2012", "KITTI-2015"])
def test_file_datasets_match_jax(tmp_path, kind):
    ann = write_dataset(str(tmp_path), kind, [(9, 14), (8, 12), (9, 13)])
    data_cfg = {"type": kind, "data_root": str(tmp_path), "mean": MEAN,
                "std": STD, "eval": {"annfile": ann, "use_right_disp": True}}
    got = build_dataset(data_cfg, "eval", transforms.make_eval_transform(
        (12, 16), MEAN, STD))
    want = jbuild_dataset(data_cfg, "eval", jtransforms.make_eval_transform(
        (12, 16), MEAN, STD))
    assert type(got).__name__ == type(want).__name__ and got.name == kind
    assert len(got) == len(want) == 3
    for i in range(3):
        g, w = got[i], want[i]
        assert set(g) == set(w) == {"leftImage", "rightImage", "leftDisp",
                                    "rightDisp", "original_size"}
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_grouped_sampler_matches_jax(seed):
    flags = np.random.RandomState(seed).randint(0, 2, 11)
    got = GroupedEpochSampler(11, 3, flags, seed=seed)
    want = JGrouped(11, 3, flags, seed=seed)
    assert got.steps_per_epoch() == want.steps_per_epoch()
    for epoch in range(3):
        np.testing.assert_array_equal(got.epoch_indices(epoch),
                                      want.epoch_indices(epoch))


class Sized:
    """A dataset of frames of two aspects, with or without per-item sizes
    in its annotation list."""

    def __init__(self, annotated):
        self.sizes = [(4, 8), (8, 4), (4, 8), (8, 4), (4, 8)]
        if annotated:
            self.data_list = [{"height": h, "width": w} for h, w in self.sizes]

    def __len__(self):
        return len(self.sizes)

    def __getitem__(self, i, rng=None):
        h, w = self.sizes[i]
        return {"leftImage": np.full((h, w, 3), i, np.float32),
                "rightImage": np.zeros((h, w, 3), np.float32),
                "original_size": (h, w)}


@pytest.mark.parametrize("annotated", [True, False])
def test_aspect_group_flags_and_grouped_loader_match_jax(annotated):
    ds = Sized(annotated)
    flags = aspect_group_flags(ds)
    np.testing.assert_array_equal(flags, jflags(ds))
    # without sizes in the annotations every sample joins sample 0's group
    assert flags.tolist() == ([1, 0, 1, 0, 1] if annotated else [1] * 5)
    if annotated:           # (one group of two shapes would not collate)
        got = list(DataLoader(ds, 2, seed=3, group_flags=flags).epoch(1))
        want = list(JDataLoader(ds, 2, seed=3, group_flags=flags).epoch(1))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["leftImage"], w["leftImage"])


@pytest.mark.parametrize("pandas", [True, False])
def test_metrics_table_matches_jax(monkeypatch, pandas):
    if not pandas:
        monkeypatch.setitem(sys.modules, "pandas", None)
    results = {f"disp_{d}/{r}{m}": float(np.random.RandomState(d).rand()
                                         * 10 + len(r + m))
               for d in (0, 2) for r in ("", "occ_", "noc_")
               for m in ("1px", "2px", "3px", "5px", "epe")}
    assert tformat.metrics_table(results) == jformat.metrics_table(results)
    assert tformat.metrics_table({}) == jformat.metrics_table({})


def test_colormap_matches_jax():
    rng = np.random.RandomState(0)
    est = rng.uniform(0, 60, (9, 13)).astype(np.float32)
    gt = est + rng.randn(9, 13).astype(np.float32) * 8
    gt[gt < 2] = 0
    left = rng.uniform(0, 255, (9, 13, 3)).astype(np.float32)
    np.testing.assert_array_equal(colormap.disp_map(est.ravel() / 60),
                                  jcolormap.disp_map(est.ravel() / 60))
    for max_disp in (None, 48):
        np.testing.assert_array_equal(
            colormap.disp_to_color(est, max_disp),
            jcolormap.disp_to_color(est, max_disp))
    np.testing.assert_array_equal(colormap.disp_err_to_color(est, gt),
                                  jcolormap.disp_err_to_color(est, gt))
    np.testing.assert_array_equal(colormap.group_color(est, gt, left),
                                  jcolormap.group_color(est, gt, left))


def test_save_result_tool_writes_what_jax_reads(tmp_path):
    rng = np.random.RandomState(2)
    est = rng.uniform(0, 60, (1, 9, 13, 1)).astype(np.float32)
    gt = rng.uniform(0, 60, (1, 9, 13, 1)).astype(np.float32)
    left = rng.uniform(0, 255, (1, 9, 13, 3)).astype(np.float32)
    SaveResultTool(str(tmp_path))("a", est, gt, left)
    np.testing.assert_array_equal(
        jio.load_kitti_disp(str(tmp_path / "disp_0" / "a.png")),
        np.clip(est[0, ..., 0] * 256, 0, 65535).astype(np.uint16) / 256.0)
    np.testing.assert_array_equal(
        imageio.imread(str(tmp_path / "color_disp" / "a.png")),
        np.clip(jcolormap.disp_to_color(est[0, ..., 0]), 0, 255).astype(
            np.uint8))
    np.testing.assert_array_equal(
        imageio.imread(str(tmp_path / "group_disp" / "a.png")),
        np.clip(jcolormap.group_color(est[0, ..., 0], gt[0, ..., 0],
                                      left[0]), 0, 255).astype(np.uint8))
