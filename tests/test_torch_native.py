"""The port's host library (densematchingbenchmark_tpu_torch/native, built
here with g++ from csrc/dmb_native.cpp) against its plain version, the
numpy codec of data/io, and against the JAX package's native decoder.

- Against the codec, bitwise: every colour type and depth it reads with
  each row filter, one image data stream whose rows mix all five filters,
  KITTI disparities; the same refusals with the same ValueError.
- Against JAX's native decoder (skipped where its ``available()`` is
  False, as tests/data/test_native.py skips), bitwise: 8-bit RGB and gray
  images, 16-bit disparities, PFM of one and three channels in either byte
  order; ``normalize_crop`` within 1e-6.
- Where JAX's native decoder and its imageio branch differ (16-bit
  samples, alpha, colour disparities, gAMA, the PFM scale), the port keeps
  the result its readers gave before; each difference is pinned here
  (ROADMAP §3).
- A failed build raises with g++'s output, and the loaders do not fall
  back to numpy.
"""

import io as pyio
import struct
import sys
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from densematchingbenchmark_tpu import native as jnative
from densematchingbenchmark_tpu.data import io as jio

from densematchingbenchmark_tpu_torch import native
from densematchingbenchmark_tpu_torch.data import io
from densematchingbenchmark_tpu_torch.ops.cuda import _build

torch.set_num_threads(1)

H, W = 7, 13
JAX_NATIVE = pytest.mark.skipif(not jnative.available(),
                                reason="JAX's native library unavailable")
# colour type -> channels (data/io's _PNG_CHANNELS)
COLOURS = {"gray": 1, "gray_alpha": 2, "rgb": 3, "rgba": 4}


def image(channels, dtype, seed, shape=(H, W)):
    """A random image, [H, W] for one channel."""
    rng = np.random.RandomState(seed)
    top = np.iinfo(dtype).max
    img = rng.randint(0, top + 1, (*shape, channels)).astype(dtype)
    return img[..., 0] if channels == 1 else img


def chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def png_of_rows(img, filters, interlace=0, color=None):
    """``img`` as a PNG whose row y is filtered with ``filters[y]``,
    written here by hand (data/io's encoder filters every row alike)."""
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    depth = 8 * img.dtype.itemsize
    bpp = channels * img.dtype.itemsize
    raw = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(
        np.uint8).reshape(h, w * bpp).astype(np.int16)
    left = np.pad(raw, ((0, 0), (bpp, 0)))[:, :-bpp]
    up = np.pad(raw, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    pa, pb, pc = (np.abs(up - upleft), np.abs(left - upleft),
                  np.abs(left + up - 2 * upleft))
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = (0 * raw, left, up, (left + up) >> 1, paeth)
    body = b"".join(bytes([f]) + ((raw[y] - preds[f][y]) & 255).astype(
        np.uint8).tobytes() for y, f in enumerate(filters))
    color = {1: 0, 3: 2, 2: 4, 4: 6}[channels] if color is None else color
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                         0, interlace))
            + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


def plain(png, disparity=False):
    """The plain version: data/io's codec, converted as the loaders
    convert."""
    samples = io.decode_png(png)
    if disparity:
        return samples.astype(np.float32) / 256.0
    return io.image_rgb(samples)


def assert_bitwise(got, want):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("colour", sorted(COLOURS))
def test_png_equals_the_codec_bitwise(colour, depth, filter_type):
    img = image(COLOURS[colour], np.uint8 if depth == 8 else np.uint16,
                seed=depth + filter_type)
    png = io.encode_png(img, filter_type)
    assert_bitwise(native.decode_png(png), plain(png))
    assert_bitwise(native.decode_png(png, disparity=True),
                   plain(png, disparity=True))


@pytest.mark.parametrize("colour, dtype", [("rgb", np.uint8),
                                           ("gray_alpha", np.uint8),
                                           ("rgba", np.uint16)])
def test_png_rows_of_all_five_filters_in_one_stream(colour, dtype):
    img = image(COLOURS[colour], dtype, seed=3, shape=(11, W))
    filters = [y % 5 for y in range(11)][::-1]      # Paeth first, then down
    png = png_of_rows(img, filters)
    np.testing.assert_array_equal(io.decode_png(png), img)
    assert_bitwise(native.decode_png(png), plain(png))
    assert_bitwise(native.decode_png(png, disparity=True),
                   plain(png, disparity=True))


def kitti_disparity(seed):
    disp = np.random.RandomState(seed).uniform(0, 200, (H, W)).astype(
        np.float32)
    disp[0, :3] = 0.0                  # invalid pixels
    disp[1, 0] = 300.0                 # clipped to 65535 / 256
    return disp


def test_kitti_disparities_equal_the_codec(tmp_path):
    path = str(tmp_path / "d.png")
    io.save_kitti_disp(path, kitti_disparity(0))
    with open(path, "rb") as fp:
        want = plain(fp.read(), disparity=True)
    assert_bitwise(native.decode_png_disp16(path), want)
    assert_bitwise(io.load_kitti_disp(path), want)


@JAX_NATIVE
@pytest.mark.parametrize("writer", ["imageio", 0, 1, 2, 3, 4])
@pytest.mark.parametrize("colour", ["rgb", "gray"])
def test_images_equal_jax_native(tmp_path, colour, writer):
    img = image(COLOURS[colour], np.uint8, seed=7)
    path = str(tmp_path / "i.png")
    if writer == "imageio":            # Pillow picks a filter a row
        imageio.imwrite(path, img)
    else:
        io.save_png(path, img, writer)
    want = jnative.decode_png_rgb(path)
    assert_bitwise(native.decode_png_rgb(path), want)
    assert_bitwise(io.load_image(path), want)


@JAX_NATIVE
@pytest.mark.parametrize("seed", [1, 2])
def test_kitti_disparities_equal_jax_native(tmp_path, seed):
    path = str(tmp_path / "d.png")
    jio.save_kitti_disp(path, kitti_disparity(seed))
    want = jnative.decode_png_disp16(path)
    assert_bitwise(native.decode_png_disp16(path), want)
    assert_bitwise(io.load_kitti_disp(path), want)


def write_pfm(path, data, scale):
    """A PFM file in the byte order of ``scale``'s sign (negative:
    little-endian)."""
    with open(path, "wb") as fp:
        fp.write(b"PF\n" if data.ndim == 3 else b"Pf\n")
        fp.write(f"{data.shape[1]} {data.shape[0]}\n{scale}\n".encode())
        fp.write(np.flipud(data).astype("<f4" if scale < 0 else ">f4")
                 .tobytes())


@pytest.mark.parametrize("scale", [-1.0, 1.0])
@pytest.mark.parametrize("channels", [1, 3])
def test_pfm_equals_the_plain_reader_and_jax_native(tmp_path, channels,
                                                    scale):
    data = np.random.RandomState(channels).randn(
        *((H, W) if channels == 1 else (H, W, 3))).astype(np.float32) * 50
    path = str(tmp_path / "d.pfm")
    write_pfm(path, data, scale)
    with open(path, "rb") as fp:
        want, want_scale = io.decode_pfm(fp.read())
    got, got_scale = io.load_pfm(path)
    assert_bitwise(got, want)
    assert_bitwise(got, data)
    assert got_scale == want_scale == 1.0
    assert_bitwise(native.decode_pfm(path), data)
    if jnative.available():
        assert_bitwise(native.decode_pfm(path), jnative.decode_pfm(path))


def test_normalize_crop_against_numpy_and_jax_native():
    img = np.random.RandomState(3).rand(12, 14, 3).astype(np.float32) * 255
    mean, std = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
    got = native.normalize_crop(img, 2, 3, 8, 10, mean, std)
    want = (img[2:10, 3:13] - np.float32(mean)) / np.float32(std)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if jnative.available():
        np.testing.assert_allclose(
            got, jnative.normalize_crop(img, 2, 3, 8, 10, mean, std),
            rtol=0, atol=1e-6)
    gray = native.normalize_crop(img[..., 0], 0, 0, 12, 14, [100.0], [50.0])
    assert gray.shape == (12, 14, 1)
    with pytest.raises(ValueError, match="leaves"):
        native.normalize_crop(img, 5, 5, 8, 10, mean, std)


def palette_png():
    from PIL import Image
    buf = pyio.BytesIO()
    Image.fromarray(image(3, np.uint8, 0)).convert("P").save(buf, "png")
    return buf.getvalue()


def corrupt_crc(png):
    png = bytearray(png)
    png[30] ^= 1                       # a byte of IHDR's body
    return bytes(png)


def short_idat(img):
    """A PNG whose image data stops a row short."""
    png = io.encode_png(img)
    stride = img.shape[1] * (img.shape[2] if img.ndim == 3 else 1) + 1
    body = zlib.decompress(png[41:png.index(b"IEND") - 8])[:-stride]
    return png[:33] + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND",
                                                                  b"")


def with_depth(png, depth):
    """``png`` with its IHDR's bit depth set to ``depth`` (CRC kept
    right)."""
    ihdr = bytearray(png[16:29])
    ihdr[8] = depth
    return png[:8] + chunk(b"IHDR", bytes(ihdr)) + png[33:]


def filter_five(img):
    png = bytearray(png_of_rows(img, [0] * len(img)))
    raw = bytearray(zlib.decompress(bytes(png[41:png.index(b"IEND") - 8])))
    raw[0] = 5
    return bytes(png[:33]) + chunk(b"IDAT", zlib.compress(bytes(raw))) \
        + chunk(b"IEND", b"")


REFUSALS = {
    "signature": (lambda: b"GIF89a" + bytes(40), "not a PNG file"),
    "palette": (palette_png, "palette"),
    "adam7": (lambda: png_of_rows(image(3, np.uint8, 1), [0] * H,
                                  interlace=1), "Adam7"),
    "bad_crc": (lambda: corrupt_crc(io.encode_png(image(3, np.uint8, 2))),
                "bad CRC"),
    "short_idat": (lambda: short_idat(image(3, np.uint8, 3)),
                   "image data holds"),
    "filter_5": (lambda: filter_five(image(3, np.uint8, 4)),
                 "row filter 5 is not defined"),
    "bit_depth_4": (lambda: with_depth(io.encode_png(image(1, np.uint8, 5)),
                                       4), "bit depth 4"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_raise_the_codecs_value_error(tmp_path, monkeypatch, case):
    make, message = REFUSALS[case]
    png = make()
    with pytest.raises(ValueError, match=message) as plain_error:
        io.decode_png(png)
    for disparity in (False, True):
        with pytest.raises(ValueError) as native_error:
            native.decode_png(png, disparity)
        assert str(native_error.value) == str(plain_error.value)
    # load_image's refusal path: without imageio the codec's error stands
    path = str(tmp_path / "x.png")
    with open(path, "wb") as fp:
        fp.write(png)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ValueError) as load_error:
        io.load_image(path)
    assert str(load_error.value) == str(plain_error.value)


@pytest.mark.parametrize("case", ["header", "dimensions", "truncated"])
def test_pfm_refusals(tmp_path, case):
    path = str(tmp_path / "d.pfm")
    write_pfm(path, np.ones((H, W), np.float32), -1.0)
    with open(path, "rb") as fp:
        data = fp.read()
    data = {"header": b"P7" + data[2:],
            "dimensions": data.replace(f"{W} {H}".encode(), b"13 x", 1),
            "truncated": data[:-4]}[case]
    with open(path, "wb") as fp:
        fp.write(data)
    with pytest.raises(ValueError, match={"header": "not a PFM file",
                                          "dimensions": "malformed",
                                          "truncated": "truncated"}[case]):
        io.load_pfm(path)
    with pytest.raises(ValueError):
        io.decode_pfm(data)


def imageio_branch(monkeypatch):
    """JAX's data/io with its native decoder off: the imageio branch."""
    monkeypatch.setattr(jio, "_NATIVE", False)
    return jio


def with_gama(png, gamma):
    """``png`` with a gAMA chunk (gamma x 100000) after its IHDR."""
    return png[:33] + chunk(b"gAMA", struct.pack(">I", gamma)) + png[33:]


@JAX_NATIVE
@pytest.mark.parametrize("case", ["16_bit", "alpha", "colour_disparity",
                                  "gama", "pfm_scale"])
def test_jax_internal_differences_are_pinned(tmp_path, monkeypatch, case):
    """JAX's native decoder and JAX's imageio branch differ here; the port
    keeps the result its readers gave before this library (ROADMAP §3)."""
    path = str(tmp_path / ("d.pfm" if case == "pfm_scale" else "x.png"))
    if case == "16_bit":
        # JAX's native scales 16-bit samples by 255/65535; Pillow (JAX's
        # imageio branch) keeps gray 0-65535 and cuts RGB to 8 bits; the
        # port keeps 0-65535
        for channels in (1, 3):
            img = image(channels, np.uint16, seed=channels)
            io.save_png(path, img)
            got = io.load_image(path)
            assert_bitwise(got, io.image_rgb(img))
            np.testing.assert_allclose(jnative.decode_png_rgb(path),
                                       got * np.float32(255 / 65535),
                                       rtol=1e-6)
            ours = imageio_branch(monkeypatch).load_image(path)
            if channels == 1:
                assert_bitwise(ours, got)
            else:
                assert ours.max() <= 255 < got.max()
            monkeypatch.undo()
    elif case == "alpha":
        # JAX's native composites onto black (in linear light); the port
        # drops alpha, as imageio's branch does for RGBA (for gray + alpha
        # that branch keeps both samples, [H, W, 2])
        for channels in (2, 4):
            img = image(channels, np.uint8, seed=channels)
            img[::2, ..., -1] = 255                  # opaque rows
            io.save_png(path, img)
            got = io.load_image(path)
            assert_bitwise(got, io.image_rgb(img))
            jax_native = jnative.decode_png_rgb(path)
            assert_bitwise(jax_native[::2], got[::2])
            assert (jax_native[1::2] <= got[1::2]).all()
            assert (jax_native[1::2] < got[1::2]).any()
            ours = imageio_branch(monkeypatch).load_image(path)
            if channels == 4:
                assert_bitwise(ours, got)
            else:
                assert ours.shape == (H, W, 2)
                assert_bitwise(ours[..., 0], got[..., 0])
            monkeypatch.undo()
    elif case == "colour_disparity":
        # JAX's native takes one luminance channel; imageio's branch and
        # the port keep the channels
        img = image(3, np.uint8, seed=9)
        io.save_png(path, img)
        got = io.load_kitti_disp(path)
        assert_bitwise(got, img.astype(np.float32) / 256.0)
        assert jnative.decode_png_disp16(path).shape == (H, W)
        assert_bitwise(imageio_branch(monkeypatch).load_kitti_disp(path),
                       got)
    elif case == "gama":
        # a gAMA of 1.0: JAX's native converts the samples to sRGB; the
        # port and imageio's branch ignore the chunk
        img = image(3, np.uint8, seed=11)
        with open(path, "wb") as fp:
            fp.write(with_gama(io.encode_png(img), 100000))
        got = io.load_image(path)
        assert_bitwise(got, io.image_rgb(img))
        assert not np.array_equal(jnative.decode_png_rgb(path), got)
        assert_bitwise(imageio_branch(monkeypatch).load_image(path), got)
    else:
        # JAX's native branch returns the scale 1.0, its numpy branch and
        # the port the file's |scale|
        data = np.ones((H, W), np.float32)
        write_pfm(path, data, -2.5)
        assert jio.load_pfm(path)[1] == 1.0
        assert imageio_branch(monkeypatch).load_pfm(path)[1] == 2.5
        got, scale = io.load_pfm(path)
        assert scale == 2.5
        assert_bitwise(got, data)


def test_loaders_run_through_the_host_library(tmp_path, monkeypatch):
    calls = []
    real = native._lib

    def counting():
        calls.append(1)
        return real()
    monkeypatch.setattr(native, "_lib", counting)
    io.save_png(str(tmp_path / "i.png"), image(3, np.uint8, 0))
    io.save_kitti_disp(str(tmp_path / "d.png"), kitti_disparity(0))
    io.save_pfm(str(tmp_path / "d.pfm"), np.ones((H, W), np.float32))
    io.load_image(str(tmp_path / "i.png"))
    io.load_kitti_disp(str(tmp_path / "d.png"))
    io.load_disp(str(tmp_path / "d.png"))
    io.load_pfm(str(tmp_path / "d.pfm"))
    io.load_disp(str(tmp_path / "d.pfm"))
    assert len(calls) == 5


def test_decodes_in_threads_equal_serial():
    pngs = [io.encode_png(image(3, np.uint8, seed=i, shape=(40, 57)), i % 5)
            for i in range(12)]
    serial = [native.decode_png(p) for p in pngs]
    with ThreadPoolExecutor(4) as pool:
        threaded = list(pool.map(native.decode_png, pngs))
    for got, want in zip(threaded, serial):
        assert_bitwise(got, want)


def test_a_failed_build_raises_with_gxx_output(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "dmb_native.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    path = str(tmp_path / "i.png")
    io.save_png(path, image(3, np.uint8, 0))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed for "
                       r"dmb_native\.cpp:\n(.|\n)*error"):
        native.decode_png_rgb(path)
    # no loader falls back to the numpy codec
    with pytest.raises(RuntimeError, match="dmb_native.cpp"):
        io.load_image(path)
    assert not native.available()
    assert not list((tmp_path / "build").glob("*.so"))


def test_concurrent_first_loads_build_once(tmp_path, monkeypatch):
    """Threads that load the library at once wait for one build."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    barrier = threading.Barrier(4)

    def first():
        barrier.wait()
        return native._lib()
    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(lambda _: first(), range(4)))
    assert all(lib is libs[0] for lib in libs)
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        _build.library_path("dmb_native").name]
