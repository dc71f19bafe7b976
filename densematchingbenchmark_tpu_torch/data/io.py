"""Image and disparity files: PFM, PNG, PPM / PGM and the KITTI uint16
disparity PNG.

Counterpart of densematchingbenchmark_tpu/data/io.py:25-92. The JAX package
reads PNG and PFM through its native decoder (libpng) where that builds,
else through imageio; the port needs neither library (the GPU machines it
runs on may have no imaging library). ``load_image`` (PNG),
``load_kitti_disp`` and ``load_pfm`` read through the port's host library
(densematchingbenchmark_tpu_torch/native: the chunks walked and the image
data inflated here, ``png_stream``, the row filters undone and the samples
converted to float32 in C++), which it builds with g++ at first use. Its
plain version is the numpy codec here, which the tests and chip_smoke.py
hold it against:

- decode: 8- and 16-bit gray, gray+alpha, RGB and RGBA, not interlaced,
  all five row filters; a palette image or an Adam7-interlaced one raises.
- encode: the same colour types and depths, with one filter for every row.

and a reader of binary 8-bit PPM and PGM (P6, P5; FlyingChairs' frames)
in numpy. ``load_image`` reads what these refuse (another format such as
JPEG, a palette or an Adam7 PNG, an ASCII or 16-bit PPM) through imageio
where that package imports, as the JAX package reads every image; without
it the refusal stands.

Filters None, Sub and Up undo a row at a time with whole-row numpy ops.
Average and Paeth need each pixel's reconstructed left neighbour, so an
image that has one of those rows is undone along anti-diagonals instead:
pixel (y, x) needs only (y, x-1), (y-1, x) and (y-1, x-1), which all lie on
the previous two diagonals, so every step of the loop undoes the H pixels
of one diagonal at once (H + W - 1 steps).
"""

import os
import re
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel: gray, RGB, gray + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def pfm_header(data, name="PFM file"):
    """PFM bytes -> (height, width, channels, scale, offset of the
    samples): three header lines ('PF' or 'Pf', '<width> <height>', the
    scale, whose sign is the byte order); ValueError if it is not one or
    its samples are short."""
    pos = 0

    def line():
        nonlocal pos
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        text, pos = data[pos:end].decode("latin-1"), end
        return text

    header = line().rstrip()
    if header not in ("PF", "Pf"):
        raise ValueError(f"{name}: not a PFM file (header {header!r})")
    channels = 3 if header == "PF" else 1
    dims = line()
    m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dims)
    if not m:
        raise ValueError(f"{name}: malformed PFM dimensions {dims!r}")
    width, height = int(m.group(1)), int(m.group(2))
    scale = float(line().rstrip())
    if len(data) - pos < 4 * width * height * channels:
        raise ValueError(f"{name}: PFM data truncated")
    return height, width, channels, scale, pos


def decode_pfm(data):
    """PFM bytes -> (float32 array [H, W] or [H, W, 3], |scale|), in
    numpy: the plain version of the native reader."""
    height, width, channels, scale, pos = pfm_header(data)
    shape = (height, width, 3) if channels == 3 else (height, width)
    samples = np.frombuffer(data, ("<" if scale < 0 else ">") + "f4",
                            height * width * channels, pos)
    # PFM stores rows bottom-to-top
    return np.flipud(samples.reshape(shape)).astype(np.float32), abs(scale)


def load_pfm(path):
    """Read a PFM file -> (float32 array [H, W] or [H, W, 3], |scale|),
    through the host library."""
    from .. import native
    return native.read_pfm(path)


def save_pfm(path, data, scale=1.0):
    """Write a float32 [H, W] or [H, W, 3] array as little-endian PFM."""
    data = np.asarray(data, np.float32)
    with open(path, "wb") as fp:
        fp.write(b"PF\n" if data.ndim == 3 else b"Pf\n")
        fp.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        fp.write(f"{-abs(scale)}\n".encode())  # negative = little-endian
        np.flipud(data).astype("<f4").tofile(fp)


def _paeth(a, b, c):
    """The Paeth predictor of int16 arrays: left a, up b, up-left c."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftypes, rows, bpp):
    """Undo filters None (0), Sub (1) and Up (2), a row at a time."""
    out = np.empty_like(rows)
    prior = np.zeros(rows.shape[1], np.uint8)
    for y, f in enumerate(ftypes):
        line = rows[y]
        if f == 1:
            line = np.cumsum(line.reshape(-1, bpp), axis=0,
                             dtype=np.uint8).reshape(-1)
        elif f == 2:
            line = line + prior
        out[y] = line
        prior = out[y]
    return out


def _unfilter_diagonals(ftypes, rows, bpp):
    """Undo any mix of the five filters, one anti-diagonal a step."""
    h, stride = rows.shape
    w = stride // bpp
    ys = np.arange(h)[None, :]
    diag = np.arange(w)[:, None] + ys           # [W, H]: x + y of (y, x)
    steps = h + w - 1
    # skew[t, y] is the filtered pixel (y, t - y); zero off the image, which
    # keeps the reconstruction left of the image zero as well
    skew = np.zeros((steps, h, bpp), np.int16)
    skew[diag, ys] = rows.reshape(h, w, bpp).transpose(1, 0, 2)
    # rec[t + 2, y + 1] is the reconstructed pixel (y, t - y); rec[:, 0] is
    # the zero row above the image and rec[:2] the zero diagonals before it
    rec = np.zeros((steps + 2, h + 1, bpp), np.int16)
    f = ftypes.astype(np.int16)[:, None]
    sub, up, avg, paeth = (f == 1), (f == 2), (f == 3), (f == 4)
    for t in range(steps):
        a, b, c = rec[t + 1, 1:], rec[t + 1, :-1], rec[t, :-1]
        pred = (np.where(sub, a, 0) + np.where(up, b, 0)
                + np.where(avg, (a + b) >> 1, 0)
                + np.where(paeth, _paeth(a, b, c), 0))
        rec[t + 2, 1:] = (skew[t] + pred) & 255
    return rec[diag + 2, ys + 1].transpose(1, 0, 2).astype(np.uint8).reshape(
        h, stride)


def png_stream(data):
    """PNG bytes -> (height, width, bit depth, channels, the inflated
    image data: a filter byte and width * channels * depth / 8 bytes a
    row). Walks the chunks (every CRC checked) and checks what the
    decoders read; ValueError otherwise."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if color not in _PNG_CHANNELS:
        raise ValueError(f"PNG colour type {color} (palette) is not "
                         "supported")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} is not supported")
    if interlace:
        raise ValueError("Adam7-interlaced PNG is not supported")
    channels = _PNG_CHANNELS[color]
    stream = zlib.decompress(b"".join(idat))
    if len(stream) != h * (w * channels * depth // 8 + 1):
        raise ValueError(f"PNG image data holds {len(stream)} bytes, not "
                         f"{h * (w * channels * depth // 8 + 1)}")
    return h, w, depth, channels, stream


def decode_png(data):
    """PNG bytes -> uint8 or uint16 array, [H, W] (gray) or [H, W, C], in
    numpy: the plain version of the native decoder."""
    h, w, depth, channels, stream = png_stream(data)
    bpp = channels * depth // 8
    raw = np.frombuffer(stream, np.uint8).reshape(h, w * bpp + 1)
    ftypes, rows = raw[:, 0], raw[:, 1:]
    if ftypes.max() > 4:
        raise ValueError(f"PNG row filter {ftypes.max()} is not defined")
    unfilter = _unfilter_diagonals if ftypes.max() >= 3 else _unfilter_rows
    pixels = unfilter(ftypes, rows, bpp)
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    return pixels.reshape((h, w) if channels == 1 else (h, w, channels))


def encode_png(img, filter_type=0, level=6):
    """uint8 or uint16 array, [H, W] (gray) or [H, W, C] with C in 1-4 ->
    PNG bytes, every row filtered with ``filter_type`` (0-4)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG holds uint8 or uint16 samples, not "
                         f"{img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    channels = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 3: 2, 2: 4, 4: 6}.get(channels)
    if img.ndim not in (2, 3) or color is None:
        raise ValueError(f"PNG image of shape {img.shape}")
    if filter_type not in range(5):
        raise ValueError(f"PNG row filter {filter_type} is not defined")
    h, w = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    bpp = channels * img.dtype.itemsize
    raw = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(
        np.uint8).reshape(h, w * bpp).astype(np.int16)
    left = np.pad(raw, ((0, 0), (bpp, 0)))[:, :-bpp]
    up = np.pad(raw, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    pred = (0, left, up, (left + up) >> 1, _paeth(left, up, upleft))
    rows = ((raw - pred[filter_type]) & 255).astype(np.uint8)
    body = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows],
                          axis=1)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (_PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(body.tobytes(), level))
            + chunk(b"IEND", b""))


def load_png(path):
    with open(path, "rb") as fp:
        return decode_png(fp.read())


def save_png(path, img, filter_type=0):
    with open(path, "wb") as fp:
        fp.write(encode_png(img, filter_type))


_PNM_CHANNELS = {b"P5": 1, b"P6": 3}
_PNM_FIELD = re.compile(rb"(?:\s|#[^\r\n]*[\r\n])*([^\s#]+)")


def decode_pnm(data):
    """Binary 8-bit PGM (P5) or PPM (P6) bytes -> uint8 [H, W] or
    [H, W, 3]. The header's fields (magic, width, height, maxval) may be
    separated by whitespace and '#' comments; one whitespace byte ends
    it. Any other kind of file, or a maxval other than 255, raises
    ValueError."""
    fields, pos = [], 0
    for _ in range(4):
        m = _PNM_FIELD.match(data, pos)
        if m is None:
            raise ValueError("truncated PNM header")
        fields.append(m.group(1))
        pos = m.end()
        if fields[0] not in _PNM_CHANNELS:
            raise ValueError(f"not a binary PGM / PPM file "
                             f"({fields[0][:2]!r})")
    try:
        w, h, maxval = (int(f) for f in fields[1:])
    except ValueError:
        raise ValueError(f"bad PNM header fields {fields[1:]}") from None
    if maxval != 255:
        raise ValueError(f"PNM maxval {maxval}: the reader takes 8-bit "
                         "files (255) only")
    if pos >= len(data) or not data[pos:pos + 1].isspace():
        raise ValueError("PNM header not ended by whitespace")
    channels = _PNM_CHANNELS[fields[0]]
    count = h * w * channels
    if len(data) - pos - 1 < count:
        raise ValueError(f"PNM raster holds {len(data) - pos - 1} bytes, "
                         f"{w}x{h}x{channels} needs {count}")
    img = np.frombuffer(data, np.uint8, count, pos + 1)
    return img.reshape((h, w) if channels == 1 else (h, w, 3)).copy()


def encode_pnm(img):
    """uint8 [H, W] or [H, W, 3] -> binary PGM / PPM bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    magic = b"P5" if img.ndim == 2 else b"P6"
    h, w = img.shape[:2]
    return magic + f"\n{w} {h}\n255\n".encode() + img.tobytes()


def save_pnm(path, img):
    with open(path, "wb") as fp:
        fp.write(encode_pnm(img))


_PNM_SUFFIXES = (".ppm", ".pgm", ".pnm")


def _read_refused(path, refusal):
    """An image the codec refused, through imageio where it imports (JAX's
    reader, densematchingbenchmark_tpu/data/io.py:62-68); else the
    refusal."""
    try:
        from imageio.v2 import imread
    except ImportError:
        raise refusal from None
    return np.asarray(imread(path))


def image_rgb(img):
    """Decoded samples [H, W] or [H, W, C] -> float32 [H, W, 3]: gray
    repeated, alpha dropped (what the native decoder writes)."""
    img = img.astype(np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    elif img.shape[2] == 2:                      # gray + alpha
        img = np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def load_image(path):
    """Image -> float32 [H, W, 3] (gray repeated, alpha dropped): a PNG
    through the host library, a PPM or PGM through ``decode_pnm``, any
    other file they refuse through imageio where that imports
    (``_read_refused``)."""
    from .. import native
    suffix = os.path.splitext(path)[1].lower()
    try:
        if suffix == ".png":
            return native.decode_png_rgb(path)
        if suffix not in _PNM_SUFFIXES:
            raise ValueError(f"{path}: the port's readers take PPM, PGM "
                             "and PNG images only")
        with open(path, "rb") as fp:
            img = decode_pnm(fp.read())
    except ValueError as refusal:
        img = _read_refused(path, refusal)
    return image_rgb(img)


def load_kitti_disp(path):
    """KITTI disparity PNG (uint16, value/256; 0 = invalid) -> [H, W] f32
    (a PNG of C > 1 channels: [H, W, C]), through the host library."""
    from .. import native
    return native.decode_png_disp16(path)


def save_kitti_disp(path, disp):
    """KITTI submission format: uint16 PNG of disp * 256."""
    disp = np.asarray(disp, np.float32)
    save_png(path, np.clip(disp * 256.0, 0, 65535).astype(np.uint16))


def load_disp(path):
    """Dispatch on extension: .pfm (SceneFlow) or .png (KITTI)."""
    if path.endswith(".pfm"):
        return load_pfm(path)[0]
    return load_kitti_disp(path)
