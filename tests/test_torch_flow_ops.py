"""The port's flow pieces against the JAX package's, on the CPU: the
backward warp (integer, subpixel and out-of-frame flows, and its
gradients), the local 2-D correlation (dilation 1 and 2), the 2-D
soft-argmax, .flo files both ways, the EPE / n-px metrics (dense, sparse,
NaN ground truth), the multi-scale flow loss, the colour wheel, every
flow transform on the same generator draws, and the PPM / PGM reader of
data/io.py against JAX's ``load_image`` (imageio) on files written here.

The JAX functions run eagerly (they are small), their gradients jitted
once (tests/acfnet_parity.jit_call); the inputs are made from numpy
seeds. Tolerances are stated where they are asserted.
"""

import importlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.data import io as jio
from densematchingbenchmark_tpu.flow import io as jflo
from densematchingbenchmark_tpu.flow import losses as jlosses
from densematchingbenchmark_tpu.flow import metrics as jmetrics
from densematchingbenchmark_tpu.flow import transforms as jtrans
from densematchingbenchmark_tpu.flow import vis as jvis
from densematchingbenchmark_tpu.ops import cost_volume as jcv
from densematchingbenchmark_tpu.ops import warp as jwarp

from densematchingbenchmark_tpu_torch.data import io as tio
from densematchingbenchmark_tpu_torch.flow import io as tflo
from densematchingbenchmark_tpu_torch.flow import losses as tlosses
from densematchingbenchmark_tpu_torch.flow import metrics as tmetrics
from densematchingbenchmark_tpu_torch.flow import transforms as ttrans
from densematchingbenchmark_tpu_torch.flow import vis as tvis
from densematchingbenchmark_tpu_torch.ops import cost_volume as tcv
from densematchingbenchmark_tpu_torch.ops import warp as twarp

from acfnet_parity import jit_call

# the modules (the packages export functions of the same names)
jsa = importlib.import_module("densematchingbenchmark_tpu.ops.soft_argmin")
tsa = importlib.import_module(
    "densematchingbenchmark_tpu_torch.ops.soft_argmin")

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

B, H, W, C = 2, 9, 13, 5


def feats(seed):
    return np.random.RandomState(seed).randn(B, H, W, C).astype(np.float32)


FLOWS = {
    "integer": lambda rng: rng.randint(-3, 4, (B, H, W, 2)).astype(
        np.float32),
    "subpixel": lambda rng: rng.uniform(-2.5, 2.5, (B, H, W, 2)).astype(
        np.float32),
    # most samples leave the frame on at least one axis
    "out_of_frame": lambda rng: rng.uniform(-20, 20, (B, H, W, 2)).astype(
        np.float32),
}


@pytest.mark.parametrize("kind", sorted(FLOWS))
def test_flow_warp_matches_jax(kind):
    """The warped features within 1e-6 (the same two taps a gather,
    summed in the same order). With integer flows every value is a copy:
    out[y, x] = img[y', x + u[y', x]] with y' = y + v[y, x] (the H gather
    reads the rows the W gather warped, as JAX's), zero where a sample
    leaves the frame."""
    img = feats(0)
    flow = FLOWS[kind](np.random.RandomState(1))
    got = twarp.flow_warp(torch.from_numpy(img), torch.from_numpy(flow))
    want = np.asarray(jwarp.flow_warp(jnp.asarray(img), jnp.asarray(flow)))
    assert got.shape == want.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if kind == "integer":
        u, v = flow[0, ..., 0].astype(int), flow[0, ..., 1].astype(int)
        ys, xs = np.mgrid[0:H, 0:W]
        y2 = ys + v
        row_in = (y2 >= 0) & (y2 < H)
        x2 = xs + u[np.clip(y2, 0, H - 1), xs]
        inside = row_in & (x2 >= 0) & (x2 < W)
        np.testing.assert_array_equal(
            got[0].numpy()[inside], img[0][y2[inside], x2[inside]])
        assert not got[0].numpy()[~inside].any()


def test_flow_warp_bf16_matches_jax():
    """A bfloat16 flow on bfloat16 features (PWCFlow's bf16 warp: the
    sample positions computed in bfloat16) within one bfloat16 step of
    the largest value of JAX's."""
    img = torch.from_numpy(feats(2)).bfloat16()
    flow = torch.from_numpy(FLOWS["subpixel"](np.random.RandomState(3)))
    got = twarp.flow_warp(img, flow.bfloat16())
    want = jwarp.flow_warp(jnp.asarray(img.float().numpy(), jnp.bfloat16),
                           jnp.asarray(flow.numpy(), jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_flow_warp_gradients_match_jax():
    """The gradients with respect to the features and to the flow
    (subpixel and out-of-frame samples) within 1e-5: the same piecewise
    linear weights, the gather's transpose a scatter-add in another
    order."""
    rng = np.random.RandomState(4)
    img = feats(5)
    flow = np.concatenate([FLOWS["subpixel"](rng)[:, :5],
                           FLOWS["out_of_frame"](rng)[:, 5:]], axis=1)
    cot = rng.randn(B, H, W, C).astype(np.float32)
    ti = torch.from_numpy(img).requires_grad_()
    tf = torch.from_numpy(flow).requires_grad_()
    (twarp.flow_warp(ti, tf) * torch.from_numpy(cot)).sum().backward()
    gi, gf = jit_call(jax.grad(lambda i, f: jnp.sum(
        jwarp.flow_warp(i, f) * cot), argnums=(0, 1)), jnp.asarray(img),
        jnp.asarray(flow))
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gf), atol=1e-5)
    assert np.abs(np.asarray(gf)).max() > 0.1


@pytest.mark.parametrize("radius,dilation", [(2, 1), (1, 2), (4, 1)])
def test_correlation2d_volume_matches_jax(radius, dilation):
    """[B, H, W, (2r + 1)^2], row-major (dy, dx), zero outside the frame:
    within 1e-6 of JAX's channel means (one matmul a row offset against
    a product and a mean a displacement)."""
    ref, tgt = feats(6), feats(7)
    got = tcv.correlation2d_volume(torch.from_numpy(ref),
                                   torch.from_numpy(tgt), radius, dilation)
    want = np.asarray(jcv.correlation2d_volume(
        jnp.asarray(ref), jnp.asarray(tgt), radius, dilation))
    assert got.shape == want.shape == (B, H, W, (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the top-left pixel's (-r, -r) displacement lies outside the frame
    assert got[:, 0, 0, 0].abs().max() == 0


def test_correlation2d_volume_bf16_and_gradient_match_jax():
    """bfloat16 features: within 2 bfloat16 steps of JAX's largest value
    (JAX rounds each product to bfloat16 before the mean, the matmul
    sums exact products); float32 gradients of both inputs within
    1e-6."""
    ref, tgt = feats(8), feats(9)
    got = tcv.correlation2d_volume(torch.from_numpy(ref).bfloat16(),
                                   torch.from_numpy(tgt).bfloat16(), 2)
    want = np.asarray(jcv.correlation2d_volume(
        jnp.asarray(ref, jnp.bfloat16), jnp.asarray(tgt, jnp.bfloat16),
        2).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2 * 2.0 ** -7 * np.abs(want).max())
    cot = np.random.RandomState(10).randn(B, H, W, 25).astype(np.float32)
    tr, tt = (torch.from_numpy(a).requires_grad_() for a in (ref, tgt))
    (tcv.correlation2d_volume(tr, tt, 2) * torch.from_numpy(cot)).sum(
        ).backward()
    gr, gt = jit_call(jax.grad(lambda a, b: jnp.sum(
        jcv.correlation2d_volume(a, b, 2) * cot), argnums=(0, 1)),
        jnp.asarray(ref), jnp.asarray(tgt))
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(gr), atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), atol=1e-5)


@pytest.mark.parametrize("radius,dilation,normalizer", [(2, 1, 1.0),
                                                        (4, 2, 0.5)])
def test_soft_argmax_2d_matches_jax(radius, dilation, normalizer):
    """(u, v) in float32 within 1e-5 px, from bfloat16 scores too (both
    upcast before the softmax), and u follows dx (fastest-varying):
    a window peaked at one entry returns that entry's offsets."""
    n = (2 * radius + 1) ** 2
    rng = np.random.RandomState(radius)
    scores = (rng.randn(B, H, W, n) * 4).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        s = torch.from_numpy(scores).to(dtype)
        got = tsa.soft_argmax_2d(s, radius, dilation, normalizer)
        want = np.asarray(jsa.soft_argmax_2d(
            jnp.asarray(s.float().numpy()), radius, dilation, normalizer))
        assert got.dtype == torch.float32 and got.shape == (B, H, W, 2)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    peak = np.full((1, 1, 1, n), -1e4, np.float32)
    k = 2 * radius + 2          # row 1, column 1 of the window
    peak[..., k] = 0.0
    got = tsa.soft_argmax_2d(torch.from_numpy(peak), radius, dilation)
    np.testing.assert_allclose(got.numpy().ravel(),
                               [(1 - radius) * dilation] * 2)
    with pytest.raises(ValueError, match="entries"):
        tsa.soft_argmax_2d(torch.zeros(1, 2, 2, n + 1), radius)


def test_flo_files_round_trip_both_ways(tmp_path):
    """A .flo the port writes reads back in JAX exactly, and one JAX
    writes reads back in the port; a bad magic raises."""
    flow = np.random.RandomState(11).randn(7, 10, 2).astype(np.float32)
    flow[2, 3] = np.nan
    tflo.save_flo(str(tmp_path / "a.flo"), flow)
    jflo.save_flo(str(tmp_path / "b.flo"), flow)
    assert (tmp_path / "a.flo").read_bytes() == (tmp_path / "b.flo"
                                                 ).read_bytes()
    np.testing.assert_array_equal(jflo.load_flo(str(tmp_path / "a.flo")),
                                  flow)
    np.testing.assert_array_equal(tflo.load_flo(str(tmp_path / "b.flo")),
                                  flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="magic"):
        tflo.load_flo(str(tmp_path / "bad.flo"))


def metric_inputs(seed):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(-6, 6, (2, 8, 12, 2)).astype(np.float32)
    est = (gt + rng.randn(*gt.shape) * 3).astype(np.float32)
    gt[0, :2, :3] = np.nan               # NaN-masked pixels
    gt[1, 4:, 5:, 1] = np.nan            # one channel NaN masks the pixel
    gt[0, 5:, :4] = 0.0                  # exact zero: masked when sparse
    return est, gt


@pytest.mark.parametrize("sparse", [False, True])
def test_calc_flow_error_matches_jax(sparse):
    """EPE and the 1 / 2 / 3 / 5 px shares within 1e-5 (relative) of
    JAX's, with NaN ground truth masked (and exact zeros when sparse); an
    all-NaN ground truth gives zeros on both sides."""
    est, gt = metric_inputs(12)
    got = tmetrics.calc_flow_error(torch.from_numpy(est),
                                   torch.from_numpy(gt), sparse)
    want = jmetrics.calc_flow_error(jnp.asarray(est), jnp.asarray(gt),
                                    sparse)
    assert sorted(got) == sorted(want) == ["1px", "2px", "3px", "5px", "epe"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    nan = np.full_like(gt, np.nan)
    got = tmetrics.calc_flow_error(torch.from_numpy(est),
                                   torch.from_numpy(nan), sparse)
    assert all(float(v) == 0.0 for v in got.values())


def test_flow_l1_loss_matches_jax():
    """Three levels (full, 1/2, 1/4) against a dense ground truth with NaN
    pixels (a pooled pixel with any NaN below it masked): each level's
    weighted loss within 1e-6 relative, and its gradients within 1e-6."""
    rng = np.random.RandomState(13)
    gt = rng.uniform(-6, 6, (2, 16, 24, 2)).astype(np.float32)
    gt[0, 3, 5] = np.nan
    gt[1, 8:10, :4, 0] = np.nan
    flows = [rng.randn(2, 16 // s, 24 // s, 2).astype(np.float32) * 3
             for s in (1, 2, 4)]
    weights = (1.0, 0.5, 0.25)
    tf = [torch.from_numpy(f).requires_grad_() for f in flows]
    got = tlosses.flow_l1_loss(tf, torch.from_numpy(gt), weights)
    sum(got.values()).backward()
    def losses(fs):
        ld = jlosses.flow_l1_loss(fs, jnp.asarray(gt), weights)
        return sum(ld.values()), ld
    (_, want), grads = jit_call(jax.value_and_grad(losses, has_aux=True),
                                [jnp.asarray(f) for f in flows])
    assert sorted(got) == sorted(want) == [f"flow_loss_lvl{i}"
                                           for i in range(3)]
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-6, err_msg=k)
    for t, g in zip(tf, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-6)
    with pytest.raises(ValueError, match="weights"):
        tlosses.flow_l1_loss(tf, torch.from_numpy(gt), (1.0,))


@pytest.mark.parametrize("max_flow", [None, 4.0])
def test_flow_to_color_matches_jax(max_flow):
    """The colour wheel equal to JAX's (the same numpy), NaN pixels
    black."""
    flow = np.random.RandomState(14).randn(9, 11, 2).astype(np.float32) * 3
    flow[1, 2] = np.nan
    got = tvis.flow_to_color(flow, max_flow)
    np.testing.assert_array_equal(got, jvis.flow_to_color(flow, max_flow))
    assert got.shape == (9, 11, 3) and not got[1, 2].any()


def flow_sample(seed, h=20, w=24):
    rng = np.random.RandomState(seed)
    return {"leftImage": rng.rand(h, w, 3).astype(np.float32) * 255,
            "rightImage": rng.rand(h, w, 3).astype(np.float32) * 255,
            "flow": rng.randn(h, w, 2).astype(np.float32) * 4,
            "original_size": (h, w)}


TRANSFORMS = {
    "random_crop": lambda m, s, g: m.random_crop(s, (12, 16), g),
    "random_horizontal_flip": lambda m, s, g: m.random_horizontal_flip(
        s, g, prob=1.0),
    "random_vertical_flip": lambda m, s, g: m.random_vertical_flip(
        s, g, prob=1.0),
    "scale": lambda m, s, g: m.scale(s, 0.75),
    "normalize": lambda m, s, g: m.normalize(s, (120., 110., 100.),
                                             (60., 55., 50.)),
    "pad_to": lambda m, s, g: m.pad_to(s, (24, 32)),
    "random_rotate": lambda m, s, g: m.random_rotate(s, g, 10.0, 2.0),
    "random_translate": lambda m, s, g: m.random_translate(s, g, (3, 4)),
    "center_cat": lambda m, s, g: m.center_cat(s, (25, 30)),
    "color_jitter": lambda m, s, g: m.color_jitter(s, g),
    "train": lambda m, s, g: m.make_train_transform(
        (12, 16), (120.,) * 3, (60.,) * 3, rotate=(5.0, 1.0),
        translate=2, jitter=True, flips=True)(s, g),
    "eval": lambda m, s, g: m.make_eval_transform((24, 32), (120.,) * 3,
                                                  (60.,) * 3)(s),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_flow_transform_matches_jax(name):
    """Each transform on the same sample and the same generator draws
    (np.random.default_rng(seed) on both sides): equal to JAX's output
    (NaN where JAX's is), the resize of ``scale`` within 1e-4 (torch
    against jnp arithmetic)."""
    sample = flow_sample(15)
    got = TRANSFORMS[name](ttrans, dict(sample), np.random.default_rng(3))
    want = TRANSFORMS[name](jtrans, dict(sample), np.random.default_rng(3))
    assert sorted(got) == sorted(want)
    for k in ("leftImage", "rightImage", "flow"):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-4 if name == "scale" else 0,
                                   err_msg=k)


def test_ppm_and_pgm_read_as_jax_reads_them(tmp_path):
    """Binary 8-bit PPM (P6) and PGM (P5) files, one with '#' comments
    between its header fields and one with a comment ending in CR, read
    by the port's own decoder (fault 10: the card's machine has no
    imageio) equal to JAX's ``load_image`` (imageio): float32 [H, W, 3],
    gray repeated. An ASCII PPM goes to imageio where it imports, as
    before; a truncated raster raises."""
    rng = np.random.RandomState(16)
    rgb = rng.randint(0, 256, (7, 9, 3)).astype(np.uint8)
    gray = rng.randint(0, 256, (6, 5)).astype(np.uint8)
    files = {
        "plain.ppm": tio.encode_pnm(rgb),
        "comments.ppm": (b"P6\n# a FlyingChairs-style comment\n9 # w\n7\n"
                         b"# maxval next\r255\n" + rgb.tobytes()),
        "gray.pgm": b"P5 5 6\t255\n" + gray.tobytes(),
        "gray_cr.pgm": b"P5\r# comment\r5 6\r255\r" + gray.tobytes(),
    }
    for name, data in files.items():
        path = str(tmp_path / name)
        with open(path, "wb") as fp:
            fp.write(data)
        got = tio.load_image(path)
        want = jio.load_image(path)
        assert got.dtype == np.float32 and got.shape[2] == 3, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(
            tio.decode_pnm(data), rgb if name.endswith(".ppm") else gray)
    ascii_path = str(tmp_path / "ascii.ppm")
    with open(ascii_path, "wb") as fp:
        fp.write(b"P3\n2 1\n255\n1 2 3 4 5 6\n")
    np.testing.assert_array_equal(tio.load_image(ascii_path),
                                  jio.load_image(ascii_path))
    with pytest.raises(ValueError, match="raster"):
        tio.decode_pnm(files["plain.ppm"][:-1])
    with pytest.raises(ValueError, match="maxval"):
        tio.decode_pnm(b"P6 1 1 65535\n" + b"\0" * 6)


def test_load_image_without_imageio_refuses_only_foreign_files(
        tmp_path, monkeypatch):
    """With imageio unimportable (the card's machine), a PPM still reads
    through the port's decoder and an ASCII PPM raises the decoder's
    refusal (fault 10's guard)."""
    import builtins
    real_import = builtins.__import__

    def no_imageio(name, *args, **kwargs):
        if name.startswith("imageio"):
            raise ImportError("no imageio here")
        return real_import(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_imageio)
    rgb = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    tio.save_pnm(str(tmp_path / "a.ppm"), rgb)
    np.testing.assert_array_equal(tio.load_image(str(tmp_path / "a.ppm")),
                                  rgb.astype(np.float32))
    (tmp_path / "b.ppm").write_bytes(b"P3\n1 1\n255\n1 2 3\n")
    with pytest.raises(ValueError, match="binary PGM / PPM"):
        tio.load_image(str(tmp_path / "b.ppm"))
    assert os.path.exists(str(tmp_path / "b.ppm"))
