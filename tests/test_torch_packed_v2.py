"""K5, K4's bfloat16 route, dpack_kernel and the packed-conv microbench of
the port against the JAX package, on the CPU.

On the CPU the wrappers run ``conv3d_packed_s1_plain``, held here against
the Pallas kernels in interpret mode (as tests/ops/
test_packed_conv3d_pallas.py runs them) on the same numpy-seeded inputs.
Both sides sum in float32 from the same operands: in float32 they differ
in the order of their sums; in bfloat16 (operands and kernel rounded to
bfloat16 once, float32 sums and epilogue) the float32 results round to the
output type once, so they may differ by one bfloat16 step, 2^-7 of the
largest output. Every JAX result is computed once, in one module-scoped
fixture. The kernels themselves are held against the plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.ops import conv3d as jconv3d
from densematchingbenchmark_tpu.ops.pallas.packed_conv3d_kernel import (
    conv3d_packed_s1_pallas, conv3d_packed_s1_pallas_v2)

from densematchingbenchmark_tpu_torch.ops import conv3d as tconv3d
from densematchingbenchmark_tpu_torch.ops import cuda as kernels
from densematchingbenchmark_tpu_torch.tools import microbench_packed

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)

# JAX's own v2 cases (tests/ops/test_packed_conv3d_pallas.py:83-86):
# (pack, Ci, Co, (B, D, H, W))
CASES = [(4, 5, 7, (1, 8, 8, 6)), (2, 6, 4, (2, 8, 16, 5))]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_STEP = 2.0 ** -7


def case_inputs(pack, ci, co, shape, dtype):
    """Packed xp (rounded to ``dtype``), a float32 kernel and a [Co] scale
    and bias, as numpy float32 arrays, from JAX's test seed."""
    b, d, h, w = shape
    rng = np.random.RandomState(3)
    x = (rng.randn(b, d, h, w, ci) * 0.5).astype(np.float32)
    k = (rng.randn(3, 3, 3, ci, co) * 0.2).astype(np.float32)
    scale = (rng.rand(co) + 0.5).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    xp = tconv3d.pack_volume(torch.from_numpy(x), pack).to(dtype)
    return xp.float().numpy(), k, scale, bias


@pytest.fixture(scope="module")
def jax_results():
    """Every JAX reference of this file, computed once: v2 at both cases in
    both dtypes and v1 at the first case in bfloat16, each with a [Co]
    scale, bias and ReLU. The v1 reference of the second case is its v2
    one: in bfloat16 the two kernels agree bit for bit (see
    test_pallas_v1_and_v2_agree_in_bfloat16), and each interpret-mode call
    costs seconds."""
    out = {}
    runs = [("v2", conv3d_packed_s1_pallas_v2, case, dt) for case in CASES
            for dt in DTYPES]
    runs.append(("v1", conv3d_packed_s1_pallas, CASES[0], "bfloat16"))
    for label, fn, (pack, ci, co, shape), dt in runs:
        xp, k, scale, bias = case_inputs(pack, ci, co, shape, DTYPES[dt])
        y = fn(jnp.asarray(xp, jnp.dtype(dt)), jnp.asarray(k),
               jnp.asarray(scale), jnp.asarray(bias), pack=pack, relu=True,
               h_tile=4, interpret=True)
        assert y.dtype == jnp.dtype(dt)
        out[label, pack, dt] = np.asarray(y.astype(jnp.float32))
    return out


def check(got, want, dtype):
    assert got.dtype == DTYPES[dtype] and got.shape == want.shape
    got = got.float().numpy()
    if dtype == "float32":
        # 27 * Ci products summed in another order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_STEP * np.abs(want).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pack,ci,co,shape", CASES)
def test_packed_v2_matches_pallas_v2(jax_results, pack, ci, co, shape,
                                     dtype):
    xp, k, scale, bias = case_inputs(pack, ci, co, shape, DTYPES[dtype])
    before = kernels.conv3d_packed_s1_v2.launches
    got = kernels.conv3d_packed_s1_v2(
        torch.from_numpy(xp).to(DTYPES[dtype]), torch.from_numpy(k),
        torch.from_numpy(scale), torch.from_numpy(bias), pack=pack,
        relu=True)
    assert kernels.conv3d_packed_s1_v2.launches == before   # CPU: plain
    check(got, jax_results["v2", pack, dtype], dtype)


@pytest.mark.parametrize("pack,ci,co,shape", CASES)
def test_packed_bf16_matches_pallas(jax_results, pack, ci, co, shape):
    xp, k, scale, bias = case_inputs(pack, ci, co, shape, torch.bfloat16)
    before = kernels.conv3d_packed_s1.launches
    got = kernels.conv3d_packed_s1(
        torch.from_numpy(xp).bfloat16(), torch.from_numpy(k),
        torch.from_numpy(scale), torch.from_numpy(bias), pack=pack,
        relu=True)
    assert kernels.conv3d_packed_s1.launches == before
    want = jax_results.get(("v1", pack, "bfloat16"),
                           jax_results["v2", pack, "bfloat16"])
    check(got, want, "bfloat16")


def test_pallas_v1_and_v2_agree_in_bfloat16(jax_results):
    # the JAX kernels give the same bfloat16 result from the same operands,
    # so JAX's v2 stands in for v1 as K4's reference at the second case
    pack = CASES[0][0]
    np.testing.assert_array_equal(jax_results["v1", pack, "bfloat16"],
                                  jax_results["v2", pack, "bfloat16"])


def test_packed_bf16_rounds_the_float32_result_once():
    # the plain version's bfloat16 result is its float32 result on the
    # same (rounded) operands, rounded once
    xp, k, scale, bias = case_inputs(4, 4, 8, (1, 8, 5, 6), torch.bfloat16)
    k16 = torch.from_numpy(k).bfloat16()
    args = (torch.from_numpy(scale), torch.from_numpy(bias))
    got = kernels.conv3d_packed_s1_plain(torch.from_numpy(xp).bfloat16(),
                                         torch.from_numpy(k), *args, 4, True)
    want = kernels.conv3d_packed_s1_plain(torch.from_numpy(xp), k16.float(),
                                          *args, 4, True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("pack", [1, 2, 4])
def test_dpack_kernel_matches_jax(pack):
    k = np.random.RandomState(pack).randn(3, 3, 3, 5, 7).astype(np.float32)
    np.testing.assert_array_equal(
        tconv3d.dpack_kernel(torch.from_numpy(k), pack).numpy(),
        np.asarray(jconv3d.dpack_kernel(jnp.asarray(k), pack)))


@pytest.mark.parametrize("pack", [2, 4])
def test_dense_packed_conv_is_the_true_conv(pack):
    # F.conv3d of a packed volume with dpack_kernel == the unpacked conv,
    # packed: the microbench's dense-packed row computes the true function
    rng = np.random.RandomState(10 + pack)
    x = torch.from_numpy(rng.randn(2, 8, 5, 6, 3).astype(np.float32))
    k = torch.from_numpy(rng.randn(3, 3, 3, 3, 5).astype(np.float32))
    xp = tconv3d.pack_volume(x, pack)
    got = microbench_packed.library_conv(
        xp, tconv3d.dpack_kernel(k, pack).permute(4, 3, 0, 1, 2))
    want = tconv3d.pack_volume(microbench_packed.library_conv(
        x, k.permute(4, 3, 0, 1, 2)), pack)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # and JAX's dense packed conv (XLA, the JAX tool's baseline)
    jax_y = np.array(jconv3d.conv3d_dpack(
        jnp.asarray(x.numpy()), jnp.asarray(k.numpy()), pack=pack))
    np.testing.assert_allclose(
        got.numpy(), tconv3d.pack_volume(torch.from_numpy(jax_y), pack),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("operand", ["xp", "kernel", "scale", "bias"])
def test_packed_v2_is_forward_only(operand):
    xp, k, scale, bias = (torch.from_numpy(a) for a in case_inputs(
        2, 4, 4, (1, 4, 3, 5), torch.float32))
    args = {"xp": xp, "kernel": k, "scale": scale, "bias": bias}
    args[operand].requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        kernels.conv3d_packed_s1_v2(pack=2, **args)
    with torch.no_grad():
        out = kernels.conv3d_packed_s1_v2(pack=2, **args)
    torch.testing.assert_close(
        out, kernels.conv3d_packed_s1(pack=2, **args).detach(), rtol=0,
        atol=0)


def test_packed_v2_rejects_bad_epilogue_and_device():
    x = torch.zeros(1, 1, 2, 2, 8)
    k = torch.zeros(3, 3, 3, 4, 4)
    with pytest.raises(ValueError, match="epilogue"):
        kernels.conv3d_packed_s1_v2(x, k, scale=torch.ones(3), pack=2)
    with pytest.raises(ValueError, match="device"):
        kernels.conv3d_packed_s1_v2(x.to("meta"), k.to("meta"), pack=2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_microbench_runs_on_cpu(dtype):
    kernels.reset_launch_counts()
    rows = microbench_packed.run(cases=(("tiny", (1, 8, 4, 6), 8, 4),),
                                 dtype=DTYPES[dtype], pack=4, iters=2,
                                 device="cpu")
    assert [r["row"] for r in rows] == list(microbench_packed.ROWS)
    for r in rows:
        assert r["case"] == "tiny" and r["dtype"] == dtype
        assert r["device"] == "cpu" and r["pack"] == 4
        assert np.isfinite(r["ms"]) and r["ms"] > 0 and r["tflops"] > 0
    assert rows[0]["vs_dense"] == 1.0
    assert set(kernels.launch_counts().values()) == {0}   # plain versions


def test_microbench_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench_packed.run(iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench_packed.run(iters=1, device="cuda")


def test_rechain_projects_channels_as_jax():
    y = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    want = jnp.concatenate([jnp.asarray(y.numpy())] * 2, -1)[..., :12]
    np.testing.assert_array_equal(microbench_packed.rechain(y, 12).numpy(),
                                  np.asarray(want))
    assert microbench_packed.rechain(y, 8) is y
