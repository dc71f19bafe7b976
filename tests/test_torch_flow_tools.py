"""The flow task's tools, configs and datasets in the port, on the CPU:
``tools.test`` scoring a synthetic set as JAX's ``evaluate_flow`` scores
it (at the tiny PWCFlow of tests/flow_parity.py, on shared randomized
weights), ``tools.train`` and ``tools.demo`` on both families, the six
flow config names against JAX's and through the builder, and
``build_dataset``'s FlyingChairs (PPM frames, .flo GT) and SyntheticFlow
against JAX's.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from densematchingbenchmark_tpu.configs import get_config as jget_config
from densematchingbenchmark_tpu.data.datasets import (
    build_dataset as jbuild_dataset)
from densematchingbenchmark_tpu.flow import metrics as jmetrics
from densematchingbenchmark_tpu.flow import transforms as jtrans
from densematchingbenchmark_tpu.flow.datasets import (
    SyntheticFlowDataset as JSyntheticFlow)
from densematchingbenchmark_tpu.flow.models import (
    build_flow_model as jbuild_flow)
from densematchingbenchmark_tpu.flow.trainer import (
    evaluate_flow as jevaluate_flow)

from densematchingbenchmark_tpu_torch.configs import get_config
from densematchingbenchmark_tpu_torch.data import build_dataset, io as tio
from densematchingbenchmark_tpu_torch.flow import PWCFlow, RAFTFlow
from densematchingbenchmark_tpu_torch.flow import io as tflo
from densematchingbenchmark_tpu_torch.models import build_model
from densematchingbenchmark_tpu_torch.tools import demo as tdemo
from densematchingbenchmark_tpu_torch.tools import test as ttest
from densematchingbenchmark_tpu_torch.tools import train as ttrain
from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics
from densematchingbenchmark_tpu_torch.utils import load_jax_variables
from densematchingbenchmark_tpu_torch.utils.checkpoint import (
    CheckpointManager)

from flow_parity import OVERRIDES, PWC, RAFT, configs, shared_weights
from test_torch_flow import write_flow_pairs

# one torch intra-op thread a test worker (tests/test_torch_stereonet.py)
torch.set_num_threads(1)

NAMES = [f"{family}{suffix}" for family in (PWC, RAFT)
         for suffix in ("", "_f32", "_bf16")]


@pytest.fixture(scope="module")
def weights():
    return shared_weights(PWC)[1]


def test_tools_test_scores_a_synthetic_set_as_jax(weights, tmp_path):
    """``tools.test --synthetic`` on the tiny config (four SyntheticFlow
    pairs at data.crop_size 32x64, the weights restored from a
    checkpoint in --work-dir) against JAX's ``evaluate_flow`` over the
    same dataset (the same numpy draws): EPE within 1e-3 px, each n-px
    share within 0.1 points (two of the 2,048 pixels a sample crossing a
    threshold); --out-dir writes each sample's .flo and colour wheel."""
    jcfg, cfg = configs(PWC)
    module = build_model(cfg)
    load_jax_variables(module, weights)
    work = str(tmp_path / "work")
    CheckpointManager(work).save(1, {"module": module.state_dict()})
    over = [f"{k}={v!r}" for k, v in OVERRIDES[PWC].items()]
    results, n = ttest.main(
        ["--cpu", "--config", PWC + "_f32", "--work-dir", work, "--synthetic",
         "--out-dir", str(tmp_path / "out"), "--override",
         "data.crop_size=(32, 64)", *over])
    mean, std = cfg["data"]["mean"], cfg["data"]["std"]
    ds = JSyntheticFlow(length=4, height=32, width=64,
                        transform=jtrans.make_eval_transform((32, 64), mean,
                                                             std))
    jmodel = jbuild_flow(jcfg)
    step = jax.jit(lambda v, batch: jmetrics.calc_flow_error(
        jmodel.apply(v, batch["leftImage"], batch["rightImage"],
                     train=False)["flows"][0], batch["flow"]))
    want, jn = jevaluate_flow(jmodel, jax.tree.map(jnp.asarray, weights), ds,
                              step=step)
    assert n == jn == 4
    assert sorted(results) == sorted(want) == ["1px", "2px", "3px", "5px",
                                               "epe"]
    np.testing.assert_allclose(results["epe"], want["epe"], atol=1e-3)
    for k in ("1px", "2px", "3px", "5px"):
        np.testing.assert_allclose(results[k], want[k], atol=0.1, err_msg=k)
    flo = tflo.load_flo(str(tmp_path / "out" / "flow_0" / "000003.flo"))
    assert flo.shape == (32, 64, 2) and np.isfinite(flo).all()
    assert tio.load_image(str(tmp_path / "out" / "color_flow" /
                              "000003.png")).shape == (32, 64, 3)


@pytest.mark.parametrize("family", [PWC, RAFT])
def test_tools_train_and_demo_run_flow_on_the_cpu(family, tmp_path):
    """``tools.train --synthetic`` trains the tiny model for 3 steps at
    batch 2 on 4 synthetic pairs at 64x64 (the per-epoch eval on 2
    pairs, the vis hook's colour wheels, a checkpoint), and ``--resume``
    continues from the checkpoint's step; ``tools.demo`` writes a .flo
    and a colour PNG per PPM pair at the shipped width."""
    work = str(tmp_path / "work")
    over = [f"{k}={v!r}" for k, v in OVERRIDES[family].items()]
    argv = ["--cpu", "--config", family + "_f32", "--work-dir", work,
            "--synthetic", "--synthetic-length", "4", "--log-interval", "1",
            "--override", "data.crop_size=(64, 64)",
            "data.batch_size_per_device=2", *over]
    state = ttrain.main(argv + ["--max-steps", "3"])
    assert state.step == 3
    records = read_metrics(work)
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 3 and all(np.isfinite(losses))
    evals = [r for r in records if "eval/epe" in r]
    assert len(evals) == 2 and all(np.isfinite(r["eval/epe"]) for r in evals)
    assert sorted(os.listdir(os.path.join(work, "vis", "sample_001"))) == [
        f"flow_{k}_{e}.png" for k in ("0", "gt") for e in (1, 2)]
    state = ttrain.main(argv + ["--max-steps", "4", "--resume"])
    assert state.step == 4
    data = str(tmp_path / "pairs")
    write_flow_pairs(data, n=2, size=(40, 56))
    tdemo.main(["--cpu", "--config", family + "_f32", "--data-dir", data,
                "--out-dir", str(tmp_path / "demo")])
    for name in ("0", "1"):
        flo = tflo.load_flo(str(tmp_path / "demo" / "flow_0" / f"{name}.flo"))
        assert flo.shape == (40, 56, 2) and np.isfinite(flo).all()
        assert os.path.exists(str(tmp_path / "demo" / "color_flow" /
                                  f"{name}.png"))


@pytest.mark.parametrize("name", NAMES)
def test_flow_configs_match_jax_and_build(name):
    """The six flow names give JAX's config dicts (the suffix-less names
    float32 on the CPU, as JAX's here) and build through ``build_model``
    to PWCFlow or RAFTFlow in the config's dtype."""
    cfg = get_config(name)
    assert cfg == jget_config(name)
    assert cfg["task"] == "flow"
    module = build_model(cfg)
    assert isinstance(module, PWCFlow if name.startswith("PWC")
                      else RAFTFlow)
    assert module.dtype == (torch.bfloat16 if name.endswith("_bf16")
                            else torch.float32)


def test_flow_datasets_build_as_jax(tmp_path):
    """``build_dataset`` reads a FlyingChairs annotation (PPM frames, .flo
    GT; 'flow_map_path' and the reference's 'flow_path' spellings) and
    builds SyntheticFlow from its split's keys, each sample equal to
    JAX's; FlyingChairs without an annfile raises JAX's KeyError."""
    pairs = write_flow_pairs(str(tmp_path), n=2, size=(12, 16))
    flow = np.random.RandomState(4).randn(12, 16, 2).astype(np.float32)
    tflo.save_flo(str(tmp_path / "f.flo"), flow)
    items = [{"left_image_path": f"left/{i}.ppm",
              "right_image_path": f"right/{i}.ppm",
              key: "f.flo"} for i, key in enumerate(("flow_map_path",
                                                     "flow_path"))]
    with open(tmp_path / "ann.json", "w") as fp:
        json.dump(items, fp)
    data_cfg = {"type": "FlyingChairs", "data_root": str(tmp_path),
                "train": {"annfile": str(tmp_path / "ann.json")}}
    ds, jds = build_dataset(data_cfg, "train"), jbuild_dataset(data_cfg,
                                                               "train")
    assert ds.name == "FlyingChairs" and len(ds) == len(jds) == 2
    for i in range(2):
        got, want = ds[i], jds[i]
        assert sorted(got) == sorted(want)
        for k in ("leftImage", "rightImage", "flow"):
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["leftImage"], pairs[i][0])
    syn = {"type": "SyntheticFlow",
           "eval": {"length": 3, "height": 16, "width": 24, "max_flow": 4,
                    "seed": 2}}
    ds, jds = build_dataset(syn, "eval"), jbuild_dataset(syn, "eval")
    assert len(ds) == len(jds) == 3
    for k in ("leftImage", "rightImage", "flow"):
        np.testing.assert_array_equal(ds[2][k], jds[2][k])
    for build in (build_dataset, jbuild_dataset):
        with pytest.raises(KeyError):
            build({"type": "FlyingChairs", "train": {}}, "train")
