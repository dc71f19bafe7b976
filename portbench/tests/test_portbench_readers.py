"""Each metric reader on a canned record, against numbers worked out by
hand; and the contract between BENCHMARK.json and the readers' files."""

import pytest

from portbench import harness, roofline

# a profiled part of 2.0 s: 8 frames in 2 calls, the device busy 1.5 s;
# after it 104 frames dispatched, 100 of them completed in 4.0 s
OBS = {
    "frames": 8, "calls": 2, "window_s": 2.0, "busy_s": 1.5,
    "launches": 10400,
    "kernels": [["void conv3d_wgmma_persistent::conv3d_wgmma_kernel<32>",
                 0.04, 104],
                ["cudnn_bn_fw_inf", 0.3, 500],
                ["Memcpy HtoD (Pinned -> Device)", 0.01, 16]],
    "conv_ops": [["aten::convolution", [[1, 1, 96, 312, 48],
                                        [1, 1, 8, 8, 8], []], 0.6],
                 ["aten::convolution", [[1, 32, 96, 312],
                                        [32, 32, 3, 3], []], 0.2]],
    "cost_processor_s": 0.4, "cost_processor_calls": 2,
    "trunk_calls": [(4 * 48 * 96 * 312, 32, 32)] * 2,
    "trunk_kernel": roofline.TRUNK_KERNEL,
    "spans": {"sample_load": [0.030, 0.050]},
    "idle_gaps": [],
    "flops_per_frame": 1.0e12,
    "after_frames": 104, "after_done_frames": 100, "after_s": 4.0,
}


def read(name):
    return harness.reader("layer_metrics", name)(OBS)


def test_per_layer_readers_by_hand():
    assert read("sample_load_ms.eval") == pytest.approx(40.0)
    for sfx in ("eval", "infer"):
        assert read(f"launches_per_frame.{sfx}") == 1300
        assert read(f"cost_processor_ms.{sfx}") == pytest.approx(
            400.0 / 104)
        assert read(f"device_idle_pct.{sfx}") == pytest.approx(25.0)
        # 100 frames of 1e12 FLOPs in 4 s: 2.5e13 FLOP/s of 989e12
        assert read(f"mfu.{sfx}") == pytest.approx(2.5e13 / 989e12 * 100)
        bound = 2 * roofline.trunk_call_bound_s(4 * 48 * 96 * 312, 32, 32)
        assert read(f"trunk_roofline.{sfx}") == pytest.approx(
            bound / 0.04 * 100)
    assert read("host_gap_ms.infer") == pytest.approx(250.0)
    assert read("learned_upsample_ms.infer") == pytest.approx(75.0)


def test_readers_give_nothing_where_nothing_ran():
    empty = dict(OBS, kernels=[], conv_ops=[], spans={}, trunk_calls=[],
                 cost_processor_calls=0, launches=0)
    for name in ("sample_load_ms.eval", "launches_per_frame.eval",
                 "cost_processor_ms.eval", "trunk_roofline.eval",
                 "learned_upsample_ms.infer"):
        assert harness.reader("layer_metrics", name)(empty) is None


def test_end_to_end_readers_by_hand():
    record = {"frames": 90, "elapsed_s": 30.0, "setup_s": 12.5,
              "memory_peak_bytes": 3 * 2 ** 30,
              "latencies_s": [i / 1000 for i in range(1, 101)]}
    e2e = {n: harness.reader("end_to_end", n)(record) for n in (
        "frames_per_s", "latency_p95_ms", "peak_mem_gib", "setup_s")}
    assert e2e["frames_per_s"] == pytest.approx(3.0)
    assert e2e["latency_p95_ms"] == pytest.approx(95.05)
    assert e2e["peak_mem_gib"] == pytest.approx(3.0)
    assert e2e["setup_s"] == 12.5
    assert harness.reader("end_to_end", "latency_p95_ms")(
        dict(record, latencies_s=None)) is None


def test_every_metric_and_cell_has_its_files():
    bench = harness.spec()
    for m in bench["end_to_end"]:
        harness.reader("end_to_end", m["name"])
    for m in bench["per_layer"]:
        harness.reader("layer_metrics", m["name"])
    for c in bench["workloads"]:
        cell, config, traffic, limits = harness.cell_files(bench, c["name"])
        harness.driver(traffic["driver"])
        assert limits and config["dtype"] == "bfloat16"
        e2e = {m["name"] for m in harness.cell_metrics(bench, c["name"],
                                                       "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(bench, c["name"], "per_layer")
