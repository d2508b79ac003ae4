"""The benchmark's own files and arithmetic, on the CPU."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

from bench import harness, traffic, yardstick
from bench.reference import cnn as cnn_ref

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = [m for m in BENCH["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(workload):
    cell = harness.Cell(workload)
    entry = cell.config_entry
    assert entry["file"].startswith("bench/configs/")
    assert cell.config["name"] == entry["name"]
    assert cell.config["source"] == entry["source"]
    assert cell.config["reduced"] == entry["reduced"] == []
    assert cell.traffic["kind"] in ("closed_batches", "closed_requests")
    assert hasattr(cell.driver(), "System")
    readers = cell.readers()
    assert set(readers) == {m["name"] for m in cell.per_layer}
    spans = harness.Spans([s for r in readers.values()
                           for s in getattr(r, "SPANS", ())])
    spans.install()        # every span names a function the program has
    spans.remove()


def test_forbidden_modules_compare_whole_top_level_names():
    caught = ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "repro",
              "repro.core.pim"]
    kept = ["repro_torch", "repro_torch.core.pim", "jaxtyping", "reprox",
            "flaxen"]
    assert harness.forbidden_modules(caught + kept) == sorted(caught)
    assert harness.forbidden_modules(kept) == []


def test_bound_by_hand():
    # (1, 128, 512) x (1, 512, 256) int8 planes, a float32 output
    secs, kind = yardstick.bound(1, 1, 128, 512, 256, 4, 0)
    moved = 128 * 512 + 512 * 256 + 4 * 128 * 256
    assert kind == "bytes"
    assert secs == pytest.approx(moved / 3.35e12, rel=1e-12)
    secs, kind = yardstick.bound(1, 1, 8192, 8192, 8192, 4, 0)
    assert kind == "operations"
    assert secs == pytest.approx(2 * 8192 ** 3 / 1.979e15, rel=1e-12)
    least = yardstick.fused_launch_bound((1, 128, 512), (1, 512, 256), True)
    extra = 4 * 128 + 4 * 256 + 4 * 256
    assert least == pytest.approx((moved + extra) / 3.35e12, rel=1e-12)


def test_tails_spreads_and_busy_time_by_hand():
    assert yardstick.percentile(list(range(1, 11)), 90) == pytest.approx(9.1)
    assert yardstick.percentile([5.0], 95) == 5.0
    assert yardstick.spread([1, 2, 3, 4, 5]) == pytest.approx(1.0)
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert yardstick.busy_time(spans) == pytest.approx(3.0)
    assert yardstick.idle_gaps(spans) == [(2.0, 3.0)]


def test_mfu_by_hand():
    mfu = harness.load_reader("cnn.mfu")
    # 1000 images in 2 s outside a 0.5 s profiled stretch
    host = yardstick.HostWindow(10.0, 12.5, (11.0, 11.5))
    w = {"host_images": 1000, "host": host, "macs_per_image": 555468800}
    want = 100 * 2 * 555468800 * 500 / 1.979e15
    assert mfu.read({"window": w}) == pytest.approx(want, rel=1e-12)
    m = dict(hidden_size=4, num_attention_heads=2, num_key_value_heads=1,
             head_dim=2, intermediate_size=8, num_hidden_layers=3,
             vocab_size=10)
    proj = 2 * 3 * (4 * 4 + 2 * 4 * 2 + 4 * 4 + 3 * 4 * 8)
    assert yardstick.lm_projection_ops(m) == proj
    # a 3-token prompt: keys 1 + 2 + 3, one row of logits
    want = 3 * proj + 4 * 2 * 2 * 3 * 6 + 2 * 4 * 10
    assert yardstick.lm_prefill_ops(m, 3) == want
    assert yardstick.lm_decode_ops(m, 4) == proj + 4 * 2 * 2 * 3 * 5 + 80
    lm_mfu = harness.load_reader("lm.mfu")
    assert lm_mfu.read({"window": {"ops": 1.979e13, "host": host}}) == \
        pytest.approx(0.5)


def test_host_window_leaves_the_profiled_stretch_out():
    host = yardstick.HostWindow(10.0, 20.0, (12.0, float("inf")))
    assert host.seconds == pytest.approx(2.0)
    assert host.holds(11.0) and not host.holds(13.0)
    assert not host.holds(9.0) and not host.holds(21.0)
    plain = yardstick.HostWindow(10.0, 20.0)
    assert plain.seconds == 10.0 and plain.holds(15.0)


def test_resnet18_count_against_its_shapes():
    cell = harness.Cell("resnet18.b128")
    table = cnn_ref.layer_table(cell.config["model"])
    macs = yardstick.cnn_macs(table)
    assert macs == cell.config["model"]["macs_per_image"] == 555_468_800
    assert yardstick.cnn_weights(table) == 11_210_432
    from repro_torch.core.workloads import resnet18, total_macs
    assert total_macs(resnet18(100, 32)) == macs
    by_hand = 32 * 32 * 64 * 27 + 4 * 32 * 32 * 64 * 576
    by_hand += 16 * 16 * 128 * (576 + 3 * 1152) + 16 * 16 * 128 * 64
    by_hand += 8 * 8 * 256 * (1152 + 3 * 2304) + 8 * 8 * 256 * 128
    by_hand += 4 * 4 * 512 * (2304 + 3 * 4608) + 4 * 4 * 512 * 256
    assert macs == by_hand + 512 * 100


def test_traffic_gives_every_seed_the_same_work():
    t = harness.Cell("qwen3-4b.doc4k").traffic
    a = traffic.lm_requests(t, 151936, 1)
    b = traffic.lm_requests(t, 151936, 2 ** 31 + 5)
    assert len(a) == len(b) == t["backlog"]
    block = t["block"]
    for i in range(0, len(a) - block + 1, block):
        sizes = lambda r: sorted((len(p), g) for p, g in r[i:i + block])
        assert [s[0] for s in sizes(a)] == [s[0] for s in sizes(b)]
        assert sorted(g for _, g in a[i:i + block]) == \
            sorted(g for _, g in b[i:i + block])
    assert [len(p) for p, _ in a] != [len(p) for p, _ in b]
    assert all(0 <= p.min() and p.max() < 151936 for p, _ in a)
    assert min(len(p) for p, _ in a) >= t["prompt"]["lo"]
    assert max(len(p) for p, _ in a) <= t["prompt_pad"]


def test_b1_launches_match_recorded_shapes():
    from bench import b1

    class Trace:
        calls = {"bench.b1": [([(1, 256, 512), (1, 512, 256), None, None],
                               {"bias": (1, 256)}),
                              ([(1, 8, 512), (1, 512, 256), None, None], {})]}
        device = [("pim_matmul_wgmma_kernel<1, 1>", 0.0, 2e-6),
                  ("pim_matmul_small_m_kernel<1, 1>", 3e-6, 4e-6)]

        def kernels(self, frags):
            return [d for d in self.device if any(f in d[0] for f in frags)]

    routes = b1.by_route(Trace())
    assert set(routes) == {"wgmma", "small_m"}
    assert routes["wgmma"][1] == pytest.approx(2e-6)
    assert routes["wgmma"][0] == pytest.approx(
        yardstick.fused_launch_bound((1, 256, 512), (1, 512, 256), True))
    Trace.device = Trace.device[:1]
    assert b1.by_route(Trace()) is None       # one launch not matched


def test_readers_leave_out_what_they_cannot_read():
    host = yardstick.HostWindow(0.0, 1.0)
    empty = {"window": {"images": 0, "host_images": 0, "ops": 0,
                        "host": host, "decoded": 0, "sends": [],
                        "prefills": 0, "prompt_pad": 64,
                        "prompt_tokens": 0, "seconds": 1.0, "slots": 8},
             "trace": None, "times": {}}
    for m in BENCH["per_layer"]:
        assert harness.load_reader(m["name"]).read(empty) is None, m["name"]


def test_last_line_keys(tiny_cell):
    cell = tiny_cell("resnet18.b128")
    res = harness.run(cell, 2 ** 31 + 99, 1.0, False, device="cpu",
                      log=lambda *a: None)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cmd = [sys.executable, "bench/run.py", "--workload", "resnet18.b128",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode != 0 and done.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    done = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode != 0 and done.stdout == ""
