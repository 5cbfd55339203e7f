"""Cells, configurations, traffic mixes and metrics are found by name:
adding one takes new files and new BENCHMARK.json entries, no edit of a
file that is there.  And BENCHMARK.json keeps to the shape it is checked
against."""

import json
import os
import re
import shutil

import pytest
import torch

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/") and len(c["source"]) <= 200
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = harness.load_cell(w["name"])
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer",
                                                "moves", "workloads"}


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_named_file_is_there(cell):
    c = harness.load_cell(cell)
    c.module("loops", c.traffic["loop"])
    c.module("data", c.config["data"]["generator"])
    c.reference()
    for m in c.end_to_end:
        assert callable(c.module("end_to_end", m["name"]).read)
    for m in c.per_layer:
        assert callable(c.module("metrics", m["name"]).read)


def test_a_new_config_cell_and_metric_are_found_without_an_edit(tmp_path):
    """A throwaway configuration, traffic mix, cell and per-layer metric,
    added as files and entries in a copy of the benchmark, are found and
    run (on the CPU, at a small size) with no file of the copy edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    b = _bench()
    cfg = json.loads((root / "benchmark/configs/ramp-f32-lz4.json").read_text())
    cfg.update(name="tiny-i16-zstd", dtype="int16",
               options={**cfg["options"], "codec": "ZSTD", "type_size": 2},
               reference={"module": "blosc_frame", "codec": "zstd", "codec_id": 5})
    (root / "benchmark/configs/tiny-i16-zstd.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "benchmark/traffic/roundtrip.1mib.json").read_text())
    traffic.update(tensor_bytes=6 << 20, check_sample=2, traced_round_trips=2)
    (root / "benchmark/traffic/roundtrip.6mib.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/spans_seen.py").write_text(
        "def read(trace, ctx):\n    return float(len(trace.spans))\n")
    b["configs"].append({"name": "tiny-i16-zstd", "source": "a test",
                         "file": "benchmark/configs/tiny-i16-zstd.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "tiny-i16-zstd.6mib", "config": "tiny-i16-zstd",
                           "traffic": "roundtrip.6mib", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "spans_seen", "unit": "spans", "better": "higher",
                           "source": "device_trace", "layer": "device",
                           "moves": "tensor_gbps", "workloads": ["tiny-i16-zstd.6mib"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = harness.load_cell("tiny-i16-zstd.6mib", str(root))
    assert cell.config["name"] == "tiny-i16-zstd" and cell.traffic["tensor_bytes"] == 6 << 20
    assert [m["name"] for m in cell.per_layer] == ["spans_seen"]
    assert [m["name"] for m in cell.end_to_end] == ["tensor_gbps", "setup_s"]
    out = harness.execute(cell, 2**31 + 7, 0.2, True, torch.device("cpu"), 0.0)
    assert out["correct"] and out["metrics"]["spans_seen"]["value"] == 4.0
    out = harness.execute(cell, 2**31 + 8, 0.2, False, torch.device("cpu"), 0.0)
    assert out["correct"] and set(out["metrics"]) == {"tensor_gbps", "setup_s"}
    assert all(p.read_bytes() == data for p, data in before.items())


@pytest.mark.parametrize("ms, p95", [([4.0, 1.0, 3.0, 2.0, 5.0], 4.8),
                                     ([2.0] * 19 + [12.0], 2.5),
                                     ([2.0] * 18 + [12.0] * 2, 12.0)])
def test_the_p95_readers_take_every_call(ms, p95):
    """A 95th percentile over every call of the window, in ms: the
    inclusive quantile, so 20 calls with one slow call read between the
    slow call and the rest, and two slow calls read the slow time."""
    cell = harness.load_cell("ramp-f32-lz4.1mib")
    for op in ("encode", "decode"):
        ops = {"encode": [1e-3], "decode": [1e-3]}
        ops[op] = [t / 1e3 for t in ms]
        read = cell.module("end_to_end", f"{op}_p95_ms").read
        assert read({"ops": ops}) == pytest.approx(p95)
        assert read({"ops": {"encode": [], "decode": []}}) is None


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no-such-cell")
