"""The restore cell (``gpt2-medium-bf16.restore``): its loop's record, the
readers of its three per-layer metrics, and the check that decides
``correct``.

On the CPU the cell runs at a small GPT-2 shape (2 layers, n_embd 64,
vocabulary 512) through the rest of a run as ``run.py`` makes it, without
its look for a card; the card tests run the command itself at the
published sizes."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness, trace

CELL = "gpt2-medium-bf16.restore"
SMALL = {"n_layer": 2, "n_embd": 64, "n_positions": 64, "vocab_size": 512}
CPU = torch.device("cpu")
METRICS = ["restore_wait_ms", "restore_h2d_ms", "restore_self_ms"]


def _cell():
    cell = harness.load_cell(CELL)
    cell.config["data"].update(SMALL)
    gen = cell.module("data", cell.config["data"]["generator"])
    cell.traffic["tensor_bytes"] = gen.state_bytes(cell.config["data"], torch.bfloat16)
    cell.config["reference"]["sample_bytes"] = 40_000
    return cell


def _loop_module():
    return harness.load_cell(CELL).module("loops", "restore")


def _run(seed, trace_=False, ctrl=()):
    return harness.execute(_cell(), seed, 0.2, trace_, CPU, 0.0, ctrl)


def test_the_cell_reports_tensor_gbps_and_setup_s_and_its_three_metrics():
    cell = harness.load_cell(CELL)
    assert [m["name"] for m in cell.end_to_end] == ["tensor_gbps", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == METRICS
    assert cell.traffic["tensor_bytes"] == 709_646_352 and cell.chips == 1


def test_the_window_keeps_the_record_tensor_gbps_reads():
    out = _run(2**31 + 3)
    rec = out["record"]
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert rec["round_trips"] == len(rec["ops"]["decode"]) > 0 and rec["ops"]["encode"] == []
    assert rec["tensor_bytes"] == _cell().traffic["tensor_bytes"] and rec["window_s"] >= 0.2
    assert set(out["metrics"]) == {"tensor_gbps", "setup_s"}
    assert out["metrics"]["tensor_gbps"]["value"] == pytest.approx(
        rec["round_trips"] * rec["tensor_bytes"] / rec["window_s"] / 1e9)
    assert out["frame_bytes"] > 0 and out["judged"]["frames_read"] > 2


@pytest.mark.parametrize("seed", [5, 2**31 + 5])
def test_sound_runs_are_correct(seed):
    out = _run(seed)
    assert out["correct"] and all(v == 0 for v, _ in out["checks"].values()), out["checks"]
    assert out["judged"]["sampled"] == 2 and out["judged"]["bad"] == 0


def test_a_traced_run_reads_the_three_metrics():
    out = _run(2**31 + 9, trace_=True)
    assert out["correct"] and out["complete"]
    assert set(out["metrics"]) == set(METRICS)
    assert all(out["metrics"][m]["value"] >= 0 for m in METRICS)


@pytest.mark.parametrize("fault", ["control", "altered_leaf", "damaged_record"])
def test_the_control_and_every_fault_are_not_correct(fault):
    mod = _loop_module()
    ctrl = mod.CONTROL if fault == "control" else mod.FAULTS[fault]
    out = _run(12, ctrl=(ctrl,))
    assert not out["correct"], out["checks"]
    checks = {k: v for k, (v, _) in out["checks"].items()}
    if fault == "control":
        assert checks["frame_bad_bytes"] > 0 and checks["decoded_bad_bytes"] > 0
    if fault == "altered_leaf":
        assert checks["decoded_bad_bytes"] == 1 and checks["frame_bad_bytes"] == 0


def test_the_temporary_directory_is_gone_after_the_check():
    cell = _cell()
    loop = cell.module("loops", "restore").Loop(cell, 4, CPU)
    loop.warm(1)
    assert os.path.exists(loop.path)
    loop.window(0.05)
    loop.check(cell.reference())
    assert not os.path.exists(loop.dir)


def X(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}


def restore(t, leaves=3, wait=300, h2d=100):
    """One traced restore [t, t + 10000] in microseconds: the manifest
    [t+100, t+600], then each leaf a wait and a copy, 50 us of Python
    after each copy."""
    events = [X("bench.restore", t, 10000), X("tpbt.load_pytree", t + 50, 9000),
              X("tpbt.load_pytree.manifest", t + 100, 500)]
    at = t + 600
    for _ in range(leaves):
        events += [X("tpbt.load_pytree.wait", at, wait),
                   X("tpbt.load_pytree.h2d", at + wait, h2d),
                   X("cudaMemcpyAsync", at + wait + 10, 5, cat="cuda_runtime")]
        at += wait + h2d + 50
    return events


def _read(events) -> dict:
    tr = trace.parse(events)
    cell = harness.load_cell(CELL)
    return {m: cell.module("metrics", m).read(tr, {}) for m in METRICS}


def test_the_readers_on_a_synthetic_trace():
    got = _read(restore(0) + restore(20000, leaves=5, wait=100, h2d=200))
    assert got["restore_wait_ms"] == pytest.approx((0.9 + 0.5) / 2)
    assert got["restore_h2d_ms"] == pytest.approx((0.3 + 1.0) / 2)
    # 9000 us less the manifest and the leaves' spans
    assert got["restore_self_ms"] == pytest.approx((9.0 - 0.5 - 1.2 + 9.0 - 0.5 - 1.5) / 2)


def test_spans_outside_the_restores_are_not_read():
    stray = [X("tpbt.load_pytree.wait", 15000, 4000), X("tpbt.load_pytree", 14000, 5000)]
    assert _read(restore(0) + stray) == pytest.approx(_read(restore(0)))


@pytest.mark.parametrize("name", METRICS)
def test_none_without_the_program_spans(name):
    """What the parent's program gives: the benchmark's spans and runtime
    calls, nothing of tpbt.load_pytree."""
    events = [e for e in restore(0) + restore(20000) if not e["name"].startswith("tpbt.")]
    assert _read(events)[name] is None
    assert _read([])[name] is None


@pytest.mark.card
@pytest.mark.parametrize("trace_", ["0", "1"])
def test_the_command_on_the_card(card, trace_):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
                           str(2**31 + 77), "--seconds", "3", "--trace", trace_],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    if trace_ == "1":
        assert set(result["metrics"]) == set(METRICS)
