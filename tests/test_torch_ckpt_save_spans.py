"""The spans and counters of a checkpoint save (``save_pytree``), on the CPU.

Under ``stats.trace`` a save records ``tpbt.save_pytree`` with its stages
``.manifest`` (once), ``.wait`` (one a CUDA leaf: here CPU tensors handed
to the pipeline as CUDA leaves are, as ``test_torch_checkpoint.py`` does),
``.codec`` (one a CUDA leaf's stage 2 and one a native batch of host
leaves) and ``.write`` (one a record's hand-off to the writer thread, the
manifest's too, and one the wait for the thread's last writes and the
file's close), all on the calling thread and inside the top span.  With
no profiler recording, ``record_function`` is never entered, and the
file is the same either way.  ``checkpoint.saved`` counts the leaf
records written, the hand-offs that found the writer's queue full, and
the writer thread's time.  The benchmark's readers of these spans read
them from a real trace of the same save, and the reader of the save's
copies picks them by time.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import record_function

import tpu_blosc_torch as tb
from benchmark import trace as bench_trace
from tpu_blosc_torch import checkpoint, stats
from tpu_blosc_torch.stream import StreamReader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP = "tpbt.save_pytree"
STAGES = ("tpbt.save_pytree.manifest", "tpbt.save_pytree.wait", "tpbt.save_pytree.codec",
          "tpbt.save_pytree.write")
SPAN_METRICS = ["save_wait_ms", "save_codec_ms", "save_write_ms", "save_self_ms"]


def _state():
    """Four tensor leaves (one above the 4 MiB automatic block threshold,
    a multi-block frame; fp32 beside bf16), two NumPy leaves of two
    element sizes between them, a 0-element leaf and values."""
    g = torch.Generator().manual_seed(7)
    return {"master": {"w": torch.randn(1100, 1024, generator=g) * 0.006,
                       "g": torch.ones(64) + 0.05 * torch.randn(64, generator=g)},
            "host": {"a": np.arange(3000, dtype=np.float32), "b": np.arange(50, dtype=np.int16)},
            "exp_avg": {"w": (torch.randn(1100, 1024, generator=g) * 1e-3).to(torch.bfloat16)},
            "empty": torch.empty(0, 2), "rng": torch.tensor([7, 8]), "step": 1000}


DEVICE_LEAVES = 4  # master/w, master/g, exp_avg/w, rng
HOST_LEAVES = 2
HOST_BATCHES = 2  # one native batch an element size
MULTI_BLOCK = 1  # master/w: 4.5 MB
LEAF_BYTES = 1100 * 1024 * (4 + 2) + 64 * 4 + 16 + 3000 * 4 + 50 * 2
# a hand-off a record, the manifest's too, and the drain at the end
WRITES = DEVICE_LEAVES + HOST_LEAVES + 1 + 1


@pytest.fixture
def as_device(monkeypatch):
    """CPU tensors written as CUDA leaves are: the stage-1 worker and the
    stage-2 caller."""
    monkeypatch.setattr(checkpoint, "_on_cuda", lambda leaf: isinstance(leaf, torch.Tensor))


def _traced(tmp_path, name="traced.tpbs"):
    """A save under stats.trace inside a bench.save span: (the file's
    path, the trace's events)."""
    path = tmp_path / name
    with stats.trace(str(tmp_path)) as t:
        with record_function("bench.save"):
            tb.save_pytree(path, _state())
    with open(t["trace_file"]) as f:
        return path, json.load(f)["traceEvents"]


def _marks(events) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith(TOP)]


def _inside(child, parent) -> bool:
    # the exported times are microseconds to three decimals, each rounded
    return (child["ts"] >= parent["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 2e-3)


def test_a_save_records_its_stages_on_its_thread_inside_the_save(tmp_path, as_device):
    _, events = _traced(tmp_path)
    marks = _marks(events)
    names = [e["name"] for e in marks]
    assert names.count(TOP) == names.count("tpbt.save_pytree.manifest") == 1
    assert names.count("tpbt.save_pytree.wait") == DEVICE_LEAVES
    assert names.count("tpbt.save_pytree.codec") == DEVICE_LEAVES + HOST_BATCHES
    assert names.count("tpbt.save_pytree.write") == WRITES
    assert set(names) == {TOP, *STAGES}
    (top,) = [e for e in marks if e["name"] == TOP]
    assert all(_inside(e, top) and e["tid"] == top["tid"] for e in marks if e is not top)


def test_the_host_route_records_no_wait(tmp_path):
    _, events = _traced(tmp_path)
    names = [e["name"] for e in _marks(events)]
    assert "tpbt.save_pytree.wait" not in names
    # every leaf a host leaf, in one flush: a batch a type size, 4, 2 and 8
    assert names.count("tpbt.save_pytree.codec") == 3
    assert names.count("tpbt.save_pytree.write") == WRITES


@pytest.mark.parametrize("route", ["host", "device_pipeline"])
def test_the_file_is_the_same_with_the_profiler_on_and_off(tmp_path, monkeypatch, route):
    plain = tmp_path / "plain.tpbs"
    tb.save_pytree(plain, _state())  # the host route's file
    if route == "device_pipeline":
        monkeypatch.setattr(checkpoint, "_on_cuda", lambda leaf: isinstance(leaf, torch.Tensor))
    traced, _ = _traced(tmp_path)
    off = tmp_path / "off.tpbs"
    tb.save_pytree(off, _state())
    assert traced.read_bytes() == off.read_bytes() == plain.read_bytes()


def test_no_profiler_enters_no_record_function(tmp_path, monkeypatch, as_device):
    """With the profiler off a span never reaches record_function; with it
    on, the same patched record_function is reached (so the patch bites)."""

    class Entered(Exception):
        pass

    def refuse(*args, **kwargs):
        raise Entered(args)

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tb.save_pytree(tmp_path / "off.tpbs", _state())
    with pytest.raises(Entered):
        with stats.trace(str(tmp_path)):
            tb.save_pytree(tmp_path / "on.tpbs", _state())


@pytest.mark.parametrize("route", ["host", "device_pipeline"])
def test_the_counter_reads_what_was_written(tmp_path, monkeypatch, route):
    if route == "device_pipeline":
        monkeypatch.setattr(checkpoint, "_on_cuda", lambda leaf: isinstance(leaf, torch.Tensor))
    checkpoint.reset_saved()
    path = tmp_path / "counted.tpbs"
    for _ in range(2):
        tb.save_pytree(path, _state())
    with StreamReader(path) as r:
        frame_bytes = sum(len(r.read_frame(i)) for i in range(1, len(r)))
    # a few MB of frames never fill the writer's queue
    assert checkpoint.saved == {
        "leaves": 2 * (DEVICE_LEAVES + HOST_LEAVES), "bytes": 2 * LEAF_BYTES,
        "device_leaves": 2 * DEVICE_LEAVES * (route == "device_pipeline"),
        "multi_block_leaves": 2 * MULTI_BLOCK, "frame_bytes": 2 * frame_bytes,
        "write_stalls": 0, "writer_ns": checkpoint.saved["writer_ns"], "shard_records": 0,
        # one multi-block leaf: no window of two
        "codec_windows": 0, "windowed_leaves": 0}
    assert checkpoint.saved["writer_ns"] > 0
    checkpoint.reset_saved()
    assert set(checkpoint.saved.values()) == {0}


def _metric(name):
    p = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"ckpt_save_spans_metric_{name}", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_the_metrics_read_the_spans_of_a_real_trace(tmp_path, as_device, name):
    """Each reader gives the spans' own time on a real trace, and None on
    the same trace without the program's spans."""
    _, events = _traced(tmp_path)
    got = _metric(name).read(bench_trace.parse(events), {})
    marks = _marks(events)

    def covered(stage):
        return sum(b - a for a, b in bench_trace.merged(
            [(e["ts"], e["ts"] + e["dur"]) for e in marks if e["name"] == stage])) / 1e3

    top = next(e["dur"] for e in marks if e["name"] == TOP) / 1e3
    inner = bench_trace.merged([(e["ts"], e["ts"] + e["dur"]) for e in marks
                                if e["name"] in STAGES])
    want = {"save_wait_ms": covered("tpbt.save_pytree.wait"),
            "save_codec_ms": covered("tpbt.save_pytree.codec"),
            "save_write_ms": covered("tpbt.save_pytree.write"),
            "save_self_ms": top - sum(b - a for a, b in inner) / 1e3}[name]
    assert got == pytest.approx(want, abs=5e-3) and got >= 0
    bare = [e for e in events if not e.get("name", "").startswith("tpbt.")]
    assert _metric(name).read(bench_trace.parse(bare), {}) is None


def test_the_copy_reader_finds_no_copy_in_a_cpu_trace(tmp_path, as_device):
    _, events = _traced(tmp_path)
    assert _metric("save_d2h_gbps").read(bench_trace.parse(events), {}) is None


def X(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_the_copy_reader_picks_the_copies_inside_the_saves_by_time():
    """Copies launched on a worker thread have no runtime call inside the
    span: the reader takes every DtoH copy that starts inside a bench.save
    span, and none outside, nor other copies."""
    events = [X("bench.save", 0, 1000), X("bench.save", 2000, 1000),
              X("Memcpy DtoH (Device -> Pinned)", 100, 20, "gpu_memcpy", bytes=1_000_000),
              X("Memcpy DtoH (Device -> Pinned)", 2900, 30, "gpu_memcpy", bytes=2_000_000),
              X("Memcpy DtoH (Device -> Pinned)", 1500, 10, "gpu_memcpy", bytes=5_000_000),
              X("Memcpy HtoD (Pinned -> Device)", 200, 10, "gpu_memcpy", bytes=9_000_000)]
    got = _metric("save_d2h_gbps").read(bench_trace.parse(events), {})
    assert got == pytest.approx(3_000_000 / 50 / 1e3)
    assert _metric("save_d2h_gbps").read(bench_trace.parse(events[2:]), {}) is None
