"""The spans and counters of a checkpoint restore (``load_pytree``), on the CPU.

Under ``stats.trace`` a load onto a device (here ``device="cpu"``, the
prefetch pipeline a CUDA target takes) records ``tpbt.load_pytree`` with
its stages ``.manifest``, ``.wait`` and ``.h2d`` on the calling thread,
each inside it, a wait a window of leaves (here one window) and a copy a
leaf; with no profiler recording, ``record_function`` is never entered,
and the file and the loaded tree are the same either way.
``checkpoint.restored`` counts the leaves, their bytes, the multi-block
ones and the windows, of a load onto the host as of one onto a device.  The benchmark's readers of these spans read them
from a real trace of the same load.
"""

from __future__ import annotations

import importlib.util
import json
import os

import pytest
import torch
from torch.profiler import record_function

import tpu_blosc_torch as tb
from benchmark import trace as bench_trace
from tpu_blosc_torch import checkpoint, stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("tpbt.load_pytree.manifest", "tpbt.load_pytree.wait", "tpbt.load_pytree.h2d")
METRICS = ["restore_wait_ms", "restore_h2d_ms", "restore_self_ms"]


def _state():
    """Six tensor leaves, one of them above the 4 MiB automatic block
    threshold (a multi-block frame), a 0-element leaf and two values."""
    g = torch.Generator().manual_seed(5)
    return {"w": (torch.randn(2100, 1024, generator=g) * 0.02).to(torch.bfloat16),
            "layers": [{"b": torch.randn(64, generator=g), "g": torch.ones(64)}
                       for _ in range(2)],
            "empty": torch.empty(0, 3), "rng": torch.tensor([7, 8]), "step": 3, "name": "x"}


LEAVES = 6  # w, the two layers' b and g, rng: the 0-element leaf has no record
LEAF_BYTES = 2100 * 1024 * 2 + 2 * 64 * 4 * 2 + 16
WINDOWS = 1  # the leaves' bytes fit one window of stream._BATCH_WINDOW_BYTES


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = tmp_path_factory.mktemp("spans") / "state.tpbs"
    tb.save_pytree(p, _state())
    return p


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b


def _traced(tmp_path, path):
    """A load onto "cpu" under stats.trace inside a bench.restore span:
    (the loaded tree, the trace's events)."""
    with stats.trace(str(tmp_path)) as t:
        with record_function("bench.restore"):
            tree = tb.load_pytree(path, device="cpu")
    with open(t["trace_file"]) as f:
        return tree, json.load(f)["traceEvents"]


@pytest.fixture(scope="module")
def traced(path, tmp_path_factory):
    return _traced(tmp_path_factory.mktemp("trace"), path)


def _marks(events) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("tpbt.load_pytree")]


def _inside(child, parent) -> bool:
    # the exported times are microseconds to three decimals, each rounded
    return (child["ts"] >= parent["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 2e-3)


def test_a_load_records_its_stages_a_wait_and_a_copy_a_leaf(traced):
    _, events = traced
    names = [e["name"] for e in _marks(events)]
    assert names.count("tpbt.load_pytree") == names.count("tpbt.load_pytree.manifest") == 1
    assert names.count("tpbt.load_pytree.h2d") == LEAVES
    assert names.count("tpbt.load_pytree.wait") == WINDOWS
    assert set(names) == {"tpbt.load_pytree", *STAGES}


def test_every_stage_lies_inside_the_load_on_its_thread(traced):
    marks = _marks(traced[1])
    (top,) = [e for e in marks if e["name"] == "tpbt.load_pytree"]
    stages = [e for e in marks if e is not top]
    assert all(_inside(e, top) and e["tid"] == top["tid"] for e in stages)


def test_the_tree_and_the_file_are_the_same_with_the_profiler_on_and_off(path, traced,
                                                                         tmp_path):
    assert _same(traced[0], tb.load_pytree(path, device="cpu"))
    assert _same(traced[0], _state())
    with stats.trace(str(tmp_path)):
        tb.save_pytree(tmp_path / "traced.tpbs", _state())
    assert (tmp_path / "traced.tpbs").read_bytes() == path.read_bytes()


def test_no_profiler_enters_no_record_function(path, tmp_path, monkeypatch):
    """With the profiler off a span never reaches record_function; with it
    on, the same patched record_function is reached (so the patch bites)."""

    class Entered(Exception):
        pass

    def refuse(*args, **kwargs):
        raise Entered(args)

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert _same(tb.load_pytree(path, device="cpu"), _state())
    with pytest.raises(Entered):
        with stats.trace(str(tmp_path)):
            tb.load_pytree(path, device="cpu")


@pytest.mark.parametrize("loads", [1, 2])
def test_the_counter_reads_the_leaves_and_bytes_restored(path, loads):
    checkpoint.reset_restored()
    for _ in range(loads):
        tb.load_pytree(path, device="cpu")
    assert checkpoint.restored == {"leaves": loads * LEAVES, "bytes": loads * LEAF_BYTES,
                                   "multi_block_leaves": loads, "windows": loads * WINDOWS}
    tb.load_pytree(path)  # the host load takes the same pipeline: counted too
    assert checkpoint.restored["leaves"] == (loads + 1) * LEAVES
    assert checkpoint.restored["windows"] == (loads + 1) * WINDOWS
    checkpoint.reset_restored()
    assert set(checkpoint.restored.values()) == {0}


def _metric(name):
    p = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"ckpt_spans_metric_{name}", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", METRICS)
def test_the_metrics_read_the_spans_of_a_real_trace(traced, name):
    """Each reader gives the spans' own time on a real trace, and None on
    the same trace without the program's spans."""
    events = traced[1]
    got = _metric(name).read(bench_trace.parse(events), {})
    marks = _marks(events)
    covered = {n: sum(e["dur"] for e in marks if e["name"] == n) / 1e3 for n in STAGES}
    top = next(e["dur"] for e in marks if e["name"] == "tpbt.load_pytree") / 1e3
    want = {"restore_wait_ms": covered["tpbt.load_pytree.wait"],
            "restore_h2d_ms": covered["tpbt.load_pytree.h2d"],
            "restore_self_ms": top - sum(covered.values())}[name]
    assert got == pytest.approx(want, abs=5e-3)
    bare = [e for e in events if not e.get("name", "").startswith("tpbt.")]
    assert _metric(name).read(bench_trace.parse(bare), {}) is None
