"""The benchmark's driving code: cells found by name, one run of a cell.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that ``BENCHMARK.json`` gives it:

- a cell: its entry in ``BENCHMARK.json`` ``workloads`` (configuration,
  traffic, chips);
- a configuration: the ``file`` of its entry in ``configs``
  (``benchmark/configs/<name>.json``), which names its data generator
  (``benchmark/data/<generator>.py``) and its plain reference
  (``benchmark/reference/<module>.py``, ``make(config)``);
- a traffic mix: ``benchmark/traffic/<traffic>.json``, which names its
  loop (``benchmark/loops/<loop>.py``);
- an end-to-end metric: ``benchmark/end_to_end/<name>.py``, ``read(record)``
  of the window's record;
- a per-layer metric: ``benchmark/metrics/<name>.py``, ``read(trace, ctx)``
  of the traced calls (``trace.Trace``).

A reader that finds nothing to read returns None, and the metric is left
out of the result.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field

import torch

from benchmark import trace as trace_mod

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# round trips that set-up makes before the window, besides the check's sample
WARMUP_ROUND_TRIPS = 3
# traces taken at most until one is complete (chip_smoke.py traced, tries=3)
TRACE_TRIES = 3


@dataclass
class Cell:
    name: str
    root: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    modules: dict = field(default_factory=dict)

    def module(self, kind: str, name: str):
        """``benchmark/<kind>/<name>.py`` of this checkout, loaded once."""
        key = (kind, name)
        if key not in self.modules:
            path = os.path.join(self.root, "benchmark", kind, name + ".py")
            spec = importlib.util.spec_from_file_location(
                f"benchmark_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self.modules[key] = mod
        return self.modules[key]

    def reference(self):
        """The configuration's plain reference: ``make(config)`` of
        ``benchmark/reference/<module>.py``, the callable that the loop's
        check hands each output to."""
        return self.module("reference", self.config["reference"]["module"]).make(self.config)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, with its files read;
    KeyError when no cell has that name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", entry["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, root, entry["chips"], config, traffic, e2e, per_layer)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict:
    from tpu_blosc_torch.filters import kernels

    return dict(kernels.launches)


def traced(loop, device: torch.device, count: int, tries: int):
    """``count`` round trips of ``loop`` under torch.profiler; the trace is
    read and, where it is incomplete, taken again, up to ``tries`` times in
    all (``chip_smoke.py`` traced, :2133-2177).  Returns the last Trace,
    whether it is complete, and each attempt's reading."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    attempts = []
    for attempt in range(1, tries + 1):
        fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
        os.close(fd)
        try:
            prof = profile(activities=activities, record_shapes=False, acc_events=True,
                           schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                           on_trace_ready=lambda p: p.export_chrome_trace(path))
            prof.start()
            # the warm-up step: a copy from host memory and a kernel, which
            # the trace leaves out; a later trace in a process has been seen
            # to lose its first such pair (tpu_blosc_torch/stats.py:154-167)
            torch.ones(1).to(device).add_(1)
            _sync(device)
            prof.step()
            before = _launches()
            loop.traced(count)
            _sync(device)
            prof.step()
            prof.stop()
            tr = trace_mod.read(path)
        finally:
            if os.path.exists(path):
                os.remove(path)
        launched = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
        complete, kept = trace_mod.completeness(tr, launched)
        attempts.append({"attempt": attempt, "calls": tr.calls, "lost": len(tr.lost),
                         "lost_first": tr.lost[:4], "kernels_kept": kept,
                         "launches": launched, "complete": complete})
        if complete:
            break
    return tr, complete, attempts


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
            t_start: float, controls=()) -> dict:
    """One run of ``cell``: set-up, the timed window (or with ``trace`` the
    traced round trips), the device's memory peak, then the check.
    ``controls`` are callables ``(loop, exit_stack)`` that put something
    else in the timed path's place until the window has closed."""
    loop = cell.module("loops", cell.traffic["loop"]).Loop(cell, seed, device)
    with contextlib.ExitStack() as stack:
        for control in controls:
            control(loop, stack)
        loop.warm(WARMUP_ROUND_TRIPS)
        setup_s = time.perf_counter() - t_start
        before = _launches()
        if trace:
            tr, complete, attempts = traced(loop, device, cell.traffic["traced_round_trips"],
                                            TRACE_TRIES)
            record = None
        else:
            record = loop.window(seconds)
            record["setup_s"] = setup_s
            tr, complete, attempts = None, False, []
        _sync(device)
        launched = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    checks, judged = loop.check(cell.reference())
    correct = all(value <= limit for value, limit in checks.values())
    out = {"correct": correct, "attempted": loop.attempted,
           "failed": loop.raised + judged["bad"], "checks": checks, "judged": judged,
           "setup_s": setup_s, "memory_peak_bytes": peak, "launches": launched,
           "frame_bytes": loop.frame_bytes, "first_error": loop.first_error,
           "record": record, "attempts": attempts, "complete": complete}
    if trace:
        ctx = {"tensor_bytes": loop.nbytes, "config": cell.config, "traffic": cell.traffic}
        lo, hi = tr.window if tr.spans else (0.0, 0.0)
        out["busy_s"] = tr.busy_us() / 1e6 if tr.spans else 0.0
        out["window_s"] = (hi - lo) / 1e6
        out["breakdown"] = trace_mod.breakdown(tr) if tr.spans else None
        values = {m["name"]: cell.module("metrics", m["name"]).read(tr, ctx)
                  for m in cell.per_layer} if complete else {}
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in cell.per_layer if values.get(m["name"]) is not None}
    else:
        values = {m["name"]: cell.module("end_to_end", m["name"]).read(record)
                  for m in cell.end_to_end}
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in cell.end_to_end if values[m["name"]] is not None}
    return out
