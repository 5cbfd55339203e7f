"""The device side of a torch.profiler Chrome trace, cut by the benchmark's spans.

A frozen copy of the arithmetic of ``chip_smoke.py`` ``read_trace``
(:2063-2118), with its kernel names ``TRACE_KERNELS`` (:2049-2061) and
``LAUNCH_NAMES`` (:2123-2130); ``traced``'s retry (:2133-2177) is
``harness.traced``.  Kept here so that a change to the program cannot move
the yardstick:

- busy time is the union of the kernel, copy and memset intervals;
- a trace is complete when every runtime or driver call that put work on
  the card (a launch, a copy, a memset) has its device event, matched by
  correlation ID, and every launch of a port kernel that the port's
  counters saw has its kernel event.

Added here: the benchmark's own ``record_function`` spans (``bench.*``),
each with the calls made inside it and their device events, and the traced
window, from the first span's start to the last span's end.  Times are
the trace's microseconds.
"""

from __future__ import annotations

import bisect
import json
import os
import re
from dataclasses import dataclass, field

# (pattern of a kernel's name in a profiler trace, the port's kernel)
TRACE_KERNELS = [
    (r"vec16_blocks<\d+, true>", "tpbt_shuffle_blocks"),
    (r"vec16_blocks<\d+, false>", "tpbt_unshuffle_blocks"),
    (r"transpose_blocks<", "tpbt_shuffle_blocks or tpbt_unshuffle_blocks, generic"),
    (r"groups<(\d+, )?true>", "tpbt_bitshuffle_blocks"),
    (r"groups<(\d+, )?false>", "tpbt_bitunshuffle_blocks"),
    (r"seg_run_counts<", "tpbt_seg_run_counts"),
    (r"rows_rle<", "tpbt_rows_rle"),
    (r"match_count|match_argmax", "tpbt_match_count"),
    (r"match_nibble", "tpbt_match_nibble"),
    (r"probe_tiles", "tpbt_probe_tiles"),
    (r"match_fill", "tpbt_match_fill"),
]

# the kernels' launch counters (tpu_blosc_torch.filters.kernels.launches)
# by their names in TRACE_KERNELS
LAUNCH_NAMES = {"shuffle_blocks": "tpbt_shuffle_blocks",
                "unshuffle_blocks": "tpbt_unshuffle_blocks",
                "bit_shuffle_blocks": "tpbt_bitshuffle_blocks",
                "bit_unshuffle_blocks": "tpbt_bitunshuffle_blocks",
                "seg_run_counts": "tpbt_seg_run_counts", "rows_rle": "tpbt_rows_rle",
                "match_count": "tpbt_match_count", "match_nibble": "tpbt_match_nibble",
                "probe_tiles": "tpbt_probe_tiles", "match_fill": "tpbt_match_fill"}

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench."


@dataclass
class Event:
    cat: str
    name: str
    t0: float
    t1: float
    label: str = ""
    nbytes: int = 0
    corr: object = None


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    # the device events of the calls made inside the span, and those calls
    # (launches, copies, memsets) on the host's clock
    device: list = field(default_factory=list)
    calls: list = field(default_factory=list)


@dataclass
class Trace:
    spans: list
    device: list
    host: list
    calls: int
    lost: list
    kernel_counts: dict

    @property
    def window(self) -> tuple[float, float]:
        return self.spans[0].t0, self.spans[-1].t1

    def busy_us(self) -> float:
        """The union of the device intervals inside the window."""
        lo, hi = self.window
        return sum(b - a for a, b in merged(
            [(max(e.t0, lo), min(e.t1, hi)) for e in self.device]))

    def spans_named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]


def label_of(cat: str, name: str) -> str:
    """A device event's name in reports: the port's kernel by
    TRACE_KERNELS, torch's own kernels as "torch: <name>", copies and
    memsets as the profiler names them."""
    if cat != "kernel":
        return name
    label = next((k for pat, k in TRACE_KERNELS if re.search(pat, name)), None)
    return label or "torch: " + re.sub(r"^void |\(.*$|<.*$", "", name).split("::")[-1]


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals;
    empty ones dropped."""
    out: list = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def parse(events: list) -> Trace:
    """The Trace of a Chrome trace's ``traceEvents``."""
    timed = [e for e in events if "ts" in e and e.get("ph") == "X"]
    device, host, calls = [], [], {}
    spans = []
    for e in timed:
        cat, name = e.get("cat", ""), e.get("name", "")
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            device.append(Event(cat, name, t0, t1, label_of(cat, name),
                                int(args.get("bytes", 0) or 0), args.get("correlation")))
            continue
        if cat in HOST_CATS:
            host.append(Event(cat, name, t0, t1))
        if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append(Span(name, t0, t1))
        if cat in CALL_CATS and re.search(r"Launch|Memcpy|Memset", name):
            calls[args.get("correlation")] = Event(cat, name, t0, t1)
    spans.sort(key=lambda s: s.t0)
    starts = [s.t0 for s in spans]

    def span_of(call):
        i = bisect.bisect_right(starts, call.t0) - 1
        return spans[i] if i >= 0 and spans[i].t0 <= call.t0 <= spans[i].t1 else None

    for call in calls.values():
        span = span_of(call)
        if span is not None:
            span.calls.append(call)
    on_card = {e.corr for e in device}
    for e in device:
        span = span_of(calls[e.corr]) if e.corr in calls else None
        if span is not None:
            span.device.append(e)
    origin = min((float(e["ts"]) for e in timed), default=0.0)
    lost = [f"{c.name} at {(c.t0 - origin) / 1e3:.3f} ms" for corr, c in calls.items()
            if corr not in on_card]
    counts: dict = {}
    for e in device:
        if e.cat == "kernel":
            counts[e.label] = counts.get(e.label, 0) + 1
    return Trace(spans, device, host, len(calls), lost, counts)


def read(path: str) -> Trace:
    """Parse the Chrome trace at ``path`` and remove the file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return parse(events)


def completeness(trace: Trace, launched: dict) -> tuple[bool, dict]:
    """Whether the trace is complete, and each launched port kernel's
    events beside its launches ("kept of launched").  ``launched`` holds
    the launch counters' increase over the traced region, by their names
    in ``tpu_blosc_torch.filters.kernels.launches``."""
    want = {LAUNCH_NAMES[k]: v for k, v in launched.items() if k in LAUNCH_NAMES and v > 0}
    kept = {k: trace.kernel_counts.get(k, 0) for k in want}
    return (not trace.lost and kept == want and bool(trace.spans),
            {k: f"{kept[k]} of {v}" for k, v in want.items()})


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time inside the window summed by what the host was doing (the bench
    span and the innermost host operation at the middle of each idle
    stretch, cut where a span starts or ends), in seconds, at most ``top``
    of each."""
    ops: dict = {}
    for e in trace.device:
        ops[e.label] = ops.get(e.label, 0.0) + (e.t1 - e.t0) / 1e6
    lo, hi = trace.window
    busy = merged([(max(e.t0, lo), min(e.t1, hi)) for e in trace.device])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps: dict = {}
    starts = [s.t0 for s in trace.spans]
    bounds = sorted({x for s in trace.spans for x in (s.t0, s.t1)})
    # the host operations inside each span (index -1: outside every span)
    inside: dict = {}
    for h in trace.host:
        if h.name.startswith((SPAN_PREFIX, "ProfilerStep")):
            continue
        i = bisect.bisect_right(starts, h.t0) - 1
        inside.setdefault(i if i >= 0 and h.t0 <= trace.spans[i].t1 else -1, []).append(h)
    for a, b in zip(edges[::2], edges[1::2]):
        # a gap is cut where a span starts or ends, each piece named by
        # what the host was doing at its middle
        cuts = [a] + [x for x in bounds[bisect.bisect_right(bounds, a):] if x < b] + [b]
        for lo_, hi_ in zip(cuts, cuts[1:]):
            if hi_ <= lo_:
                continue
            mid = (lo_ + hi_) / 2
            i = bisect.bisect_right(starts, mid) - 1
            span = trace.spans[i] if i >= 0 and trace.spans[i].t1 >= mid else None
            inner = [h for h in inside.get(i if span else -1, []) if h.t0 <= mid <= h.t1]
            doing = min(inner, key=lambda h: h.t1 - h.t0).name if inner else "outside torch ops"
            name = f"{span.name}: {doing}" if span else f"between calls: {doing}"
            gaps[name] = gaps.get(name, 0.0) + (hi_ - lo_) / 1e6

    def ranked(d: dict) -> list:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}
