"""The program's own spans inside the benchmark's, for the per-layer
metrics that read them.

``tpu_blosc_torch`` records the stages of ``compress_array`` and
``decompress_array`` as ``record_function`` spans named ``tpbt.*`` while a
profiler records (``tpu_blosc_torch/stats.py`` ``span``); they reach
``Trace.host`` as ``user_annotation`` events.  A program span belongs to
the traced call (``bench.encode`` / ``bench.decode``) whose span holds its
start, on the host's clock: the cells run one caller on one thread, so
the program's spans nest in the benchmark's.  A program that records no
such span (one from before they were added) gives every reader None.
"""

from __future__ import annotations

import bisect

from benchmark.trace import merged

PREFIX = "tpbt."


def per_call(trace, bench: str) -> list:
    """For each traced call whose span is named ``bench``, in order, the
    program's spans that start inside it."""
    own = sorted((e for e in trace.host
                  if e.cat == "user_annotation" and e.name.startswith(PREFIX)),
                 key=lambda e: e.t0)
    starts = [e.t0 for e in own]
    return [own[bisect.bisect_left(starts, s.t0):bisect.bisect_right(starts, s.t1)]
            for s in trace.spans_named(bench)]


def stage_ms(trace, bench: str, name: str) -> float | None:
    """The mean over the traced ``bench`` calls of the time the spans
    named ``name`` cover in each, in ms (a call without one counts 0);
    None where no call holds such a span."""
    calls = per_call(trace, bench)
    covered = [sum(b - a for a, b in merged([(e.t0, e.t1) for e in c if e.name == name]))
               for c in calls if any(e.name == name for e in c)]
    return sum(covered) / len(calls) / 1e3 if covered else None


def self_ms(trace, bench: str, top: str) -> float | None:
    """The mean over the traced ``bench`` calls of the self time of the
    program's span ``top``: its duration less the union of its stages'
    spans (``top.*``) clipped to it, in ms; None where no call holds
    ``top``."""
    calls = per_call(trace, bench)
    total, found = 0.0, False
    stage = top + "."
    for c in calls:
        for p in (e for e in c if e.name == top):
            found = True
            inner = merged([(max(e.t0, p.t0), min(e.t1, p.t1)) for e in c
                            if e.name.startswith(stage)])
            total += (p.t1 - p.t0) - sum(b - a for a, b in inner)
    return total / len(calls) / 1e3 if found else None
