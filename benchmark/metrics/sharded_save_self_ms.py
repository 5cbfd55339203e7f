"""The sharded save entry point's own time on rank 0: the mean, over the
traced saves, of the program's ``tpbt.save_pytree_sharded`` span less the
union of its stages' spans inside it (``tpbt.save_pytree_sharded.manifest``
and save_pytree's ``tpbt.save_pytree.wait``, ``.codec`` and ``.write``,
which the sharded save records under those names), in ms: the Python of
each leaf between its stages.  Read on the host's clock; None where the
program recorded no such span (a program from before it was added)."""

from benchmark import program_spans
from benchmark.trace import merged

TOP = "tpbt.save_pytree_sharded"
STAGES = (TOP + ".", "tpbt.save_pytree.")


def read(trace, ctx: dict):
    calls = program_spans.per_call(trace, "bench.save_sharded")
    total, found = 0.0, False
    for c in calls:
        for p in (e for e in c if e.name == TOP):
            found = True
            inner = merged([(max(e.t0, p.t0), min(e.t1, p.t1)) for e in c
                            if e.name.startswith(STAGES)])
            total += (p.t1 - p.t0) - sum(b - a for a, b in inner)
    return total / len(calls) / 1e3 if found else None
