"""How long the slowest rank outlasts rank 0 in a sharded save: the mean,
over the traced saves, of the loop's ``bench.save_sharded.barrier`` span,
rank 0's wait for the other ranks once its own save has returned, in ms.
Read on the host's clock; None where no save holds such a span."""


def read(trace, ctx: dict):
    spans = trace.spans_named("bench.save_sharded.barrier")
    saves = trace.spans_named("bench.save_sharded")
    return sum(s.t1 - s.t0 for s in spans) / len(saves) / 1e3 if spans and saves else None
