"""The entry point's own time in a decode call: the mean, over the traced
decode calls, of the program's ``tpbt.decompress`` span less the union of
its stages' spans (``tpbt.decompress.*``) inside it, in ms: header checks,
the block table, the route's choice, views.  Read on the host's clock;
None where the program recorded no such span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.self_ms(trace, "bench.decode", "tpbt.decompress")
