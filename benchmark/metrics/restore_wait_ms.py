"""The restore's wait for the host decode: the mean, over the traced
restores, of the time the program's ``tpbt.load_pytree.wait`` spans
cover in each, in ms.  The caller waits there for the worker thread's
next leaf (its record read and host decode): the decode that the
prefetch pipeline does not hide.  Read on the host's clock; None where
the program recorded no such span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.stage_ms(trace, "bench.restore", "tpbt.load_pytree.wait")
