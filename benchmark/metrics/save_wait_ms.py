"""The save's wait for stage 1: the mean, over the traced saves, of the
time the program's ``tpbt.save_pytree.wait`` spans cover in each, in ms.
The caller waits there for the worker thread's next leaf (its filter on
the device and its copy to host memory; a lone CUDA leaf runs that on
the caller, inside the span): the stage 1 that the prefetch does not
hide.  Read on the host's clock; None where the program recorded no such
span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.stage_ms(trace, "bench.save", "tpbt.save_pytree.wait")
