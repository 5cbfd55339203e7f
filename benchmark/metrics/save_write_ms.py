"""The save's file writes: the mean, over the traced saves, of the time
the program's ``tpbt.save_pytree.write`` spans cover in each (every
record's write, the manifest's too), in ms.  Read on the host's clock;
None where the program recorded no such span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.stage_ms(trace, "bench.save", "tpbt.save_pytree.write")
