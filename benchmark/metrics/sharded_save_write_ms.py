"""The sharded save's file write on rank 0: the mean, over the traced
saves, of the time the program's ``tpbt.save_pytree.write`` spans cover
inside each ``bench.save_sharded`` span (each hand-off of a frame to the
writer thread, and the wait for its last writes, the footer and the
close), in ms.  Read on the host's clock; None where the program recorded
no such span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.stage_ms(trace, "bench.save_sharded", "tpbt.save_pytree.write")
