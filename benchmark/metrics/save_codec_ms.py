"""The save's host codec: the mean, over the traced saves, of the time
the program's ``tpbt.save_pytree.codec`` spans cover in each (each device
leaf's stage 2, the native codec and the frame, and each native batch of
host leaves), in ms.  Read on the host's clock; None where the program
recorded no such span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.stage_ms(trace, "bench.save", "tpbt.save_pytree.codec")
