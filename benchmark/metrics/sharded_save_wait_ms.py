"""The sharded save's wait for stage 1 on rank 0: the mean, over the
traced saves, of the time the program's ``tpbt.save_pytree.wait`` spans
cover inside each ``bench.save_sharded`` span, in ms: the device leaves'
filter and copy to host memory that the stage-1 worker does not hide.
Read on the host's clock; None where the program recorded no such span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.stage_ms(trace, "bench.save_sharded", "tpbt.save_pytree.wait")
