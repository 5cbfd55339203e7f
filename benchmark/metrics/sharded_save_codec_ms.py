"""The sharded save's host codec on rank 0: the mean, over the traced
saves, of the time the program's ``tpbt.save_pytree.codec`` spans cover
inside each ``bench.save_sharded`` span (each device shard's stage 2,
the native codec and the frame), in ms.  Read on the host's clock; None
where the program recorded no such span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.stage_ms(trace, "bench.save_sharded", "tpbt.save_pytree.codec")
