"""The host codec's time in a compress call: the mean, over the traced
compress calls, of the time the program's ``tpbt.compress.codec`` spans
cover in each (the codec over the filtered blocks, or on the host route
``compress_with_options``), in ms.  Read on the host's clock; None where
the program recorded no such span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.stage_ms(trace, "bench.encode", "tpbt.compress.codec")
