"""The host codec's time in a decode call: the mean, over the traced
decode calls, of the time the program's ``tpbt.decompress.codec`` spans
cover in each (the decode of the blocks into a fresh host buffer), in ms.
Read on the host's clock; None where the program recorded no such span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.stage_ms(trace, "bench.decode", "tpbt.decompress.codec")
