"""The frame's assembly in a compress call: the mean, over the traced
compress calls, of the time the program's ``tpbt.compress.frame`` spans
cover in each (the header, block table and payloads gathered into one
frame), in ms.  Read on the host's clock; None where the program recorded
no such span (the host route writes its frame inside the codec)."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.stage_ms(trace, "bench.encode", "tpbt.compress.frame")
