"""The entry point's own time in a compress call: the mean, over the
traced compress calls, of the program's ``tpbt.compress`` span less the
union of its stages' spans (``tpbt.compress.*``) inside it, in ms: option
handling, the tensor's byte view, block sizing, the strategy's choice.
Read on the host's clock; None where the program recorded no such span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.self_ms(trace, "bench.encode", "tpbt.compress")
