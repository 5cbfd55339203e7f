"""The filter work left on the host in a round trip: the time the
program's ``tpbt.compress.host_filter`` spans (the tail's filter, the
unfilter of blocks stored raw) cover in the traced compress calls plus
the time its ``tpbt.decompress.host_filter`` spans (the tail's unfilter)
cover in the traced decode calls, over the round trips, in ms.  Read on
the host's clock; None where the program recorded neither span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    parts = [program_spans.stage_ms(trace, "bench.encode", "tpbt.compress.host_filter"),
             program_spans.stage_ms(trace, "bench.decode", "tpbt.decompress.host_filter")]
    found = [p for p in parts if p is not None]
    return sum(found) if found else None
