"""The save entry point's own time: the mean, over the traced saves, of
the program's ``tpbt.save_pytree`` span less the union of its stages'
spans (``tpbt.save_pytree.*``: the manifest, the waits, the codec, the
writes) inside it, in ms: opening and truncating the file, its footer and
close, and the Python of each leaf.  Read on the host's clock; None where
the program recorded no such span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.self_ms(trace, "bench.save", "tpbt.save_pytree")
