"""The restore entry point's own time: the mean, over the traced
restores, of the program's ``tpbt.load_pytree`` span less the union of
its stages' spans (``tpbt.load_pytree.*``: the manifest, the waits, the
copies) inside it, in ms: the walk of the manifest's tree and the Python
of each leaf.  Read on the host's clock; None where the program recorded
no such span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.self_ms(trace, "bench.restore", "tpbt.load_pytree")
