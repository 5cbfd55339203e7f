"""The filter kernels' share of their bound in the decode calls, in %.

The bound of one call is its full blocks' bytes, each read once and
written once, at the card's published bytes a second (peaks.py); the
full blocks follow from the tensor's size, not from the kernel.  The time
is the summed device duration of every kernel event inside the traced
decode spans, whatever its name, so a kernel that is fused, renamed or
replaced is held to the same work.  None where no kernel ran.
"""

from benchmark import peaks


def read(trace, ctx: dict):
    spans = trace.spans_named("bench.decode")
    us = sum(e.t1 - e.t0 for s in spans for e in s.device if e.cat == "kernel")
    full = peaks.full_block_bytes(ctx["tensor_bytes"])
    if us <= 0 or not full:
        return None
    bound_ms = peaks.bound(2 * full, 0)["bound_ms"]
    return 100.0 * len(spans) * bound_ms / (us / 1e3)
