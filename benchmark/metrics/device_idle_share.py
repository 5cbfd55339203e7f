"""The share of the traced window in which the device ran nothing, in %:
1 less the union of the kernel, copy and memset intervals over the window,
from the first traced call's start to the last one's end."""


def read(trace, ctx: dict):
    lo, hi = trace.window
    return 100.0 * (1.0 - trace.busy_us() / (hi - lo)) if hi > lo else None
