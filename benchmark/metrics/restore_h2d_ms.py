"""The restore's copies to the device: the mean, over the traced
restores, of the time the program's ``tpbt.load_pytree.h2d`` spans cover
in each (every leaf's copy from host memory to the target device), in
ms.  Read on the host's clock; None where the program recorded no such
span."""

from benchmark import program_spans


def read(trace, ctx: dict):
    return program_spans.stage_ms(trace, "bench.restore", "tpbt.load_pytree.h2d")
