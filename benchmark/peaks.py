"""The card's published peaks and the least time a piece of work can take.

A frozen copy of ``chip_smoke.py`` ``PEAK_BYTES_PER_S``, ``PEAK_OPS_PER_S``
and ``bound()`` (:272-284), kept here so that a change to the program
cannot move the yardstick.  The peaks are NVIDIA's data sheet for the H100
SXM part at its full 700 W: device memory bytes a second, and operations a
second outside the tensor cores (the float32 rate).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# Blosc's automatic block for inputs over 4 MiB (the format rule that
# tpu_blosc_torch/chunk.py choose_block_size applies): 1 MiB, a multiple
# of 8 type sizes for every type size up to 16
AUTO_BLOCK_BYTES = 1 << 20
AUTO_BLOCK_THRESHOLD = 4 << 20


def bound(nbytes: int, operations: int) -> dict:
    """The least time the card could take to move ``nbytes`` (each input
    read once, each output written once) and to do ``operations``: the
    larger of the two times, in ms, and which of them it is."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = operations / PEAK_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def full_block_bytes(tensor_bytes: int) -> int:
    """The bytes of a tensor's full blocks under the automatic block size,
    which the device filter kernels move; 0 where the tensor makes a
    single-block frame (the host route, no kernel)."""
    if tensor_bytes <= AUTO_BLOCK_THRESHOLD:
        return 0
    return tensor_bytes // AUTO_BLOCK_BYTES * AUTO_BLOCK_BYTES
