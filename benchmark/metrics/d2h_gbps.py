"""Bytes of the DtoH memcpy events of the traced calls over their summed
device duration, in GB/s."""


def read(trace, ctx: dict):
    copies = [e for s in trace.spans for e in s.device
              if e.cat == "gpu_memcpy" and "DtoH" in e.name]
    us = sum(e.t1 - e.t0 for e in copies)
    return sum(e.nbytes for e in copies) / us / 1e3 if us > 0 else None
