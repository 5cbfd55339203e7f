"""The share of the traced calls' host-device copy bytes that moved
through page-locked host memory, in %: the bytes of the HtoD and DtoH
memcpy events whose name says ``Pinned``, over the bytes of all of them;
None where the calls made no such copy."""


def read(trace, ctx: dict):
    copies = [e for s in trace.spans for e in s.device
              if e.cat == "gpu_memcpy" and ("HtoD" in e.name or "DtoH" in e.name)]
    total = sum(e.nbytes for e in copies)
    if total == 0:
        return None
    return 100.0 * sum(e.nbytes for e in copies if "Pinned" in e.name) / total
