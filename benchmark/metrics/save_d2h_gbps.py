"""The save's copies from the device: bytes of the DtoH memcpy events that
start inside a traced save's ``bench.save`` span, on the trace's clock,
over their summed device time, in GB/s.

The events are picked by their time and not by the span's calls: stage 1
launches its copies on a worker thread, and a runtime call there is tied
to no span of the caller's.  None where no such copy lies in a save."""


def read(trace, ctx: dict):
    spans = trace.spans_named("bench.save")
    copies = [e for e in trace.device if e.cat == "gpu_memcpy" and "DtoH" in e.name
              and any(s.t0 <= e.t0 <= s.t1 for s in spans)]
    us = sum(e.t1 - e.t0 for e in copies)
    return sum(e.nbytes for e in copies) / us / 1e3 if us > 0 else None
