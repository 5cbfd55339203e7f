"""The host codec's share of a compress call: the mean, over the traced
compress calls, of the time from the end of the last call in it that hands
work to the card (the copy to pageable host memory, which returns once
the bytes are there) to the end of its span, in ms: host filter of the
tail, the codec, the raw-block unfilter and the frame's assembly.

Both ends are on the host's clock.  A device event's time is not used: a
trace can place the device's clock a few milliseconds off the host's."""


def read(trace, ctx: dict):
    gaps = [s.t1 - max(c.t1 for c in s.calls)
            for s in trace.spans_named("bench.encode") if s.calls]
    return sum(gaps) / len(gaps) / 1e3 if gaps else None
