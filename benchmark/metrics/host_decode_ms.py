"""The host codec's share of a decode call: the mean, over the traced
decode calls, of the time from the start of the call's span to the start
of the first call in it that hands work to the card (a copy, a launch, a
memset), in ms: the host decode of the codec stage.

Both ends are on the host's clock.  A device event's time is not used: a
trace can place the device's clock a few milliseconds off the host's."""


def read(trace, ctx: dict):
    gaps = [min(c.t0 for c in s.calls) - s.t0
            for s in trace.spans_named("bench.decode") if s.calls]
    return sum(gaps) / len(gaps) / 1e3 if gaps else None
