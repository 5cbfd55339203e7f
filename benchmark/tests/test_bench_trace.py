"""The metric arithmetic on hand-made Chrome traces: spans, the union of
device intervals, completeness, the roofline bytes and the host times."""

import pytest

from benchmark import harness, peaks, trace

MIB = 1 << 20


def X(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def launch(ts, corr):
    return X("cuda_runtime", "cudaLaunchKernel", ts, 5, correlation=corr)


def copy_call(ts, corr, dur=5):
    return X("cuda_runtime", "cudaMemcpyAsync", ts, dur, correlation=corr)


def kernel(name, ts, dur, corr):
    return X("kernel", name, ts, dur, correlation=corr)


def memcpy(kind, ts, dur, corr, nbytes):
    return X("gpu_memcpy", f"Memcpy {kind}", ts, dur, correlation=corr, bytes=nbytes)


SHUFFLE = "void tpbt::vec16_blocks<4, true>(unsigned char const*, unsigned char*)"
UNSHUFFLE = "void tpbt::vec16_blocks<4, false>(unsigned char const*, unsigned char*)"


def round_trip(t, corr, d2h_call=5, skew=0):
    """One compress span [t, t+10000] (kernel at +1000 for 50 us, D2H at
    +1100 to +6000, its call at +1050 lasting ``d2h_call``) and one decode
    span [t+10000, t+20000] (H2D called at +12400, on the card +12500 to
    +18000, kernel at +18000 for 50 us), in microseconds; the device's
    events ``skew`` off the host's clock."""
    return [
        X("user_annotation", "bench.encode", t, 10000),
        launch(t + 900, corr), kernel(SHUFFLE, t + 1000 + skew, 50, corr),
        copy_call(t + 1050, corr + 1, d2h_call),
        memcpy("DtoH (Device -> Pageable)", t + 1100 + skew, 4900, corr + 1, 64 * MIB),
        X("user_annotation", "bench.decode", t + 10000, 10000),
        copy_call(t + 12400, corr + 2),
        memcpy("HtoD (Pageable -> Device)", t + 12500 + skew, 5500, corr + 2, 64 * MIB),
        launch(t + 17900, corr + 3), kernel(UNSHUFFLE, t + 18000 + skew, 50, corr + 3),
    ]


@pytest.fixture
def two_trips():
    return trace.parse(round_trip(0, 10) + round_trip(20000, 20))


def test_union_of_overlapping_intervals():
    assert trace.merged([(5, 8), (0, 3), (2, 4), (8, 9), (10, 10)]) == [(0, 4), (5, 9)]
    tr = trace.parse([X("user_annotation", "bench.encode", 0, 100),
                      kernel("a", 10, 30, 1), kernel("b", 20, 30, 2),
                      X("gpu_memset", "Memset", 45, 10, correlation=3),
                      X("gpu_memcpy", "Memcpy DtoD", 90, 20, correlation=4)])
    # [10, 55] and [90, 100]: the copy is clipped at the window's end
    assert tr.busy_us() == 45 + 10
    idle = _metric("device_idle_share").read(tr, {})
    assert idle == pytest.approx(100 * (1 - 55 / 100))


def test_spans_take_the_device_events_of_their_calls(two_trips):
    enc, dec = two_trips.spans_named("bench.encode"), two_trips.spans_named("bench.decode")
    assert len(enc) == len(dec) == 2
    assert [e.label for e in enc[0].device] == ["tpbt_shuffle_blocks",
                                                "Memcpy DtoH (Device -> Pageable)"]
    assert [e.label for e in dec[1].device] == ["Memcpy HtoD (Pageable -> Device)",
                                                "tpbt_unshuffle_blocks"]
    assert two_trips.window == (0, 40000)


def test_a_lost_device_event_makes_the_trace_incomplete(two_trips):
    launched = {"shuffle_blocks": 2, "unshuffle_blocks": 2, "shuffle_blocks.vec16": 2}
    assert trace.completeness(two_trips, launched)[0]
    events = round_trip(0, 10) + round_trip(20000, 20)
    lost = [e for e in events if e["args"].get("correlation") != 21 or e["cat"] != "gpu_memcpy"]
    tr = trace.parse(lost)
    assert len(tr.lost) == 1 and tr.lost[0].startswith("cudaMemcpyAsync")
    assert not trace.completeness(tr, launched)[0]


def test_a_launch_without_its_kernel_event_makes_the_trace_incomplete(two_trips):
    complete, kept = trace.completeness(two_trips, {"shuffle_blocks": 3, "unshuffle_blocks": 2})
    assert not complete and kept["tpbt_shuffle_blocks"] == "2 of 3"


@pytest.mark.parametrize("nbytes, blocks", [(64 * MIB, 64), (64_000_000, 61),
                                            (MIB, 0), (4 * MIB, 0)])
def test_roofline_bytes_are_the_full_blocks(nbytes, blocks):
    assert peaks.full_block_bytes(nbytes) == blocks * MIB


@pytest.mark.parametrize("nbytes, bound_ms", [(64 * MIB, 0.040064), (64_000_000, 0.038187)])
def test_roofline_share(two_trips, nbytes, bound_ms):
    assert peaks.bound(2 * peaks.full_block_bytes(nbytes), 0)["bound_ms"] == pytest.approx(
        bound_ms, abs=1e-6)
    for name in ("encode_kernel_roofline", "decode_kernel_roofline"):
        # each span's one kernel takes 50 us
        got = _metric(name).read(two_trips, {"tensor_bytes": nbytes})
        assert got == pytest.approx(100 * bound_ms / 0.050, rel=1e-4)


def test_roofline_counts_every_kernel_in_the_spans():
    events = round_trip(0, 10)
    events += [launch(1040, 99), kernel("void at::native::elementwise_kernel<128, 4>", 1060, 50, 99)]
    got = _metric("encode_kernel_roofline").read(trace.parse(events), {"tensor_bytes": 64 * MIB})
    assert got == pytest.approx(100 * 0.040064 / 0.100, rel=1e-4)


def test_no_kernel_gives_no_roofline():
    events = [e for e in round_trip(0, 10) if e["cat"] != "kernel"]
    assert _metric("encode_kernel_roofline").read(trace.parse(events),
                                                  {"tensor_bytes": 64 * MIB}) is None


@pytest.mark.parametrize("skew", [0, -3000, 2000])
def test_host_times(skew):
    """Host time runs from the span's edge to the calls that hand work to
    the card, so a device clock placed off the host's moves neither."""
    tr = trace.parse(round_trip(0, 10, 4960, skew) + round_trip(20000, 20, 4960, skew))
    # compress: span ends at +10000, the pageable D2H call returns at +6010
    assert _metric("host_encode_ms").read(tr, {}) == pytest.approx(3.99)
    # decode: span starts at +10000, the H2D is called at +12400
    assert _metric("host_decode_ms").read(tr, {}) == pytest.approx(2.4)


def test_copy_rates(two_trips):
    assert _metric("d2h_gbps").read(two_trips, {}) == pytest.approx(64 * MIB / 4900e-6 / 1e9)
    assert _metric("h2d_gbps").read(two_trips, {}) == pytest.approx(64 * MIB / 5500e-6 / 1e9)


def test_breakdown_ranks_device_ops_and_idle_gaps(two_trips):
    b = trace.breakdown(two_trips)
    assert [k for k, _ in b["device_ops"]][:2] == ["Memcpy HtoD (Pageable -> Device)",
                                                   "Memcpy DtoH (Device -> Pageable)"]
    gaps = dict(b["idle_gaps"])
    # a round trip's compress span is idle before and between its device
    # events and for 4 ms after the D2H; its decode span for 2.5 ms before
    # the H2D and 1.95 ms after the kernel
    assert gaps["bench.encode: outside torch ops"] == pytest.approx(2 * (1000 + 50 + 4000) / 1e6)
    assert gaps["bench.decode: outside torch ops"] == pytest.approx(2 * (2500 + 1950) / 1e6)
    assert sum(gaps.values()) == pytest.approx(
        (40000 - two_trips.busy_us()) / 1e6)


def _metric(name):
    cell = harness.Cell("c", harness.ROOT, 1, {}, {}, [], [])
    return cell.module("metrics", name)
