"""The readers of the program's own spans (``tpbt.*``) on hand-made
Chrome traces: each stage's mean time a call, self time with stages that
overlap, run past their parent or are missing, and None where the program
recorded no span of the reader's."""

import pytest

from benchmark import harness, program_spans, trace

SIX = ["encode_codec_ms", "decode_codec_ms", "frame_write_ms", "host_filter_ms",
       "encode_self_ms", "decode_self_ms"]


def X(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}


def round_trip(t, codec=7000, decode=3000):
    """One compress call [t, t+10000] and one decode call [t+10000,
    t+20000] as the benchmark wraps them, with the program's spans inside,
    in microseconds: compress self time 200, decode self time 1700 at the
    default codec times."""
    enc_end = t + 1400 + codec
    dec_end = t + 10100 + decode
    return [
        X("bench.encode", t, 10000),
        X("tpbt.compress", t + 100, enc_end + 1500 - (t + 100)),
        X("tpbt.compress.filter", t + 200, 100),
        X("cudaLaunchKernel", t + 210, 5, cat="cuda_runtime"),
        X("tpbt.compress.d2h", t + 300, 1000),
        X("tpbt.compress.host_filter", t + 1300, 100),
        X("tpbt.compress.codec", t + 1400, codec),
        X("tpbt.compress.host_filter", enc_end, 100),
        X("tpbt.compress.frame", enc_end + 100, 1300),
        X("bench.decode", t + 10000, 10000),
        X("tpbt.decompress", t + 10050, dec_end + 6850 - (t + 10050)),
        X("tpbt.decompress.codec", t + 10100, decode),
        X("tpbt.decompress.host_filter", dec_end, 100),
        X("tpbt.decompress.h2d", dec_end + 100, 5000),
        X("tpbt.decompress.unfilter", dec_end + 5100, 100),
    ]


def _metric(name):
    cell = harness.Cell("c", harness.ROOT, 1, {}, {}, [], [])
    return cell.module("metrics", name)


def _read(events) -> dict:
    tr = trace.parse(events)
    return {name: _metric(name).read(tr, {}) for name in SIX}


def test_one_round_trip():
    got = _read(round_trip(0))
    assert got == pytest.approx({"encode_codec_ms": 7.0, "decode_codec_ms": 3.0,
                                 "frame_write_ms": 1.3, "host_filter_ms": 0.3,
                                 "encode_self_ms": 0.2, "decode_self_ms": 1.7})


def test_means_over_the_calls():
    got = _read(round_trip(0, codec=7000, decode=3000)
                + round_trip(20000, codec=5000, decode=2000))
    assert got["encode_codec_ms"] == pytest.approx(6.0)
    assert got["decode_codec_ms"] == pytest.approx(2.5)
    # the stages around the codec move with it: self time stays
    assert got["encode_self_ms"] == pytest.approx(0.2)
    assert got["decode_self_ms"] == pytest.approx(1.7)
    assert got["host_filter_ms"] == pytest.approx(0.3)


def test_a_call_without_a_stage_counts_zero_for_it():
    events = round_trip(0) + [e for e in round_trip(20000)
                              if e["name"] != "tpbt.compress.frame"]
    got = _read(events)
    assert got["frame_write_ms"] == pytest.approx(1.3 / 2)
    # the frame's 1300 us are the second call's entry time now
    assert got["encode_self_ms"] == pytest.approx((0.2 + 1.5) / 2)


def test_self_time_takes_the_union_of_overlapping_stages():
    events = round_trip(0) + [X("tpbt.compress.codec", 8000, 600)]  # inside codec and after
    got = _read(events)
    # [8000, 8600] adds nothing the codec [1400, 8400] and the raw-block
    # filter [8400, 8500] and frame [8500, 9800] do not cover
    assert got["encode_self_ms"] == pytest.approx(0.2)
    assert got["encode_codec_ms"] == pytest.approx((8600 - 1400) / 1e3)


def test_self_time_clips_a_stage_that_runs_past_its_parent():
    events = [e for e in round_trip(0) if e["name"] != "tpbt.compress.frame"]
    events.append(X("tpbt.compress.frame", 8500, 3000))  # parent ends at 9900
    got = _read(events)
    assert got["encode_self_ms"] == pytest.approx(0.1)


def test_self_time_without_stages_is_the_whole_span():
    events = [e for e in round_trip(0) if not e["name"].startswith("tpbt.decompress.")]
    got = _read(events)
    assert got["decode_self_ms"] == pytest.approx(9.9)
    assert got["decode_codec_ms"] is None
    assert got["host_filter_ms"] == pytest.approx(0.2)  # the compress half alone


def test_program_spans_outside_the_calls_are_not_read():
    events = round_trip(0) + [X("tpbt.compress", 30000, 5000),
                              X("tpbt.compress.codec", 30100, 4000)]
    assert _read(events) == pytest.approx(_read(round_trip(0)))


def test_spans_are_matched_by_start_on_the_host_clock():
    calls = program_spans.per_call(trace.parse(round_trip(0) + round_trip(20000)),
                                   "bench.decode")
    assert [len(c) for c in calls] == [5, 5]
    assert all(e.name.startswith("tpbt.decompress") for c in calls for e in c)


@pytest.mark.parametrize("name", SIX)
def test_none_without_program_spans(name):
    """What a program from before the spans gives: the benchmark's spans,
    runtime calls and nothing of tpbt.*"""
    events = [e for e in round_trip(0) + round_trip(20000)
              if not e["name"].startswith("tpbt.")]
    assert _metric(name).read(trace.parse(events), {}) is None


@pytest.mark.parametrize("name", SIX)
def test_none_on_an_empty_trace(name):
    assert _metric(name).read(trace.parse([]), {}) is None
