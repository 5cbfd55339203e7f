"""The stage spans of the device round trip (``stats.span``), on the CPU.

Under ``stats.trace`` a round trip records the ``tpbt.*`` spans that
``stats.trace``'s docstring lists, the stages nested in their entry
point's span, each route its own set; with no profiler recording,
``record_function`` is never entered, and the frames are the same either
way.  The per-layer metrics of ``benchmark/metrics`` that read the spans
read them here from a real trace of the same round trips, so a span
renamed away from its reader fails here.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import record_function

import tpu_blosc_torch as tb
from benchmark import trace as bench_trace
from tpu_blosc_torch import stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 65536

MULTI_COMPRESS = {"tpbt.compress", "tpbt.compress.filter", "tpbt.compress.d2h",
                  "tpbt.compress.host_filter", "tpbt.compress.codec", "tpbt.compress.frame"}
MULTI_DECOMPRESS = {"tpbt.decompress", "tpbt.decompress.codec", "tpbt.decompress.host_filter",
                    "tpbt.decompress.h2d", "tpbt.decompress.unfilter"}
SINGLE_COMPRESS = {"tpbt.compress", "tpbt.compress.d2h", "tpbt.compress.codec"}
SINGLE_DECOMPRESS = {"tpbt.decompress", "tpbt.decompress.codec", "tpbt.decompress.h2d"}

# the readers of the spans, and the round trips in which each finds its span
METRICS = ["encode_codec_ms", "decode_codec_ms", "frame_write_ms", "host_filter_ms",
           "encode_self_ms", "decode_self_ms"]
SINGLE_SILENT = {"frame_write_ms", "host_filter_ms"}


def _multi():
    """Five 64 KiB blocks and a ragged tail of 1000 float64 elements of a
    smooth signal under ZSTD, the third block random bytes (stored raw)."""
    n = 5 * BLOCK // 8 + 1000
    x = np.sin(np.arange(n) / 300.0) * 1000.0
    raw = np.random.default_rng(7).integers(0, 256, BLOCK, dtype=np.uint8)
    x.view(np.uint8)[2 * BLOCK:3 * BLOCK] = raw
    opts = tb.Options(codec=tb.Codec.ZSTD, level=5, shuffle=tb.Shuffle.SHUFFLE, type_size=8,
                      block_size=BLOCK)
    return torch.from_numpy(x), opts


def _single():
    """A 1 MiB float32 ramp under LZ4: one block, the host route."""
    return (torch.arange(1 << 18, dtype=torch.float32),
            tb.Options(codec=tb.Codec.LZ4, level=5, shuffle=tb.Shuffle.SHUFFLE, type_size=4))


CASES = {"multi": (_multi, MULTI_COMPRESS, MULTI_DECOMPRESS),
         "single": (_single, SINGLE_COMPRESS, SINGLE_DECOMPRESS)}


def _round_trip(x, opts, enc=None, dec=None):
    """compress_array (transfer) then decompress_array (device) back onto
    the CPU, each call inside ``enc`` / ``dec`` when given."""
    with enc or contextlib.nullcontext():
        frame = tb.compress_array(x, opts, strategy="transfer")
    with dec or contextlib.nullcontext():
        y = tb.decompress_array(frame, x.dtype, x.shape, device="cpu", strategy="device")
    return frame, y


def _traced(tmp_path, x, opts):
    """A round trip under stats.trace, each call in a bench span as the
    benchmark wraps it: (frame, decoded tensor, the trace's events)."""
    with stats.trace(str(tmp_path)) as t:
        frame, y = _round_trip(x, opts, record_function("bench.encode"),
                               record_function("bench.decode"))
    with open(t["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    return frame, y, events


def _annotations(events) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and not e["name"].startswith("ProfilerStep")]


def _inside(child, parent) -> bool:
    # the exported times are microseconds to three decimals, each rounded
    return (child["ts"] >= parent["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 2e-3)


@pytest.fixture(scope="module", params=sorted(CASES))
def traced(request, tmp_path_factory):
    """One traced round trip of each case: (case, input, decoded tensor,
    the trace's events)."""
    x, opts = CASES[request.param][0]()
    _, y, events = _traced(tmp_path_factory.mktemp(request.param), x, opts)
    return request.param, x, y, events


def test_the_multi_block_case_has_a_raw_block_and_a_filtered_tail():
    x, opts = _multi()
    frame = tb.compress_array(x, opts)
    fs = stats.frame_stats(frame)
    assert fs.num_blocks == 6 and fs.memcpy_blocks == 1
    assert fs.block_payload_sizes[-1] < 8000  # the tail compressed


def test_each_route_records_its_stages(traced):
    case, x, y, events = traced
    _, compress_names, decompress_names = CASES[case]
    assert torch.equal(y.view(torch.uint8), x.view(torch.uint8))
    marks = _annotations(events)
    bench = [e for e in marks if e["name"].startswith("bench.")]
    assert sorted(e["name"] for e in bench) == ["bench.decode", "bench.encode"]
    program = [e for e in marks if e not in bench]
    assert all(e["name"].startswith("tpbt.") for e in program)
    names = [e["name"] for e in program]
    assert set(names) == compress_names | decompress_names
    assert names.count("tpbt.compress") == names.count("tpbt.decompress") == 1


def test_every_stage_lies_inside_its_entry_point_and_its_call(traced):
    marks = _annotations(traced[-1])
    by_name = {e["name"]: e for e in marks if e["name"] in (
        "bench.encode", "bench.decode", "tpbt.compress", "tpbt.decompress")}
    for top, bench in (("tpbt.compress", "bench.encode"), ("tpbt.decompress", "bench.decode")):
        assert _inside(by_name[top], by_name[bench])
        stages = [e for e in marks if e["name"].startswith(top + ".")]
        assert stages and all(_inside(e, by_name[top]) for e in stages)


@pytest.mark.parametrize("case", sorted(CASES))
def test_frames_are_the_same_with_the_profiler_on_and_off(case, tmp_path):
    x, opts = CASES[case][0]()
    frame, y = _round_trip(x, opts)
    traced_frame, traced_y, _ = _traced(tmp_path, x, opts)
    assert traced_frame == frame == tb.compress_with_options(x.numpy().tobytes(), opts)
    assert torch.equal(traced_y.view(torch.uint8), y.view(torch.uint8))


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_profiler_enters_no_record_function(case, tmp_path, monkeypatch):
    """With the profiler off a span never reaches record_function; with it
    on, the same patched record_function is reached (so the patch bites).
    The profiler's own step marks use torch.autograd.profiler's name,
    which stays as it is."""

    class Entered(Exception):
        pass

    def refuse(*args, **kwargs):
        raise Entered(args)

    x, opts = CASES[case][0]()
    want, _ = _round_trip(x, opts)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    frame, y = _round_trip(x, opts)
    assert frame == want and torch.equal(y.view(torch.uint8), x.view(torch.uint8))
    with pytest.raises(Entered):
        with stats.trace(str(tmp_path)):
            tb.compress_array(x, opts)


def _metric(name):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"spans_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", METRICS)
def test_the_metrics_read_the_spans_of_a_real_trace(traced, name):
    """Each reader gives a value where its span was recorded, the same as
    the spans' own times, and None on the same trace without them."""
    case, _, _, events = traced
    read = _metric(name).read
    got = read(bench_trace.parse(events), {})
    marks = {e["name"]: e["dur"] / 1e3 for e in _annotations(events)}
    if case == "single" and name in SINGLE_SILENT:
        assert got is None
    else:
        assert got is not None and got >= 0
    if name == "encode_codec_ms":
        assert got == pytest.approx(marks["tpbt.compress.codec"])
    if name == "decode_codec_ms":
        assert got == pytest.approx(marks["tpbt.decompress.codec"])
    if name == "encode_self_ms":
        assert 0 <= got < marks["tpbt.compress"]
    bare = [e for e in events if not e.get("name", "").startswith("tpbt.")]
    assert read(bench_trace.parse(bare), {}) is None
