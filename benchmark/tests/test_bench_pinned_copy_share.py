"""pinned_copy_share on hand-made Chrome traces: the bytes of the
host-device copies that name page-locked memory, over all of them, in the
benchmark's spans only."""

import pytest

from benchmark import harness, trace

MIB = 1 << 20
PAGEABLE = {"HtoD": "Memcpy HtoD (Pageable -> Device)", "DtoH": "Memcpy DtoH (Device -> Pageable)"}
PINNED = {"HtoD": "Memcpy HtoD (Pinned -> Device)", "DtoH": "Memcpy DtoH (Device -> Pinned)"}


def X(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def copy(name, ts, corr, nbytes, dur=1000):
    """A copy's runtime call at ``ts`` and its device event right after."""
    return [X("cuda_runtime", "cudaMemcpyAsync", ts, 5, correlation=corr),
            X("gpu_memcpy", name, ts + 10, dur, correlation=corr, bytes=nbytes)]


def round_trip(t, corr, d2h, h2d, nbytes=64 * MIB):
    """An encode span with one D2H copy and a decode span with one H2D
    copy, each from the given table of names."""
    return ([X("user_annotation", "bench.encode", t, 5000)]
            + copy(d2h["DtoH"], t + 100, corr, nbytes)
            + [X("user_annotation", "bench.decode", t + 5000, 5000)]
            + copy(h2d["HtoD"], t + 5100, corr + 1, nbytes))


def _read(events):
    cell = harness.Cell("c", harness.ROOT, 1, {}, {}, [], [])
    return cell.module("metrics", "pinned_copy_share").read(trace.parse(events), {})


@pytest.mark.parametrize("d2h, h2d, share", [(PAGEABLE, PAGEABLE, 0.0),
                                             (PINNED, PINNED, 100.0),
                                             (PINNED, PAGEABLE, 50.0)],
                         ids=["pageable", "pinned", "half"])
def test_share_of_the_copy_bytes(d2h, h2d, share):
    events = round_trip(0, 10, d2h, h2d) + round_trip(10000, 20, d2h, h2d)
    assert _read(events) == pytest.approx(share)


def test_mixed_bytes_weigh_by_size():
    # 64 MiB pinned each way, and a 62-byte pageable mask copy in the decode
    events = round_trip(0, 10, PINNED, PINNED) + copy(PAGEABLE["HtoD"], 7000, 30, 62, dur=2)
    assert _read(events) == pytest.approx(100 * 128 * MIB / (128 * MIB + 62))


def test_device_to_device_and_memsets_are_not_host_copies():
    events = (round_trip(0, 10, PINNED, PINNED)
              + copy("Memcpy DtoD (Device -> Device)", 6000, 30, 64 * MIB)
              + [X("cuda_runtime", "cudaMemsetAsync", 7000, 5, correlation=31),
                 X("gpu_memset", "Memset (Device)", 7010, 100, correlation=31, bytes=MIB)])
    assert _read(events) == pytest.approx(100.0)


def test_no_host_copy_reads_none():
    events = [X("user_annotation", "bench.encode", 0, 5000),
              X("cuda_runtime", "cudaLaunchKernel", 100, 5, correlation=1),
              X("kernel", "void tpbt::vec16_blocks<4, true>(unsigned char const*, unsigned char*)",
                200, 50, correlation=1)]
    assert _read(events) is None
    assert _read([]) is None


def test_copies_outside_the_bench_spans_are_not_counted():
    # the traced region's warm-up step copies from pageable memory before
    # the first span; between calls the loop makes another
    events = (copy(PAGEABLE["HtoD"], 0, 1, 4)
              + round_trip(1000, 10, PINNED, PINNED)
              + copy(PAGEABLE["DtoH"], 11500, 30, 64 * MIB)
              + round_trip(20000, 40, PINNED, PINNED))
    assert _read(events) == pytest.approx(100.0)
