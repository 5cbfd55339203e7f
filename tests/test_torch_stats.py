"""The port's stats module against tpu_blosc's, on the CPU.

≙ tests/test_stats.py.  Every field of CompressionStats but the wall time,
and every field of FrameStats, equals tpu_blosc's for single-block, split,
memcpy and container frames across the six codecs and three shuffles; a
container is no frame to frame_stats in either package; trace() records
the wall time, and trace(dir) writes a Chrome trace of the region's CPU
operators and sets trace_dir.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc import api as japi
from tpu_blosc import stats as jstats
from tpu_blosc_torch import api as tapi
from tpu_blosc_torch import stats as tstats

CODECS = ["BLOSCLZ", "LZ4", "LZ4HC", "SNAPPY", "ZLIB", "ZSTD"]
SHUFFLES = ["NOSHUFFLE", "SHUFFLE", "BITSHUFFLE"]
FIELDS = ["nbytes_orig", "nbytes_comp", "codec", "shuffle", "type_size", "block_size",
          "num_blocks", "memcpy_blocks", "ratio", "used_memcpy"]


def _data(kind: str) -> tuple[bytes, int]:
    """(bytes, block size) of each kind of frame."""
    if kind == "memcpy":  # random bytes: every block stored raw
        return np.random.default_rng(0).integers(0, 256, 100_000, np.uint8).tobytes(), 32768
    walk = np.cumsum(np.random.default_rng(1).integers(-3, 4, 80_000)).astype(np.float32)
    return walk.tobytes(), 65536 if kind == "split" else 0


def _same_stats(mine, theirs) -> None:
    """Every field but the wall time (the enums as their values)."""
    for name in FIELDS:
        a, b = getattr(mine, name), getattr(theirs, name)
        if name in ("codec", "shuffle"):
            a, b = int(a), int(b)
        assert a == b, name
    assert mine.elapsed_s > 0 and mine.throughput_gbps > 0


@pytest.mark.parametrize("kind", ["single", "split", "memcpy", "container"])
@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("codec", CODECS)
def test_stats_equal_tpu_blosc(codec, shuffle, kind, monkeypatch):
    data, bs = _data(kind)
    if kind == "container":  # inputs past this limit take the container
        monkeypatch.setattr(tapi, "FRAME_SAFE_LIMIT", 50_000)
        monkeypatch.setattr(japi, "FRAME_SAFE_LIMIT", 50_000)
    topts = tb.Options(codec=tb.Codec[codec], shuffle=tb.Shuffle[shuffle], block_size=bs)
    jopts = jb.Options(codec=jb.Codec[codec], shuffle=jb.Shuffle[shuffle], block_size=bs)
    frame, mine = tstats.compress_with_stats(data, topts)
    jframe, theirs = jstats.compress_with_stats(data, jopts)
    assert frame == jframe and tb.decompress(frame) == data
    _same_stats(mine, theirs)
    assert (mine.num_blocks > 1) == (kind in ("split", "memcpy"))
    if kind == "memcpy":
        assert mine.used_memcpy
    if kind == "container":
        assert frame[:4] == b"TPB2" and mine.block_size == 0
        for pkg in (tstats, jstats):
            with pytest.raises(jb.BloscError if pkg is jstats else tb.BloscError):
                pkg.frame_stats(frame)
        return
    fs, jfs = tstats.frame_stats(frame), jstats.frame_stats(jframe)
    assert fs.header.to_bytes() == jfs.header.to_bytes()
    assert (fs.num_blocks, fs.block_payload_sizes, fs.memcpy_blocks, fs.ratio) == (
        jfs.num_blocks, jfs.block_payload_sizes, jfs.memcpy_blocks, jfs.ratio)
    assert fs.num_blocks == mine.num_blocks and fs.memcpy_blocks == mine.memcpy_blocks


def test_memcpy_frames_count_every_block_raw():
    data, bs = _data("memcpy")
    frame, st = tb.compress_with_stats(data, tb.Options(shuffle=tb.NOSHUFFLE, type_size=1,
                                                        block_size=bs))
    assert st.used_memcpy and st.memcpy_blocks == st.num_blocks == 4 and st.ratio < 1.01
    single = tb.frame_stats(tb.compress(data[:5000], tb.LZ4, 5, tb.NOSHUFFLE, 1))
    assert single.num_blocks == single.memcpy_blocks == 1 and single.header.is_memcpy


def test_the_names_are_exported_as_in_tpu_blosc():
    for name in ("CompressionStats", "FrameStats", "compress_with_stats", "frame_stats"):
        assert getattr(tb, name) is getattr(tstats, name)
    assert tb.stats is tstats
    assert [f for f in tb.CompressionStats.__dataclass_fields__] == [
        f for f in jb.CompressionStats.__dataclass_fields__]
    assert [f for f in tb.FrameStats.__dataclass_fields__] == [
        f for f in jb.FrameStats.__dataclass_fields__]


def test_trace_records_the_wall_time_only():
    with tstats.trace() as t:
        tb.compress(b"x" * 10000, tb.LZ4, 5, tb.NOSHUFFLE, 1)
    assert t["elapsed_s"] > 0 and "trace_dir" not in t and "trace_file" not in t


def test_trace_writes_a_chrome_trace_of_the_region(tmp_path):
    log_dir = str(tmp_path / "traces" / "a")
    x = torch.arange(1 << 20, dtype=torch.float32)
    with tstats.trace(log_dir) as t:
        frame = tb.compress_array(x, tb.Options(block_size=65536))
        y = tb.decompress_array(frame, torch.float32, device="cpu", strategy="device")
    assert torch.equal(x, y)
    assert t["elapsed_s"] > 0 and t["trace_dir"] == log_dir
    assert os.path.dirname(t["trace_file"]) == log_dir and os.listdir(log_dir) == [
        os.path.basename(t["trace_file"])]
    with open(t["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    ops = {e.get("name") for e in events if e.get("cat") == "cpu_op"}
    # the shuffle pair's plain versions ran on the CPU inside the region
    assert {"aten::empty", "aten::copy_"} & ops
    assert all(e.get("cat") != "kernel" for e in events)  # no card here


def test_a_profiler_that_fails_to_start_leaves_the_region_untraced(tmp_path, monkeypatch):
    import torch.profiler

    def refuse(*args, **kwargs):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with tstats.trace(str(tmp_path)) as t:
        tb.compress(b"y" * 1000)
    assert t["elapsed_s"] > 0 and "trace_dir" not in t and os.listdir(tmp_path) == []
