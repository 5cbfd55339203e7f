"""A save's windows of device leaves, on the CPU.

A run of device leaves (here CPU tensors handed to the pipeline that CUDA
leaves take) is cut into units (``checkpoint._device_units``): a window
holds consecutive "transfer" leaves that share their options and block
size, whose full blocks, up to ``checkpoint._SAVE_WINDOW_BYTES`` (lowered
here), stage 1 lays one after another in a host slab and stage 2
compresses in one native call, with one more call a distinct tail length
(``device._window_stage2``).  A single-block leaf, a leaf with no partner,
and one whose full blocks alone pass the window are compressed alone.  The file is tpu_blosc's ``save_pytree`` of
the same tree byte for byte and each record compress_array's frame.  An
error in stage 1 or in a window's native call raises from the save, stops
the worker and the writer, closes the file and leaves no slab behind;
the same on a two-rank sharded save.  ``saved["codec_windows"]`` and
``saved["windowed_leaves"]`` count the windows and their leaves, and a
traced save records its wait and codec spans on the caller.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import threading
import time
import weakref

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import record_function
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import torch_ckpt_window_worker as window_worker
import torch_dist_worker as dist_worker
import tpu_blosc as jb
import tpu_blosc_torch as tb
from benchmark import trace as bench_trace
from tpu_blosc import checkpoint as jc
from tpu_blosc.options import Options as JOptions
from tpu_blosc_torch import checkpoint, device, stats
from tpu_blosc_torch.chunk import parse_block_table
from tpu_blosc_torch.format import parse_header
from tpu_blosc_torch.stream import StreamReader, StreamWriter

KIB = 1024
BLOCK = 4096


@pytest.fixture(autouse=True)
def route(monkeypatch):
    """CPU tensors written as CUDA leaves are: the stage-1 worker, the
    windows and the stage-2 caller."""
    monkeypatch.setattr(checkpoint, "_on_cuda", lambda leaf: isinstance(leaf, torch.Tensor))


def _f32(n_bytes: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n_bytes // 4, generator=g) * 0.01


def _bf16(n_bytes: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n_bytes // 2, generator=g) * 1e-3).to(torch.bfloat16)


def _noise(n_bytes: int, seed: int) -> torch.Tensor:
    """Random bits: every block takes the memcpy fallback."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, (n_bytes // 4,), generator=g,
                         dtype=torch.int32).view(torch.float32)


THREE = 3 * BLOCK + 1000  # three full blocks and a ragged tail


def _cases() -> dict:
    """name -> (tree, Options keywords, window bytes, (windows, windowed
    leaves))."""
    return {
        # three leaves a window, the fourth window of one leaf is no window
        "windows_end_mid_run": (
            [_f32(THREE, s) for s in range(10)], {}, 40 * KIB, (3, 9)),
        "a_leaf_larger_than_the_window": (
            [_f32(THREE, 1), _f32(THREE, 2), _f32(20 * BLOCK + 8, 3), _f32(THREE, 4),
             _f32(THREE, 5)], {}, 32 * KIB, (2, 4)),
        # tails of 4, 100, 1000 and 2000 bytes, two of 100, and none
        "tails_of_several_lengths": (
            [_f32(2 * BLOCK + t, 10 + k) for k, t in enumerate((0, 100, 1000, 100, 0, 4, 2000))],
            {}, 256 * KIB, (1, 7)),
        "bit_shuffled_tails": (
            [_bf16(2 * BLOCK + t, 20 + k) for k, t in enumerate((2, 14, 16, 100, 0))],
            {"shuffle": tb.Shuffle.BITSHUFFLE}, 256 * KIB, (1, 5)),
        # windows cut where the type size changes, ZSTD at an explicit block size
        "type_sizes_2_and_4": (
            {"master": [_f32(THREE, 30), _f32(THREE, 31)],
             "moments": [_bf16(THREE, 32), _bf16(THREE, 33), _bf16(2 * BLOCK, 34)],
             "more": [_f32(THREE, 35), _f32(THREE, 36)]},
            {"codec": tb.Codec.ZSTD, "level": 3}, 256 * KIB, (3, 7)),
        # the 1 MiB automatic blocks of leaves above the automatic threshold
        "automatic_blocks": (
            [_f32((4 << 20) + (512 << 10), 40), _f32((4 << 20) + (512 << 10) + 8, 41)],
            {"block_size": 0}, 256 << 20, (1, 2)),
        # random bits beside smooth values: memcpy blocks and tails unfiltered
        "memcpy_fallback": (
            [_noise(THREE, 50), _f32(THREE, 51), _noise(2 * BLOCK + 12, 52),
             torch.cat([_f32(BLOCK, 53), _noise(BLOCK + 40, 54)])], {}, 256 * KIB, (1, 4)),
        # a run of one device leaf, host leaves between runs, and a
        # single-block leaf that ends a window
        "lone_leaf_and_host_leaves": (
            {"a": _f32(THREE, 60), "h": np.arange(3000, dtype=np.float32),
             "run": [_f32(THREE, 61), _f32(THREE, 65), _f32(1000, 62), _f32(THREE, 63)],
             "h2": np.arange(50, dtype=np.int16), "z": _f32(THREE, 64)},
            {}, 256 * KIB, (1, 2)),
    }


CASES = sorted(_cases())


def _numpy(tree):
    """The tree with NumPy leaves, bfloat16 as ml_dtypes', for tpu_blosc."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return tree.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return tree.numpy()
    return tree


def _leaves(tree) -> list:
    leaves: list = []
    checkpoint._encode(tree, leaves)
    return leaves


def _opts(kw: dict) -> tuple[tb.Options, JOptions]:
    kw = {"block_size": BLOCK, **kw}
    port = tb.Options(**kw)
    return port, JOptions(codec=jb.Codec(int(port.codec)), level=port.level,
                          shuffle=jb.Shuffle(int(port.shuffle)), block_size=port.block_size)


@pytest.mark.parametrize("case", CASES)
def test_a_windowed_save_is_tpu_blosc_s_file_and_compress_array_s_frames(tmp_path, monkeypatch,
                                                                        case):
    tree, kw, window, (windows, windowed) = _cases()[case]
    monkeypatch.setattr(checkpoint, "_SAVE_WINDOW_BYTES", window)
    opts, jopts = _opts(kw)
    mine, theirs = tmp_path / "t.tpbs", tmp_path / "j.tpbs"
    checkpoint.reset_saved()
    tb.save_pytree(mine, tree, opts)
    assert (checkpoint.saved["codec_windows"], checkpoint.saved["windowed_leaves"]) == (
        windows, windowed)
    jc.save_pytree(theirs, _numpy(tree), jopts)
    assert mine.read_bytes() == theirs.read_bytes()
    with StreamReader(mine) as r:
        for i, leaf in enumerate(_leaves(tree)):
            if isinstance(leaf, torch.Tensor):
                want = tb.compress_array(leaf, checkpoint._leaf_opts(opts, leaf.element_size()))
                assert r.read_frame(i + 1) == want, i
        if case == "memcpy_fallback":  # blocks and tails stored raw, in the window
            tables = [parse_block_table(f, parse_header(f))[0]
                      for f in (r.read_frame(i) for i in range(1, len(r)))]
            assert [any(m for _, m in t) for t in tables] == [True, False, True, True]
            assert all(t[-1][1] for t in (tables[0], tables[2], tables[3]))
    back = _leaves(tb.load_pytree(mine))
    for got, want in zip(back, _leaves(tree)):
        want = want if isinstance(want, torch.Tensor) else torch.from_numpy(want)
        assert got.dtype == want.dtype  # the bytes: random bits hold NaNs
        assert torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8))


def test_units_follow_the_leaves(monkeypatch):
    """Windows are cut by the options, the block size, the bytes a window
    holds and a leaf that is not a "transfer" leaf."""
    monkeypatch.setattr(checkpoint, "_SAVE_WINDOW_BYTES", 40 * KIB)
    run = [_f32(1000, 0), _f32(THREE, 1), _f32(1000, 2), _f32(THREE, 3), _f32(THREE, 4),
           _f32(THREE, 5), _bf16(THREE, 6), _f32(60 * KIB, 7), _f32(THREE, 8)]
    opts = tb.Options(block_size=BLOCK)
    units = checkpoint._device_units(
        run, [checkpoint._leaf_opts(opts, x.element_size()) for x in run], "transfer")
    assert [idx for idx, _ in units] == [[0], [1], [2], [3, 4, 5], [6], [7], [8]]
    assert [routes is None for _, routes in units] == [True] * 3 + [False] + [True] * 3
    assert [r.nb_full for r in units[3][1]] == [3, 3, 3]


@contextlib.contextmanager
def no_thread_outlives():
    """No writer thread is left when the block is left, and no thread
    started in it within the stage-1 worker's poll."""
    before = set(threading.enumerate())
    yield
    assert not [t for t in threading.enumerate() if t.name == "tpbt-checkpoint-writer"]
    deadline = time.monotonic() + 10
    while set(threading.enumerate()) - before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not set(threading.enumerate()) - before


@pytest.fixture
def writers(monkeypatch):
    """Every StreamWriter the save opens, to see it closed."""
    opened = []

    class Recorded(StreamWriter):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            opened.append(self)

    monkeypatch.setattr(checkpoint, "StreamWriter", Recorded)
    return opened


@pytest.fixture
def slabs(monkeypatch):
    """A weak reference to every slab the save makes."""
    made = []
    real = checkpoint._host_buffer

    def recorded(n, dev):
        slab = real(n, dev)
        made.append(weakref.ref(slab))
        return slab

    monkeypatch.setattr(checkpoint, "_host_buffer", recorded)
    return made


@pytest.mark.parametrize("stage, error", [("stage1", RuntimeError), ("native", RuntimeError),
                                          ("native", KeyboardInterrupt)])
def test_an_error_in_a_window_raises_from_the_save(tmp_path, monkeypatch, writers, slabs,
                                                   stage, error):
    """Five windows of two leaves: the third leaf's stage 1, or the second
    window's native call, fails while the worker fills the next slab or
    waits for one.  The save raises it, its threads end, the file is
    closed, and no slab outlives the error."""
    monkeypatch.setattr(checkpoint, "_SAVE_WINDOW_BYTES", 32 * KIB)
    if stage == "stage1":
        owner, name, nth = checkpoint, "_window_fetch", 3
    else:  # the first window's full blocks and tails, then the second's blocks
        owner, name, nth = device, "_native_slots", 3
    real, calls = getattr(owner, name), []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == nth:
            raise error("the window failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(owner, name, failing)
    tree = [_f32(THREE, s) for s in range(10)]
    with no_thread_outlives():
        with pytest.raises(error, match="the window failed") as info:
            tb.save_pytree(tmp_path / "x.tpbs", tree, tb.Options(block_size=BLOCK))
    (w,) = writers
    assert w._closed and w._f.closed
    with StreamReader(tmp_path / "x.tpbs") as r:  # a stream with its footer, cut short
        assert len(r) <= 3
    del info
    gc.collect()
    assert slabs and not [s for s in slabs if s() is not None]


def _known_tree():
    """A lone leaf, a single-block one, a window of two fp32 leaves, one of
    three bf16 leaves, and a lone leaf of another type size."""
    return {"m": [_f32(THREE, 1), _f32(500, 2), _f32(THREE, 3), _f32(THREE, 4)],
            "v": [_bf16(THREE, 5), _bf16(THREE, 6), _bf16(THREE, 7)],
            "x": _f32(THREE, 8).double()}


def test_the_counters_count_windows_and_their_leaves(tmp_path, monkeypatch):
    checkpoint.reset_saved()
    for _ in range(2):
        tb.save_pytree(tmp_path / "x.tpbs", _known_tree(), tb.Options(block_size=BLOCK))
    assert checkpoint.saved["codec_windows"] == 4 and checkpoint.saved["windowed_leaves"] == 10
    assert checkpoint.saved["device_leaves"] == 16
    checkpoint.reset_saved()
    assert checkpoint.saved["codec_windows"] == checkpoint.saved["windowed_leaves"] == 0
    monkeypatch.setattr(checkpoint, "_on_cuda", lambda leaf: False)  # the host route
    tb.save_pytree(tmp_path / "y.tpbs", _known_tree(), tb.Options(block_size=BLOCK))
    assert checkpoint.saved["codec_windows"] == checkpoint.saved["windowed_leaves"] == 0
    assert (tmp_path / "x.tpbs").read_bytes() == (tmp_path / "y.tpbs").read_bytes()


def test_a_traced_windowed_save_records_its_stages_on_the_caller(tmp_path):
    """One wait and one codec span a unit (two windows and three leaves
    alone), on the caller's thread inside the save; the benchmark's codec
    and wait readers read them."""
    import importlib.util

    with stats.trace(str(tmp_path)) as t:
        with record_function("bench.save"):
            tb.save_pytree(tmp_path / "x.tpbs", _known_tree(), tb.Options(block_size=BLOCK))
    with open(t["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("tpbt.save_pytree")]
    names = [e["name"] for e in marks]
    assert names.count("tpbt.save_pytree.wait") == names.count("tpbt.save_pytree.codec") == 5
    (top,) = [e for e in marks if e["name"] == "tpbt.save_pytree"]
    assert all(e["tid"] == top["tid"] for e in marks)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("save_codec_ms", "save_wait_ms"):
        spec = importlib.util.spec_from_file_location(
            f"window_metric_{name}", os.path.join(root, "benchmark", "metrics", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        got = mod.read(bench_trace.parse(events), {})
        assert got is not None and got > 0


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    return dist_worker.group_cache(tmp_path_factory, window_worker.__file__, "window")


@pytest.mark.skipif(not (dist.is_available() and dist.is_gloo_available()),
                    reason="torch.distributed with the Gloo backend is not available")
def test_a_sharded_save_windows_its_shards(spawned):
    """Two ranks: each rank's windowed file is its file with no window,
    the set loads back, each rank counts three windows of two shards, and
    a failing native call raises from that rank's save, which closes its
    file and leaves no thread."""
    out = spawned(2)
    for r in range(2):
        with open(os.path.join(out, f"win.p{r}.tpbs"), "rb") as a, \
                open(os.path.join(out, f"lone.p{r}.tpbs"), "rb") as b:
            assert a.read() == b.read()
        with open(os.path.join(out, f"win.r{r}.json")) as f:
            saved = json.load(f)
        assert (saved["codec_windows"], saved["windowed_leaves"]) == (3, 6)
        with open(os.path.join(out, f"fail.r{r}.json")) as f:
            failed = json.load(f)
        assert failed == {"raised": "native compress_blocks failed (-2)", "threads": [],
                          "closed": [True]}
    got = checkpoint.load_pytree_sharded(os.path.join(out, "win"), 2)
    want = window_worker.tree(2)
    assert got["step"] == 7 and torch.equal(got["bias"], want["bias"])
    for k, v in want["sharded"].items():
        assert got["sharded"][k].dtype == v.dtype and torch.equal(got["sharded"][k], v)
