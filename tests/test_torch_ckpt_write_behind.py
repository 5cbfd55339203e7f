"""A checkpoint's writer thread (``checkpoint._WriteBehind``), on the CPU.

``save_pytree`` and ``save_pytree_sharded`` hand their frames to one
thread, which opens the file (truncating an old one), writes the records
in order, the footer, and closes it while the caller compresses.  The
files are the bytes that writing each record on the caller gives, also
with a queue bound of one byte, where every hand-off but the first waits
(``saved["write_stalls"]``).  The open runs while the caller compresses,
and a save returns only once the file is closed.  An error on the thread
(a missing directory, a failed write) is raised by the save; an error on
the caller (its codec, an interrupt) stops the thread, which closes the
file.  No thread outlives a save.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

import tpu_blosc_torch as tb
from tpu_blosc_torch import api, checkpoint
from tpu_blosc_torch.errors import InvalidDataError
from tpu_blosc_torch.options import Options
from tpu_blosc_torch.stream import StreamReader, StreamWriter

WRITER = "tpbt-checkpoint-writer"
ROUTES = ["host", "device_pipeline"]


def _state():
    """Tensor leaves above and below the lowered block threshold (multi-
    and single-block frames; fp32 beside bf16), NumPy leaves of two
    element sizes, a 0-element leaf and values: 7 leaf records."""
    g = torch.Generator().manual_seed(11)
    return {"w": torch.randn(64, 256, generator=g) * 0.01,
            "m": (torch.randn(64, 256, generator=g) * 1e-3).to(torch.bfloat16),
            "b": torch.randn(40, generator=g),
            "host": [np.arange(3000, dtype=np.float32), np.arange(50, dtype=np.int16)],
            "rng": torch.tensor([3, 4]), "v": torch.ones(3000),
            "empty": torch.empty(0, 3), "step": 12}


RECORDS = 1 + 7  # the manifest and the leaves


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    """Multi-block frames above 8 KiB, as above the automatic block
    threshold at real sizes."""
    monkeypatch.setattr(api, "AUTO_BLOCK_THRESHOLD", 8192)


def _route(monkeypatch, route):
    if route == "device_pipeline":  # CPU tensors handed to the CUDA leaves' pipeline
        monkeypatch.setattr(checkpoint, "_on_cuda", lambda leaf: isinstance(leaf, torch.Tensor))


@contextlib.contextmanager
def no_thread_outlives():
    """The writer thread has ended when the block is left; the stage-1
    worker, stopped by then, within its poll: no thread started in the
    block is left."""
    before = set(threading.enumerate())
    yield
    assert not [t for t in threading.enumerate() if t.name == WRITER]
    deadline = time.monotonic() + 10
    while set(threading.enumerate()) - before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not set(threading.enumerate()) - before


@pytest.fixture
def writers(monkeypatch):
    """Every StreamWriter the checkpoint writers open, to see it closed."""
    opened = []

    class Recorded(StreamWriter):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            opened.append(self)

    monkeypatch.setattr(checkpoint, "StreamWriter", Recorded)
    return opened


def _closed(w: StreamWriter) -> bool:
    return w._closed and w._f.closed


def _per_record(path, tree, checksum: bool) -> None:
    """The file that writing each record on the caller gives: a
    StreamWriter opened here, record 0 through StreamWriter.write."""
    import json

    leaves: list = []
    skeleton = checkpoint._encode(tree, leaves)
    manifest = json.dumps({"version": checkpoint._MANIFEST_VERSION, "tree": skeleton,
                           "leaves": len(leaves)}).encode()
    with StreamWriter(path, checksum=checksum) as w:
        w.write(manifest, Options(type_size=1))
        checkpoint._write_leaf_records(
            w, [("device" if checkpoint._on_cuda(lf) else "host", lf) for lf in leaves], None)


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("route", ROUTES)
def test_a_full_queue_at_every_hand_off_writes_the_same_file(tmp_path, monkeypatch, writers,
                                                             route, checksum):
    """With a bound of one byte a frame waits until the one before it is
    written: every hand-off but the first stalls (the thread holds each
    write until the next hand-off has counted its stall), and the file is
    the same as with the default bound and as writing on the caller."""
    _route(monkeypatch, route)
    state = _state()
    _per_record(tmp_path / "per_record.tpbs", state, checksum)
    checkpoint.reset_saved()
    with no_thread_outlives():
        tb.save_pytree(tmp_path / "default.tpbs", state, checksum=checksum)
    assert checkpoint.saved["write_stalls"] == 0 and checkpoint.saved["writer_ns"] > 0

    monkeypatch.setattr(checkpoint, "_WRITE_BEHIND_BYTES", 1)
    real = StreamWriter.write_frame
    written = []

    def held_write(self, frame):
        k = len(written)
        deadline = time.monotonic() + 30
        while (k + 1 < RECORDS and checkpoint.saved["write_stalls"] < k + 1
               and time.monotonic() < deadline):
            time.sleep(0.001)
        written.append(k)
        return real(self, frame)

    monkeypatch.setattr(StreamWriter, "write_frame", held_write)
    checkpoint.reset_saved()
    with no_thread_outlives():
        tb.save_pytree(tmp_path / "bounded.tpbs", state, checksum=checksum)
    assert checkpoint.saved["write_stalls"] == RECORDS - 1 == len(written) - 1
    assert all(_closed(w) for w in writers) and len(writers) == 2
    data = (tmp_path / "per_record.tpbs").read_bytes()
    assert (tmp_path / "default.tpbs").read_bytes() == data
    assert (tmp_path / "bounded.tpbs").read_bytes() == data


@pytest.mark.parametrize("route", ROUTES)
def test_the_open_runs_while_the_caller_compresses(tmp_path, monkeypatch, writers, route):
    """The thread's open waits for the caller's first leaf codec: a save
    that opened the file on the caller before compressing could not
    finish."""
    _route(monkeypatch, route)
    compressed = threading.Event()
    real_open = StreamWriter.__init__

    def slow_open(self, *args, **kwargs):
        if not compressed.wait(30):
            raise TimeoutError("the open waited for a codec that never ran")
        real_open(self, *args, **kwargs)

    def after(real):
        def codec(*args, **kwargs):
            out = real(*args, **kwargs)
            compressed.set()
            return out
        return codec

    monkeypatch.setattr(StreamWriter, "__init__", slow_open)
    monkeypatch.setattr(checkpoint, "_compress_array_stage2",
                        after(checkpoint._compress_array_stage2))
    monkeypatch.setattr(checkpoint, "compress_batch_with_options",
                        after(checkpoint.compress_batch_with_options))
    state = _state()
    with no_thread_outlives():
        tb.save_pytree(tmp_path / "x.tpbs", state)
    (w,) = writers
    assert _closed(w)  # closed before the save returned
    assert torch.equal(tb.load_pytree(tmp_path / "x.tpbs")["m"], state["m"])


def test_the_writer_s_time_leaves_out_its_waits(tmp_path, monkeypatch):
    """``writer_ns`` counts the open, the writes and the close: not the
    half second the thread waits for the caller's codec."""
    real = checkpoint.compress_batch_with_options

    def slow_codec(*args, **kwargs):
        time.sleep(0.5)
        return real(*args, **kwargs)

    monkeypatch.setattr(checkpoint, "compress_batch_with_options", slow_codec)
    checkpoint.reset_saved()
    t0 = time.perf_counter_ns()
    tb.save_pytree(tmp_path / "x.tpbs", {"w": torch.ones(100)})
    wall = time.perf_counter_ns() - t0
    assert wall >= 5e8 and 0 < checkpoint.saved["writer_ns"] < wall - 4e8


def test_a_missing_directory_raises_from_the_save(tmp_path):
    with no_thread_outlives():
        with pytest.raises(FileNotFoundError):
            tb.save_pytree(tmp_path / "missing" / "x.tpbs", _state())
    assert not (tmp_path / "missing").exists()


@pytest.mark.parametrize("bound", [checkpoint._WRITE_BEHIND_BYTES, 1])
@pytest.mark.parametrize("route", ROUTES)
def test_a_write_that_fails_on_the_thread_raises_from_the_save(tmp_path, monkeypatch, writers,
                                                               route, bound):
    """The thread's error is the save's, at a hand-off or at the end, also
    where the caller waits on a full queue; the file is closed."""
    _route(monkeypatch, route)
    monkeypatch.setattr(checkpoint, "_WRITE_BEHIND_BYTES", bound)
    real = StreamWriter.write_frame
    raised = []

    def failing_write(self, frame):
        if len(self._offsets) == 3:
            raised.append(OSError(28, "No space left on device"))
            raise raised[0]
        return real(self, frame)

    monkeypatch.setattr(StreamWriter, "write_frame", failing_write)
    with no_thread_outlives():
        with pytest.raises(OSError, match="No space left") as info:
            tb.save_pytree(tmp_path / "x.tpbs", _state())
    assert info.value is raised[0]
    (w,) = writers
    assert _closed(w)
    with pytest.raises(InvalidDataError):  # three records of eight, and a footer
        tb.load_pytree(tmp_path / "x.tpbs")


@pytest.mark.parametrize("route", ROUTES)
def test_a_footer_that_fails_raises_from_the_save(tmp_path, monkeypatch, route):
    """An error after the last hand-off reaches the caller at the end."""
    _route(monkeypatch, route)
    real = StreamWriter.close

    def failing_close(self):
        real(self)
        raise OSError(5, "Input/output error")

    monkeypatch.setattr(StreamWriter, "close", failing_close)
    with no_thread_outlives():
        with pytest.raises(OSError, match="Input/output error"):
            tb.save_pytree(tmp_path / "x.tpbs", _state())


@pytest.mark.parametrize("error", [RuntimeError, KeyboardInterrupt])
@pytest.mark.parametrize("stage", ["stage2", "host_codec"])
def test_an_error_on_the_caller_stops_the_thread_and_closes_the_file(tmp_path, monkeypatch,
                                                                     writers, stage, error):
    if stage == "stage2":
        _route(monkeypatch, "device_pipeline")
        name = "_compress_array_stage2"
    else:
        name = "compress_batch_with_options"
    real = getattr(checkpoint, name)
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise error("the codec failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(checkpoint, name, failing)
    with no_thread_outlives():
        with pytest.raises(error, match="the codec failed"):
            tb.save_pytree(tmp_path / "x.tpbs", _state())
    (w,) = writers
    assert _closed(w)
    with StreamReader(tmp_path / "x.tpbs") as r:  # a stream, with its footer
        assert len(r) < RECORDS
    with pytest.raises(InvalidDataError):
        tb.load_pytree(tmp_path / "x.tpbs")


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("route", ROUTES)
def test_a_sharded_save_writes_through_the_thread(tmp_path, monkeypatch, writers, route,
                                                  checksum):
    """With no group this process is process 0 and writes every leaf; the
    file loads back, and record 0 is StreamWriter.write's record of the
    manifest."""
    _route(monkeypatch, route)
    state = _state()
    prefix = str(tmp_path / "s")
    checkpoint.reset_saved()
    with no_thread_outlives():
        checkpoint.save_pytree_sharded(prefix, state, Options(level=9), checksum=checksum)
    (w,) = writers
    assert _closed(w) and checkpoint.saved["leaves"] == RECORDS - 1
    got = checkpoint.load_pytree_sharded(prefix, 1)
    for key in ("w", "m", "b", "rng", "v"):
        assert torch.equal(got[key], state[key])
    assert [np.array_equal(a.numpy(), b) for a, b in zip(got["host"], state["host"])] == [True] * 2
    assert got["step"] == 12 and got["empty"].shape == (0, 3)
    with StreamReader(f"{prefix}.p0.tpbs") as r:
        manifest, frame = r.read(0), r.read_frame(0)
    with StreamWriter(tmp_path / "manifest.tpbs", checksum=checksum) as mw:
        mw.write(manifest, Options(type_size=1))
    with StreamReader(tmp_path / "manifest.tpbs") as r:
        assert r.read_frame(0) == frame
    # the stream's header and record 0 (its length, the frame, its crc32)
    # come before the footer's 28 bytes: a count, one offset, a size, the magic
    head = (tmp_path / "manifest.tpbs").read_bytes()[:-28]
    assert (tmp_path / "s.p0.tpbs").read_bytes()[:len(head)] == head


@pytest.mark.parametrize("route", ROUTES)
def test_saves_at_once_under_a_short_switch_interval(tmp_path, monkeypatch, route):
    """Twelve saves at once (more threads than cores), each with its
    writer, a bound of 4 KiB and a 10 us switch interval: every file is the
    one saved alone, and every writer ends holding no bytes."""
    _route(monkeypatch, route)
    tree = {f"t{i}": torch.arange(200 + 37 * i, dtype=torch.float32) for i in range(60)}
    tb.save_pytree(tmp_path / "alone.tpbs", tree)
    want = (tmp_path / "alone.tpbs").read_bytes()
    monkeypatch.setattr(checkpoint, "_WRITE_BEHIND_BYTES", 4096)
    writers, errors = [], []
    real_close = checkpoint._WriteBehind.close

    def close(self):
        real_close(self)
        writers.append(self)

    def save(k):
        try:
            tb.save_pytree(tmp_path / f"s{k}.tpbs", tree)
        except BaseException as exc:
            errors.append(exc)

    monkeypatch.setattr(checkpoint._WriteBehind, "close", close)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=save, args=(k,)) for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len({id(w) for w in writers}) == 12 and {w._held for w in writers} == {0}
    assert all((tmp_path / f"s{k}.tpbs").read_bytes() == want for k in range(12))
