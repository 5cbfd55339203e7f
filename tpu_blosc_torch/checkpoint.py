"""Compressed checkpoints of nested tensor structures, written by one
process or, sharded, by every process of a group.

Counterpart: ``tpu_blosc/checkpoint.py``; the files are byte for
byte the JAX package's for the same tree, and each package loads the
other's.  A checkpoint is a stream (stream.py): record 0 is a JSON
manifest of the structure, with each array leaf's NumPy dtype name
(``"float32"``, ``"bfloat16"``) and shape, and every array leaf with
elements is one record, compressed with ``type_size`` = its element
size.  A leaf with no elements is an ``array0`` node and has no record.

The structure is nested dicts (string keys), lists and tuples; leaves are
tensors, NumPy arrays (NumPy scalars become 0-d leaves) and JSON values
(int, float, str, bool, None).

    state = {"params": {"w": w, "b": b}, "step": 1000}
    checkpoint.save_pytree(path, state)
    cpu = checkpoint.load_pytree(path)               # CPU tensors
    gpu = checkpoint.load_pytree(path, device=True)  # on the current GPU

CUDA tensors are "device" records: a run of two or more goes through a
1-deep pipeline, unit k+1's filter on the device and copy to the host
(stage 1) on a worker thread while this thread runs unit k's host codec
(stage 2).  A unit is a leaf alone (_compress_array_stage1 and
_compress_array_stage2, the two halves of compress_array) or a window of
consecutive leaves (_device_units) whose full blocks stage 1 lays one
after another in a host slab and stage 2 compresses in one native call,
so that every core has blocks to compress (device._window_stage2); a
block's payload depends on its own bytes alone, so the frames are
compress_array's either way.  CPU
tensors and NumPy arrays are "host" records, compressed in batches of up
to stream._BATCH_WINDOW_BYTES.  Both writers hand their frames to one
writer thread (_WriteBehind), which opens the file (truncating an old
one), writes the records in order, the footer, and closes it while the
caller compresses; the call returns once the file is closed.  The
writers count what they write in ``saved``, as a load counts what it
restores in ``restored``.  A load,
onto the host or a device, takes its leaves in windows of consecutive
records of at most as many bytes (stream._decoded_windows): one worker
thread reads window w+1 with one read, another decodes window w into one
slab (the single-block frames in one native batch call, multi-block
frames that share codec, filter, type size and block size in one native
block call), while this thread copies window w-1's leaves out of the
slab, each into storage of its own on the target.  For a CUDA device the read buffers and slabs are page-locked
buffers of torch's caching host allocator (device._host_buffer), each
leaf's copy is queued on the stream without waiting for it, and a slab
goes back to the allocator, which hands it out again only once those
copies have run, when its last leaf is dropped.

A DTensor leaf of save_pytree is gathered (every rank of its mesh calls
save_pytree) and written whole by process 0, as the JAX package writes a
sharded ``jax.Array`` leaf.

Sharded (≙ tpu_blosc/checkpoint.py:396-670): every process of a
``torch.distributed`` group calls ``save_pytree_sharded(prefix, tree)``
and process p writes ``{prefix}.p{p}.tpbs``.  A leaf sharded over the
processes is a ``torch.distributed.tensor.DTensor``: each process writes
its local shard as one record and the shard's span of the global shape
into its manifest, a shard replicated over a mesh dimension once.  Plain
tensors, arrays and values are replicated: process 0 writes them.
``load_pytree_sharded(prefix, num_processes)`` and ``load_leaf_sharded``
put the leaves together again from all the files, as CPU tensors, in any
one process.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from . import dtypes
from . import stream as _stream
from .api import _is_container, compress_batch_with_options, compress_with_options
from .chunk import native_pipeline_codec
from .device import (
    _compress_array_stage1,
    _compress_array_stage2,
    _host_buffer,
    _stage1_route,
    _window_fetch,
    _window_stage2,
    tensor_bytes,
)
from .errors import InvalidDataError
from .filters import load_target
from .format import FLAG_SPLIT
from .options import Options
from .stats import span
from .stream import StreamReader, StreamWriter, _decoded_windows, _iter_prefetch

_MANIFEST_VERSION = 1

# what load_pytree's pipeline (a load onto the host, or onto a device with
# strategy "transfer" or "auto") restored since the last reset_restored():
# leaves, their tensor bytes, the leaves whose record is a multi-block
# frame, and the windows the leaves were decoded in
restored = {"leaves": 0, "bytes": 0, "multi_block_leaves": 0, "windows": 0}


def reset_restored() -> None:
    for name in restored:
        restored[name] = 0


# what the checkpoint writers wrote since the last reset_saved(): leaf
# records, their tensor bytes, those written as "device" records, those
# whose frame is multi-block, the leaf records' frame bytes, the hand-offs
# to the writer thread that found its queue full and waited, the
# nanoseconds the writer thread spent opening, writing and closing files,
# the records of sharded leaves (a DTensor's local shard) that
# save_pytree_sharded wrote in this process, the windows of device leaves
# whose full blocks one native call compressed, and the leaves whose full
# blocks those calls compressed
saved = {"leaves": 0, "bytes": 0, "device_leaves": 0, "multi_block_leaves": 0,
         "frame_bytes": 0, "write_stalls": 0, "writer_ns": 0, "shard_records": 0,
         "codec_windows": 0, "windowed_leaves": 0}


def reset_saved() -> None:
    for name in saved:
        saved[name] = 0


def _leaf_dtype(obj) -> tuple[torch.dtype, str]:
    """(torch dtype, manifest name) of an array leaf."""
    dt = obj.dtype if isinstance(obj, torch.Tensor) else dtypes.from_numpy(obj.dtype)
    return dt, dtypes.manifest_name(dt)


def _encode(obj, leaves: list):
    if isinstance(obj, np.generic):  # a NumPy scalar: a 0-d leaf
        obj = np.asarray(obj)
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        _, name = _leaf_dtype(obj)
        shape = list(obj.shape)
        numel = obj.numel() if isinstance(obj, torch.Tensor) else obj.size
        if numel == 0:  # no record, only the metadata
            return {"t": "array0", "dtype": name, "shape": shape}
        leaves.append(obj)
        return {"t": "array", "i": len(leaves) - 1, "dtype": name, "shape": shape}
    if isinstance(obj, dict):
        items = []
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"checkpoint dict keys must be strings, got {type(k)!r}")
            items.append([k, _encode(v, leaves)])
        return {"t": "dict", "items": items}
    if isinstance(obj, (list, tuple)):
        return {
            "t": "list" if isinstance(obj, list) else "tuple",
            "items": [_encode(v, leaves) for v in obj],
        }
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "raw", "v": obj}
    raise TypeError(f"unsupported checkpoint leaf type: {type(obj)!r}")


def _manifest_dtype(name) -> torch.dtype:
    dt = dtypes.from_string(name) if isinstance(name, str) else None
    if dt is None:
        raise InvalidDataError(f"blosc: invalid compressed data: manifest dtype {name!r}")
    return dt


def _decode(node, fetch, empty_device=None):
    t = node["t"]
    if t == "array":
        return fetch(node["i"], _manifest_dtype(node["dtype"]), tuple(node["shape"]))
    if t == "array0":
        return torch.empty(tuple(node["shape"]), dtype=_manifest_dtype(node["dtype"]),
                           device=empty_device)
    if t == "dict":
        return {k: _decode(v, fetch, empty_device) for k, v in node["items"]}
    if t == "list":
        return [_decode(v, fetch, empty_device) for v in node["items"]]
    if t == "tuple":
        return tuple(_decode(v, fetch, empty_device) for v in node["items"])
    if t == "raw":
        return node["v"]
    raise InvalidDataError(f"blosc: invalid compressed data: manifest node {t!r}")


def _on_cuda(leaf) -> bool:
    """A leaf that is written as a "device" record."""
    return isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"


def _leaf_opts(base: Options, itemsize: int) -> Options:
    return Options(codec=base.codec, level=base.level, shuffle=base.shuffle,
                   type_size=itemsize, block_size=base.block_size,
                   num_threads=base.num_threads)


def _host_bytes(leaf) -> tuple[np.ndarray, int]:
    """(flat uint8 array of a host leaf's bytes in C order, element size)."""
    if isinstance(leaf, torch.Tensor):
        return tensor_bytes(leaf).numpy(), leaf.element_size()
    arr = np.ascontiguousarray(leaf)
    return arr.reshape(-1).view(np.uint8), arr.dtype.itemsize


def _multi_block(frame: bytes) -> bool:
    """A frame of more than one block: FLAG_SPLIT, or a TPB2 container."""
    return _is_container(frame) or bool(frame[2] & FLAG_SPLIT)


# the most frame bytes a checkpoint's writer thread holds, queued or being
# written; a larger frame waits until the queue is empty.  It covers what
# the codec makes while the thread opens the file: truncating an old file
# of gigabytes can take over a second, and the codec makes frames at more
# than 1 GB/s
_WRITE_BEHIND_BYTES = 2 << 30


class _WriteBehind:
    """A checkpoint file written on a thread of its own.

    The thread opens ``StreamWriter(path, opts, checksum=checksum)`` (the
    open truncates an old file), writes each frame handed to write_frame,
    in order, then the footer, and closes the file, while the caller goes
    on.  write_frame waits only while the frames held would pass
    _WRITE_BEHIND_BYTES, counting each such hand-off in
    ``saved["write_stalls"]``; close() waits until the file is closed.  An
    error on the thread is raised on the caller, at its next write_frame
    or at close().  Leaving the ``with`` block by an exception stops the
    thread, which drops the frames still queued and closes the file.
    Either way the thread has ended when the block is left, and the time
    it spent in the open, the writes and the close (not waiting for
    frames) is added to ``saved["writer_ns"]``."""

    def __init__(self, path, opts: Options | None, checksum: bool):
        self._cv = threading.Condition()
        self._frames: collections.deque[bytes] = collections.deque()
        self._held = 0  # bytes of the frames queued or being written
        self._closing = False
        self._stopped = False
        self._error: BaseException | None = None
        self._ns = 0
        self._thread = threading.Thread(target=self._run, name="tpbt-checkpoint-writer",
                                        args=(os.fspath(path), opts, checksum), daemon=True)
        self._thread.start()

    def _timed(self, call, *args):
        """call(*args), its time added to the thread's (not its waits)."""
        t0 = time.perf_counter_ns()
        try:
            return call(*args)
        finally:
            self._ns += time.perf_counter_ns() - t0

    def _run(self, path: str, opts: Options | None, checksum: bool) -> None:
        try:
            w = self._timed(lambda: StreamWriter(path, opts, checksum=checksum))
            try:
                while True:
                    with self._cv:
                        self._cv.wait_for(lambda: self._frames or self._closing or self._stopped)
                        if self._stopped or not self._frames:
                            break
                        frame = self._frames[0]
                    self._timed(w.write_frame, frame)
                    with self._cv:
                        self._frames.popleft()
                        self._held -= len(frame)
                        self._cv.notify_all()
            finally:
                self._timed(w.close)
        except BaseException as exc:  # raised on the caller
            with self._cv:
                self._error = exc
                self._cv.notify_all()

    def write_frame(self, frame: bytes) -> None:
        n = len(frame)

        def room() -> bool:  # a frame larger than the bound waits for an empty queue
            return (not self._held or self._held + n <= _WRITE_BEHIND_BYTES
                    or self._error is not None)

        with self._cv:
            if not room():
                saved["write_stalls"] += 1
                self._cv.wait_for(room)
            if self._error is not None:
                raise self._error
            self._frames.append(frame)
            self._held += n
            self._cv.notify_all()

    def close(self) -> None:
        """Wait for the thread to write the frames queued and the footer
        and to close the file."""
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        self._join()
        if self._error is not None:
            raise self._error

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            saved["writer_ns"] += self._ns

    def __enter__(self) -> "_WriteBehind":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()
            return
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._join()


# a save compresses the full blocks of a window of consecutive device
# leaves, up to this many bytes, in one native call (device._window_stage2);
# two slabs of this size at most are held, one that stage 1 fills while
# stage 2 compresses the other
_SAVE_WINDOW_BYTES = 256 << 20


def _device_units(run: list[torch.Tensor], leaf_opts: list[Options], strategy: str) -> list:
    """A run of device leaves cut into stage-1 units, in record order:
    ``([i], None)`` for leaf i alone (compress_array's two halves), or
    ``(indices, routes)`` for a window of two or more consecutive
    "transfer" leaves (their _Routes) that share the options and the block
    size and have full blocks of at most _SAVE_WINDOW_BYTES in all.  Any
    other leaf is alone: a single-block one, one with a registered codec or
    an engaged strategy, one whose full blocks pass the window, and one
    with no partner."""
    units: list = []
    window: list[int] = []
    routes: list = []
    key, held = None, 0

    def close():
        nonlocal window, routes, key, held
        if len(window) > 1:
            units.append((window, routes))
        else:
            units.extend(([i], None) for i in window)
        window, routes, key, held = [], [], None, 0

    for i, x in enumerate(run):
        route = _stage1_route(x, leaf_opts[i], strategy)
        body = route.nb_full * route.block_size
        if (route.kind != "transfer" or body > _SAVE_WINDOW_BYTES
                or native_pipeline_codec(route.opts.codec, route.opts.level) is None):
            close()
            units.append(([i], None))
            continue
        if window and ((route.opts, route.block_size) != key
                       or held + body > _SAVE_WINDOW_BYTES):
            close()
        window.append(i)
        routes.append(route)
        key, held = (route.opts, route.block_size), held + body
    close()
    return units


class _Slabs:
    """The host slabs of a run's windows: two at most, of ``nbytes``
    each, made for the first window's device (device._host_buffer:
    page-locked for a CUDA device) when first taken.  take() waits until
    stage 2 gives one back, or raises once close() is called."""

    def __init__(self, nbytes: int):
        self._nbytes = nbytes
        self._free: queue.Queue = queue.Queue()
        for _ in range(2):
            self._free.put(None)
        self._closed = threading.Event()

    def take(self, device: torch.device) -> torch.Tensor:
        while not self._closed.is_set():
            try:
                slab = self._free.get(timeout=0.1)
            except queue.Empty:
                continue
            return slab if slab is not None else _host_buffer(self._nbytes, device)
        raise RuntimeError("the save stopped")

    def give(self, slab: torch.Tensor) -> None:
        self._free.put(slab)

    def close(self) -> None:
        self._closed.set()
        while not self._free.empty():
            self._free.get()


def _write_leaf_records(w, records, opts: Options | None,
                        strategy: str = "transfer") -> None:
    """Write ("host", leaf) and ("device", CUDA tensor) records, in order
    (≙ tpu_blosc/checkpoint.py:114-196), through ``w.write_frame`` (a
    _WriteBehind or a StreamWriter), counting them in ``saved``.

    On this thread it records ``tpbt.save_pytree.wait`` around each wait
    for a unit's stage 1 (a leaf's or a window's: the worker's filter and
    copy; a run of one unit runs stage 1 there itself),
    ``tpbt.save_pytree.codec`` around a unit's stage 2 and each native
    batch of host leaves, and ``tpbt.save_pytree.write`` around each
    record's write_frame (for a _WriteBehind, the hand-off).  Windows and
    their leaves are counted in ``saved``."""
    base = opts if opts is not None else Options()
    pending: list[tuple[np.ndarray, int]] = []
    pending_bytes = 0

    def write(frame: bytes, nbytes: int, on_device: bool):
        with span("tpbt.save_pytree.write"):
            w.write_frame(frame)
        saved["leaves"] += 1
        saved["bytes"] += nbytes
        saved["device_leaves"] += on_device
        saved["multi_block_leaves"] += _multi_block(frame)
        saved["frame_bytes"] += len(frame)

    def flush():
        nonlocal pending, pending_bytes
        by_ts: dict[int, list[int]] = {}
        for k, (_, itemsize) in enumerate(pending):
            by_ts.setdefault(itemsize, []).append(k)
        frames: dict[int, bytes] = {}
        for itemsize, idxs in by_ts.items():
            with span("tpbt.save_pytree.codec"):
                batch = compress_batch_with_options([pending[k][0] for k in idxs],
                                                    _leaf_opts(base, itemsize))
            frames.update(zip(idxs, batch))
        for k, (buf, _) in enumerate(pending):
            write(frames[k], buf.nbytes, False)
        pending, pending_bytes = [], 0

    def write_device_run(run: list[torch.Tensor]):
        leaf_opts = [_leaf_opts(base, x.element_size()) for x in run]
        units = _device_units(run, leaf_opts, strategy)
        slabs = _Slabs(max((sum(r.nb_full * r.block_size for r in routes)
                            for _, routes in units if routes is not None), default=0))

        def stage1(u: int):
            idx, routes = units[u]
            if routes is None:
                return _compress_array_stage1(run[idx[0]], leaf_opts[idx[0]], strategy)
            slab = slabs.take(run[idx[0]].device)
            tails, off = [], 0
            for i, route in zip(idx, routes):
                body = route.nb_full * route.block_size
                tails.append(_window_fetch(run[i], route, slab[off : off + body]))
                off += body
            return slab, off, tails

        # a lone unit runs stage 1 on this thread, inside its wait
        staged = (_iter_prefetch(stage1, len(units), prefetch=1) if len(units) > 1
                  else (stage1(u) for u in range(1)))
        try:
            for idx, routes in units:
                with span("tpbt.save_pytree.wait"):
                    item = next(staged)
                with span("tpbt.save_pytree.codec"):
                    if routes is None:
                        frames = [_compress_array_stage2(item)]
                    else:
                        slab, used, tails = item
                        frames = _window_stage2(slab[:used].numpy(), routes, tails)
                        slabs.give(slab)
                        saved["codec_windows"] += 1
                        saved["windowed_leaves"] += len(routes)
                for i, frame in zip(idx, frames):
                    write(frame, run[i].nbytes, True)
        finally:
            slabs.close()  # a worker waiting for a slab stops
            staged.close()  # on an error the worker stops now, not with the traceback

    records = list(records)
    i, n_rec = 0, len(records)
    while i < n_rec:
        kind, data = records[i]
        if kind == "host":
            buf = _host_bytes(data)
            pending.append(buf)
            pending_bytes += buf[0].nbytes
            if pending_bytes >= _stream._BATCH_WINDOW_BYTES:
                flush()
            i += 1
            continue
        flush()  # keep the record order
        j = i
        while j < n_rec and records[j][0] == "device":
            j += 1
        write_device_run([d for _, d in records[i:j]])
        i = j
    flush()


def _write_checkpoint(path, record0: bytes, records, opts: Options | None, checksum: bool,
                      strategy: str = "transfer") -> None:
    """Write a checkpoint file, record 0's frame then the leaf
    ``records`` (_write_leaf_records), through one _WriteBehind; return
    once the file is closed.  ``tpbt.save_pytree.write`` wraps record 0's
    hand-off and the wait for the thread's last writes, the footer and
    the close."""
    with _WriteBehind(path, opts, checksum) as w:
        with span("tpbt.save_pytree.write"):
            w.write_frame(record0)
        _write_leaf_records(w, records, opts, strategy=strategy)
        with span("tpbt.save_pytree.write"):
            w.close()


def _collect_leaf_specs(tree, n_leaves: int):
    """Leaf index -> (dtype, shape) from the manifest, or None unless the
    leaf indices are exactly 0..n_leaves-1 (a forged or damaged manifest
    then takes the per-leaf path, which raises as it would)."""
    specs: dict[int, tuple] = {}

    def walk(node):
        t = node.get("t") if isinstance(node, dict) else None
        if t == "array":
            i = node["i"]
            if not isinstance(i, int) or i in specs:
                raise ValueError
            specs[i] = (_manifest_dtype(node["dtype"]), tuple(node["shape"]))
        elif t == "dict":
            for _, v in node["items"]:
                walk(v)
        elif t in ("list", "tuple"):
            for v in node["items"]:
                walk(v)

    try:
        walk(tree)
    except Exception:
        return None
    return specs if sorted(specs) == list(range(n_leaves)) else None


def save_pytree(path, tree, opts: Options | None = None, checksum: bool = False,
                strategy: str = "transfer") -> None:
    """Write a nested tensor structure as a compressed checkpoint file.

    ``checksum=True`` adds a crc32 to every record, so a load detects a
    flipped bit instead of returning plausible garbage.  ``strategy``
    applies to CUDA leaves (compress_array's: "transfer", "match",
    "auto" or "rle").

    A DTensor leaf is written as the plain "array" of its full tensor, the
    node the JAX package writes for a sharded ``jax.Array``.  Its gather is
    a collective: every rank of its mesh calls save_pytree with the same
    tree, else the others wait until the group's timeout.  The leaves are
    gathered on this thread in leaf order, before any is written, and
    process 0 of the default group then writes the file (it holds every
    gathered leaf until then); the other processes write nothing.

    While a profiler records, the call is the span ``tpbt.save_pytree``
    (``stats.span``), with the stages ``tpbt.save_pytree.manifest`` (the
    tree's walk, a DTensor leaf's gather, record 0's frame), ``.wait``,
    ``.codec`` and ``.write`` (``_write_checkpoint``), all on the calling
    thread.  The file's open, its writes and its close run on a writer
    thread (_WriteBehind): ``.write`` is each hand-off of a frame to it,
    which waits only while its queue is full, and the wait for its last
    writes and the close.  The leaf records written, the full-queue
    hand-offs and the writer thread's time are counted in ``saved``.
    """
    from .dist import _group, _sharded

    with span("tpbt.save_pytree"):
        with span("tpbt.save_pytree.manifest"):
            leaves: list = []
            skeleton = _encode(tree, leaves)
            if any(_sharded.is_dtensor(lf) for lf in leaves):
                writer = _group.rank() == 0
                for i, lf in enumerate(leaves):
                    if _sharded.is_dtensor(lf):
                        full = _sharded.gather_full(lf)
                        leaves[i] = full if writer else None
                if not writer:
                    return
            manifest = json.dumps(
                {"version": _MANIFEST_VERSION, "tree": skeleton, "leaves": len(leaves)}
            ).encode()
            # the frame StreamWriter.write gives record 0
            record0 = compress_with_options(manifest, Options(type_size=1))
        _write_checkpoint(path, record0,
                          (("device" if _on_cuda(lf) else "host", lf) for lf in leaves),
                          opts, checksum, strategy)


def _read_manifest(r: StreamReader) -> dict:
    if len(r) == 0:
        raise InvalidDataError("blosc: invalid compressed data: empty checkpoint")
    meta = json.loads(r.read(0))
    if meta.get("version") != _MANIFEST_VERSION:
        raise InvalidDataError(
            f"blosc: invalid version: checkpoint manifest {meta.get('version')}"
        )
    return meta


def _read_leaf(r: StreamReader, i: int, dtype: torch.dtype, shape: tuple) -> torch.Tensor:
    """Record ``i`` as a CPU tensor of ``dtype`` and ``shape``."""
    buf = bytearray(r.read(i))
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(shape)


def _open_checkpoint(path) -> tuple[StreamReader, dict, dict | None]:
    """The open reader of a checkpoint file, its manifest and its leaf
    specs (``_collect_leaf_specs``); the reader is closed if either is
    refused."""
    r = StreamReader(path)
    try:
        meta = _read_manifest(r)
        if meta["leaves"] != len(r) - 1:
            raise InvalidDataError(
                "blosc: invalid compressed data: checkpoint leaf count mismatch"
            )
        return r, meta, _collect_leaf_specs(meta["tree"], meta["leaves"])
    except BaseException:
        r.close()
        raise


def load_pytree(path, device=False, strategy: str = "transfer"):
    """Read a checkpoint back: CPU tensors, or with ``device=True`` (the
    current CUDA device) or a device, tensors there.

    A load decodes its leaves on the host with a prefetch pipeline, in
    windows of records, and copies each leaf once, to the host or the
    device.  ``strategy`` applies to a device load: "transfer" and "auto"
    take the pipeline; "device", "rle" and "records" decode each leaf
    through decompress_array's strategy of that name.

    While a profiler records, the call is the span ``tpbt.load_pytree``
    (``stats.span``), with the stages ``tpbt.load_pytree.manifest``
    (opening the file, its manifest and the leaf specs) and, on the
    pipeline, ``tpbt.load_pytree.wait`` (this thread waiting for the
    workers' next decoded window) and ``tpbt.load_pytree.h2d`` (a leaf's
    copy out of its window, to the target), all on the calling thread.
    The pipeline counts what it restores in ``restored``.
    """
    with span("tpbt.load_pytree"):
        target = load_target(device, "load_pytree")
        with span("tpbt.load_pytree.manifest"):
            r, meta, specs = _open_checkpoint(path)
        with r:
            return _load_tree(r, meta, specs, target, strategy)


def _load_tree(r: StreamReader, meta: dict, specs: dict | None, target, strategy: str):
    """load_pytree's body over an open reader; ``target`` None loads onto
    the host."""
    dest = target if target is not None else torch.device("cpu")
    windows = None
    if specs is not None and (target is None or strategy in ("transfer", "auto")):
        # record k holds leaf k - 1 (record 0 is the manifest)
        windows = _decoded_windows(r, {i + 1: spec for i, spec in specs.items()}, dest)
    produced: dict[int, tuple[torch.Tensor, bool]] = {}

    def fetch(i: int, dtype: torch.dtype, shape: tuple):
        if windows is None:
            if target is None:
                return _read_leaf(r, i + 1, dtype, shape)
            return r.read_array(i + 1, dtype, shape=shape, device=target,
                                strategy=strategy)
        # windows arrive in index order; a manifest may walk the leaves in
        # another, so buffer until leaf i is there
        while i not in produced:
            with span("tpbt.load_pytree.wait"):
                window = next(windows)
            restored["windows"] += 1
            for k, host, split in window:
                produced[k - 1] = host, split
        host, split = produced.pop(i)
        with span("tpbt.load_pytree.h2d"):
            # copy=True: a CPU target's leaf must not share the slab; from a
            # page-locked slab the copy is queued and this thread goes on
            out = host.to(dest, non_blocking=True, copy=True)
        restored["leaves"] += 1
        restored["bytes"] += host.nbytes
        restored["multi_block_leaves"] += split
        return out

    return _decode(meta["tree"], fetch, target)


def _walk_manifest(tree: dict, key_path: str) -> dict:
    """The node at a '/'-separated path: dict keys by name, list and
    tuple items by index; KeyError where there is none
    (≙ tpu_blosc/checkpoint.py:506-530)."""
    node = tree
    walked = []
    for seg in (key_path.split("/") if key_path else []):
        walked.append(seg)
        t = node.get("t")
        if t == "dict":
            for k, v in node["items"]:
                if k == seg:
                    node = v
                    break
            else:
                raise KeyError(f"checkpoint has no leaf {'/'.join(walked)!r}")
        elif t in ("list", "tuple"):
            if not seg.isdigit() or int(seg) >= len(node["items"]):
                raise KeyError(f"checkpoint has no leaf {'/'.join(walked)!r}")
            node = node["items"][int(seg)]
        else:
            raise KeyError(
                f"checkpoint path {'/'.join(walked)!r} descends into a {t!r} leaf"
            )
    return node


def load_leaf(path, key_path: str, device=False):
    """One leaf (or subtree) of a checkpoint, reading only its records:
    ``key_path`` is '/'-separated, as ``"params/layers/0/w"``; the empty
    path is the root."""
    target = load_target(device, "load_leaf")
    with StreamReader(path) as r:
        node = _walk_manifest(_read_manifest(r)["tree"], key_path)

        def fetch(i: int, dtype: torch.dtype, shape: tuple):
            if target is not None:
                return r.read_array(i + 1, dtype, shape=shape, device=target)
            return _read_leaf(r, i + 1, dtype, shape)

        return _decode(node, fetch, target)


# ---------------------------------------------------------------------------
# multi-process sharded checkpoints
# ---------------------------------------------------------------------------


def _fully_replicated(obj) -> bool:
    """Every process holds the whole DTensor: no ``Shard`` placement lies
    on a mesh dimension of more than one rank."""
    from .dist._sharded import shard_span

    shard_span(obj)  # refuses placements that are neither
    return all(obj.device_mesh.size(m) == 1 or placement.is_replicate()
               for m, placement in enumerate(obj.placements))


def _encode_sharded(obj, leaves: list, pid: int):
    from .dist._sharded import is_dtensor

    if is_dtensor(obj):
        if obj.numel() == 0:  # no record, only the metadata
            return {"t": "array0", "dtype": dtypes.manifest_name(obj.dtype),
                    "shape": list(obj.shape)}
        if _fully_replicated(obj):
            obj = obj.to_local()  # the whole tensor: process 0 stores it
        else:
            leaves.append(("sharded", obj))
            return {"t": "sharded_array", "i": len(leaves) - 1,
                    "dtype": dtypes.manifest_name(obj.dtype), "shape": list(obj.shape)}
    if isinstance(obj, np.generic):
        obj = np.asarray(obj)
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        node = _encode(obj, [])
        if node["t"] == "array":
            leaves.append(("replicated", obj if pid == 0 else None))
            node["i"] = len(leaves) - 1
        return node
    if isinstance(obj, dict):
        items = []
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"checkpoint dict keys must be strings, got {type(k)!r}")
            items.append([k, _encode_sharded(v, leaves, pid)])
        return {"t": "dict", "items": items}
    if isinstance(obj, (list, tuple)):
        return {
            "t": "list" if isinstance(obj, list) else "tuple",
            "items": [_encode_sharded(v, leaves, pid) for v in obj],
        }
    return _encode(obj, leaves)  # a JSON value, or TypeError


def save_pytree_sharded(path_prefix, tree, opts: Options | None = None,
                        checksum: bool = False) -> None:
    """Multi-process checkpoint: every process writes its own shards.

    Call from ALL processes with the same arguments.  Process p (its rank
    in the default group; 0 with no group) writes
    ``{path_prefix}.p{p}.tpbs`` with one compressed record per local shard
    of each sharded leaf (a DTensor; a CUDA shard is filtered on its
    device, as compress_array does), and the global dtype and shape and
    the shards' spans in the manifest.  Replicated leaves and host values
    are written by process 0 only.  load_pytree_sharded reassembles from
    all files.  The file goes through the pipeline save_pytree takes
    (_write_checkpoint): no collective runs, so every process saves at its
    own pace.

    While a profiler records, the call is the span
    ``tpbt.save_pytree_sharded`` (``stats.span``), with the stages
    ``tpbt.save_pytree_sharded.manifest`` (the tree's walk, each shard's
    span check, record 0's frame) and save_pytree's ``tpbt.save_pytree.wait``,
    ``.codec`` and ``.write`` (``_write_checkpoint``), all on the calling
    thread.  Besides what ``saved`` counts of every save, the records of
    sharded leaves this process wrote are counted in
    ``saved["shard_records"]``.
    """
    from .dist import _group
    from .dist._sharded import shard_span

    with span("tpbt.save_pytree_sharded"):
        with span("tpbt.save_pytree_sharded.manifest"):
            pid = _group.rank()
            leaves: list = []
            skeleton = _encode_sharded(tree, leaves, pid)
            records: list = []
            manifest_leaves = []
            for kind, obj in leaves:
                if kind == "replicated":
                    manifest_leaves.append({"k": "replicated", "n": 1 if obj is not None else 0})
                    if obj is not None:
                        records.append(("device" if _on_cuda(obj) else "host", obj))
                    continue
                piece, writer = shard_span(obj)
                local = obj.to_local()
                if tuple(local.shape) != tuple(b - a for a, b in piece):
                    raise ValueError(
                        f"a DTensor's local shard is {tuple(local.shape)}, its placements "
                        f"{obj.placements} give the span {piece}"
                    )
                # an empty shard (uneven split) and a replica are no record
                spans = [piece] if writer and local.numel() else []
                manifest_leaves.append({"k": "sharded", "n": len(spans), "spans": spans})
                if spans:
                    records.append(("device" if _on_cuda(local) else "host", local))
            manifest = json.dumps({
                "version": _MANIFEST_VERSION,
                "tree": skeleton,
                "leaf_records": manifest_leaves,
                "process": pid,
            }).encode()
            # record 0: the frame StreamWriter.write gives the manifest
            record0 = compress_with_options(manifest, Options(type_size=1))
        _write_checkpoint(f"{path_prefix}.p{pid}.tpbs", record0, records, opts, checksum)
    saved["shard_records"] += sum(m["n"] for m in manifest_leaves if m["k"] == "sharded")


class _ShardedSet:
    """The open files of a sharded checkpoint and their manifests."""

    def __init__(self, path_prefix, num_processes: int):
        self.readers: list[StreamReader] = []
        try:
            for p in range(num_processes):
                self.readers.append(StreamReader(f"{path_prefix}.p{p}.tpbs"))
            self.metas = [_read_manifest(r) for r in self.readers]
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        for r in self.readers:
            r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def first_record(self, p: int, i: int) -> int:
        """The index, in process p's file, of leaf i's first record
        (record 0 is the manifest)."""
        return 1 + sum(x["n"] for x in self.metas[p]["leaf_records"][:i])

    def leaf(self, node: dict, bases: list[int]) -> torch.Tensor:
        """The "array" or "sharded_array" leaf ``node`` as a CPU tensor;
        ``bases[p]`` is its first record in process p's file."""
        i = node["i"]
        dtype, shape = _manifest_dtype(node["dtype"]), tuple(node["shape"])
        if node["t"] == "array":  # replicated: stored by whichever process has n = 1
            for p, m in enumerate(self.metas):
                if m["leaf_records"][i]["n"]:
                    return _read_leaf(self.readers[p], bases[p], dtype, shape)
            raise InvalidDataError("blosc: invalid compressed data: replicated leaf missing")
        out = torch.empty(shape, dtype=dtype)
        filled = torch.zeros(shape, dtype=torch.bool)
        for p, m in enumerate(self.metas):
            for k, span in enumerate(m["leaf_records"][i].get("spans", [])):
                idx = tuple(slice(a, b) for a, b in span)
                out[idx] = _read_leaf(self.readers[p], bases[p] + k, dtype,
                                      tuple(b - a for a, b in span))
                filled[idx] = True
        if not bool(filled.all()):
            raise InvalidDataError("blosc: invalid compressed data: sharded leaf has holes")
        return out


def load_leaf_sharded(path_prefix, num_processes: int, key_path: str):
    """Load ONE leaf of a sharded checkpoint, reading only its records.

    Per-process record indices follow from the manifests alone (record 0
    is the manifest; leaf i's records start at 1 + the sum of n of the
    leaves before i in each process's file), so one tensor comes out of a
    large sharded checkpoint by reading each file's manifest and that
    leaf's shard records.
    """
    with _ShardedSet(path_prefix, num_processes) as files:
        node = _walk_manifest(files.metas[0]["tree"], key_path)
        t = node.get("t")
        if t in ("raw", "array0"):
            return _decode(node, None)
        if t not in ("array", "sharded_array"):
            raise KeyError(
                f"checkpoint path {key_path!r} is a {t!r} subtree; "
                "load_leaf_sharded loads single leaves"
            )
        return files.leaf(node, [files.first_record(p, node["i"])
                                 for p in range(num_processes)])


def load_pytree_sharded(path_prefix, num_processes: int):
    """Reassemble a sharded checkpoint from all process files, as CPU
    tensors."""
    with _ShardedSet(path_prefix, num_processes) as files:
        cursors = [1] * num_processes  # per-process record cursors

        def fetch(node):
            t = node["t"]
            if t in ("array", "sharded_array"):
                out = files.leaf(node, cursors)
                for p, m in enumerate(files.metas):
                    cursors[p] += m["leaf_records"][node["i"]]["n"]
                return out
            if t == "dict":
                return {k: fetch(v) for k, v in node["items"]}
            if t == "list":
                return [fetch(v) for v in node["items"]]
            if t == "tuple":
                return tuple(fetch(v) for v in node["items"])
            return _decode(node, None)  # array0, raw, or InvalidDataError

        return fetch(files.metas[0]["tree"])
