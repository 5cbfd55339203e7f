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
1-deep pipeline, leaf k+1's filter on the device and copy to the host
(_compress_array_stage1) on a worker thread while this thread runs leaf
k's host codec and file write (_compress_array_stage2), the two halves of
compress_array, so the frames are compress_array's by construction.  CPU
tensors and NumPy arrays are "host" records, compressed in batches of up
to _BATCH_WINDOW_BYTES.  A load onto a device takes its leaves in
windows of consecutive records of at most _BATCH_WINDOW_BYTES: one worker
thread reads window w+1 with one read, another decodes window w into one
slab (the single-block frames in one native batch call, multi-block
frames that share codec, filter, type size and block size in one native
block call), while this thread copies window w-1's leaves to the device.
For a CUDA device the read buffers and slabs are page-locked buffers of
torch's caching host allocator (device._host_buffer), each leaf's copy is
queued on the stream without waiting for it, and a slab goes back to the
allocator, which hands it out again only once those copies have run,
when its last leaf is dropped.

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

import json
from dataclasses import dataclass

import numpy as np
import torch

from . import device as _device
from . import dtypes
from .api import (
    _checked_header,
    _decode_native_map,
    _is_container,
    compress_batch_with_options,
    decompress_into,
)
from .chunk import checked_payloads, native_pipeline_codec, parse_block_table
from .device import (
    _compress_array_stage1,
    _compress_array_stage2,
    _pins,
    checked_decode_size,
    host_decode,
    tensor_bytes,
)
from .errors import DecompressionFailedError, InvalidDataError
from .filters import load_target
from .format import FLAG_SPLIT, FORMAT_VERSION, HEADER_SIZE
from .native import backend as _nb
from .options import Options
from .stats import span
from .stream import DICT_MAGIC, StreamReader, StreamWriter, _iter_prefetch

_MANIFEST_VERSION = 1

# Host leaves compress in batches of about this many bytes: one native
# call per element size in a window, peak memory about a window; a load
# onto a device decodes its leaves in windows of at most this many bytes
_BATCH_WINDOW_BYTES = 64 * 1024 * 1024

# every leaf of a load's window starts at a multiple of this in its slab,
# so that any dtype can view it
_SLAB_ALIGN = 64

# what load_pytree's pipeline (a device load, strategy "transfer" or
# "auto") restored since the last reset_restored(): leaves, their tensor
# bytes, the leaves whose record is a multi-block frame, and the windows
# the leaves were decoded in
restored = {"leaves": 0, "bytes": 0, "multi_block_leaves": 0, "windows": 0}


def reset_restored() -> None:
    for name in restored:
        restored[name] = 0


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


def _write_leaf_records(w: StreamWriter, records, opts: Options | None,
                        strategy: str = "transfer") -> None:
    """Write ("host", leaf) and ("device", CUDA tensor) records, in order
    (≙ tpu_blosc/checkpoint.py:114-196)."""
    base = opts if opts is not None else Options()
    pending: list[tuple[np.ndarray, int]] = []
    pending_bytes = 0

    def flush():
        nonlocal pending, pending_bytes
        by_ts: dict[int, list[int]] = {}
        for k, (_, itemsize) in enumerate(pending):
            by_ts.setdefault(itemsize, []).append(k)
        frames: dict[int, bytes] = {}
        for itemsize, idxs in by_ts.items():
            batch = compress_batch_with_options([pending[k][0] for k in idxs],
                                                _leaf_opts(base, itemsize))
            frames.update(zip(idxs, batch))
        for k in range(len(pending)):
            w.write_frame(frames[k])
        pending, pending_bytes = [], 0

    def write_device_run(run: list[torch.Tensor]):
        def stage1(t: int):
            return _compress_array_stage1(run[t], _leaf_opts(base, run[t].element_size()),
                                          strategy)

        if len(run) == 1:
            w.write_frame(_compress_array_stage2(stage1(0)))
            return
        for staged in _iter_prefetch(stage1, len(run), prefetch=1):
            w.write_frame(_compress_array_stage2(staged))

    records = list(records)
    i, n_rec = 0, len(records)
    while i < n_rec:
        kind, data = records[i]
        if kind == "host":
            buf = _host_bytes(data)
            pending.append(buf)
            pending_bytes += buf[0].nbytes
            if pending_bytes >= _BATCH_WINDOW_BYTES:
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
    """
    from .dist import _group, _sharded

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
    with StreamWriter(path, opts, checksum=checksum) as w:
        w.write(manifest, Options(type_size=1))
        _write_leaf_records(
            w,
            (("device" if _on_cuda(lf) else "host", lf) for lf in leaves),
            opts,
            strategy=strategy,
        )


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

    ``strategy`` goes to decompress_array for each leaf of a device load;
    "transfer" and "auto" decode on the host with a prefetch pipeline and
    copy each leaf once; "device", "rle" and "records" decode each leaf
    through decompress_array's strategy of that name.

    While a profiler records, the call is the span ``tpbt.load_pytree``
    (``stats.span``), with the stages ``tpbt.load_pytree.manifest``
    (opening the file, its manifest and the leaf specs) and, on the
    pipeline, ``tpbt.load_pytree.wait`` (this thread waiting for the
    workers' next decoded window) and ``tpbt.load_pytree.h2d`` (a leaf's
    copy to the target device), all on the calling thread.  The pipeline
    counts what it restores in ``restored``.
    """
    with span("tpbt.load_pytree"):
        target = load_target(device, "load_pytree")
        with span("tpbt.load_pytree.manifest"):
            r, meta, specs = _open_checkpoint(path)
        with r:
            return _load_tree(r, meta, specs, target, strategy)


def _load_tree(r: StreamReader, meta: dict, specs: dict | None, target, strategy: str):
    """load_pytree's body over an open reader."""
    ready: dict[int, torch.Tensor] = {}
    dev_gen = None
    pinned = target is not None and _pins(target)
    if target is not None and strategy in ("transfer", "auto") and specs is not None:
        # two workers: one reads window w + 1 while the other decodes
        # window w, and this thread copies window w - 1's leaves out
        windows = _windows([_spec_nbytes(*specs[i]) for i in range(meta["leaves"])])
        reads = _iter_prefetch(
            lambda w: r.read_frames(windows[w][0] + 1, windows[w][1] + 1,
                                    lambda n: _device._host_buffer(n, pinned).numpy()),
            len(windows), prefetch=1,
        )

        def decode(w: int):
            try:
                return _decode_window(r, windows[w][0], next(reads), specs, pinned)
            except BaseException:
                reads.close()  # the reader stops too, and frees what it holds
                raise

        dev_gen = _iter_prefetch(decode, len(windows), prefetch=1)
    elif target is None and specs is not None:
        # decode straight into tensors allocated from the manifest, for
        # the leaves whose size agrees with their record's own header
        # (a forged manifest must not drive the allocations)
        for i, (dtype, shape) in specs.items():
            nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
            try:
                if r.peek_size(i + 1) == nbytes:
                    ready[i] = torch.empty(shape, dtype=dtype)
            except (InvalidDataError, MemoryError, RuntimeError):
                continue  # the per-leaf path raises the typed error
        order = sorted(ready)
        counts = r.read_many_into(
            [i + 1 for i in order], [tensor_bytes(ready[i]).numpy() for i in order]
        )
        for i, c in zip(order, counts):
            if c != ready[i].numel() * ready[i].element_size():
                del ready[i]

    produced: dict[int, tuple[torch.Tensor, bool]] = {}

    def fetch(i: int, dtype: torch.dtype, shape: tuple):
        if dev_gen is not None:
            # windows arrive in index order; a manifest may walk the
            # leaves in another, so buffer until leaf i is there
            while i not in produced:
                with span("tpbt.load_pytree.wait"):
                    window = next(dev_gen)
                restored["windows"] += 1
                for k, host, split in window:
                    produced[k] = host, split
            host, split = produced.pop(i)
            with span("tpbt.load_pytree.h2d"):
                # copy=True: a CPU target's leaf must not share the slab
                out = host.to(target, non_blocking=pinned, copy=True)
            restored["leaves"] += 1
            restored["bytes"] += host.nbytes
            restored["multi_block_leaves"] += split
            return out
        if target is not None:
            return r.read_array(i + 1, dtype, shape=shape, device=target,
                                strategy=strategy)
        got = ready.get(i)
        return got if got is not None else _read_leaf(r, i + 1, dtype, shape)

    return _decode(meta["tree"], fetch, target)


# ---------------------------------------------------------------------------
# a device load's windows: the prefetch worker reads the records of a run
# of leaves with one read and decodes them into one slab of host memory
# (page-locked for a CUDA target), in as few native calls as it can
# ---------------------------------------------------------------------------


def _aligned(n: int) -> int:
    return -(-n // _SLAB_ALIGN) * _SLAB_ALIGN


def _spec_nbytes(dtype: torch.dtype, shape: tuple) -> int:
    """A leaf's bytes by the manifest; -1 where its shape is none."""
    try:
        return dtype.itemsize * int(np.prod(shape, dtype=np.int64))
    except (TypeError, ValueError):
        return -1


def _windows(sizes: list[int]) -> list[tuple[int, int]]:
    """[lo, hi) runs of consecutive leaves whose sizes, each rounded up to
    _SLAB_ALIGN, add up to at most _BATCH_WINDOW_BYTES; a larger leaf is a
    window by itself."""
    runs, lo, total = [], 0, 0
    for i, n in enumerate(sizes):
        if i > lo and total + _aligned(n) > _BATCH_WINDOW_BYTES:
            runs.append((lo, i))
            lo, total = i, 0
        total += _aligned(n)
    if sizes:
        runs.append((lo, len(sizes)))
    return runs


@dataclass
class _Leaf:
    """A leaf of a window and how it is decoded.  ``frame`` is its record,
    a view of the window's read buffer (or read_frame's bytes).  Route
    "own": into a buffer of its own, as a leaf alone would be (a
    dictionary record, a container, a header whose size the manifest does
    not give); else into the slab at ``at``: "frames", with the window's
    other single-block frames in one batch call; "blocks", a multi-block
    frame in a native block decode that ``key`` (native codec, filter,
    type size, block size) may share, its ``payloads`` (offsets in the
    read buffer, sizes, raw flags); "scalar", through decompress_into,
    which also decodes again (``redo``) a leaf whose batch call failed."""

    i: int
    frame: np.ndarray
    dtype: torch.dtype
    shape: tuple
    route: str = "own"
    n: int = 0
    key: tuple = ()
    payloads: tuple = ()
    at: int = 0
    redo: bool = False


def _plan_leaf(leaf: _Leaf, buf: np.ndarray) -> None:
    """The leaf's route and size, from its frame's header, which is
    checked as decompress_into checks it, with its errors."""
    frame = leaf.frame
    if bytes(frame[:4]) == DICT_MAGIC or _is_container(bytes(frame[:4])):
        return
    leaf.n = checked_decode_size(bytes(frame[:HEADER_SIZE]), leaf.dtype)
    if leaf.n != _spec_nbytes(leaf.dtype, leaf.shape):
        return  # the view as the manifest's shape refuses it
    if not frame[2] & FLAG_SPLIT:
        leaf.route = "frames"
        return
    leaf.route = "scalar"
    header = _checked_header(frame)
    native = native_pipeline_codec(header.codec, 1)
    base = frame.ctypes.data - buf.ctypes.data
    if native is None or not 0 <= base < buf.size:
        return
    entries, offset = parse_block_table(frame, header)
    offsets, psizes, is_memcpy, _ = checked_payloads(frame, header, entries, offset)
    leaf.route = "blocks"
    leaf.key = (native[0], int(header.shuffle_mode), header.type_size, header.block_size)
    leaf.payloads = (offsets + base, psizes, is_memcpy)


def _lay_out(leaves: list[_Leaf]) -> tuple[int, list[list[_Leaf]]]:
    """Place the slab's leaves: (slab bytes, the native block calls).

    Multi-block leaves of one key share a call: those of whole blocks back
    to back, then one whose last block is short, so block k of the call
    lies at k block sizes from its start; each other one with a short
    last block has a call of its own, as has every leaf whose block size
    would leave the next one unaligned."""
    runs: dict[tuple, list[_Leaf]] = {}
    for leaf in leaves:
        if leaf.route == "blocks":
            runs.setdefault(leaf.key, []).append(leaf)
    calls: list[list[_Leaf]] = []
    for (*_, block), members in runs.items():
        if block % _SLAB_ALIGN:
            calls += [[leaf] for leaf in members]
            continue
        ragged = [leaf for leaf in members if leaf.n % block]
        calls.append([leaf for leaf in members if not leaf.n % block] + ragged[:1])
        calls += [[leaf] for leaf in ragged[1:]]
    size = 0
    for call in calls:
        size = _aligned(size)
        for leaf in call:
            leaf.at, size = size, size + leaf.n
    for leaf in leaves:
        if leaf.route in ("frames", "scalar"):
            leaf.at, size = _aligned(size), _aligned(size) + leaf.n
    return size, calls


def _decode_window(r: StreamReader, lo: int, read, specs: dict,
                   pinned: bool) -> list[tuple[int, torch.Tensor, bool]]:
    """The leaves of a window from ``read`` (StreamReader.read_frames' of
    the records of leaves lo and on) as (index, host tensor of the leaf's dtype and shape,
    multi-block frame), decoded into one slab.

    A record that fails its checks ends the window there: the leaves
    before it are decoded first, then its error is raised, the order in
    which a leaf at a time raises."""
    buf, frames, error = read
    leaves: list[_Leaf] = []
    try:
        for i, frame in enumerate(frames, lo):
            leaf = _Leaf(i, frame, *specs[i])
            _plan_leaf(leaf, buf)
            leaves.append(leaf)
    except Exception as exc:  # raised below, after the leaves before it
        error = exc
    size, calls = _lay_out(leaves)
    slab = _device._host_buffer(size, pinned)
    out_u8 = slab.numpy()
    singles = [leaf for leaf in leaves if leaf.route == "frames"]
    counts = (_nb.decompress_frames_into([leaf.frame for leaf in singles],
                                         [out_u8[leaf.at : leaf.at + leaf.n] for leaf in singles],
                                         _decode_native_map())
              if singles and _nb.available() else [None] * len(singles))
    for leaf, count in zip(singles, counts):
        leaf.redo = count is None
    for call in calls:
        codec, mode, ts, block = call[0].key
        offsets, psizes, is_memcpy = (np.concatenate(p) for p in
                                      zip(*(leaf.payloads for leaf in call)))
        try:
            _nb.decompress_blocks(buf, offsets, psizes, is_memcpy, block,
                                  sum(leaf.n for leaf in call), ts, mode, codec,
                                  out_addr=out_u8.ctypes.data + call[0].at)
        except DecompressionFailedError:
            for leaf in call:
                leaf.redo = True  # decompress_into raises the leaf's own error
    decoded = []
    for leaf in leaves:
        frame = leaf.frame
        if leaf.route == "own":
            raw = bytes(frame)
            if raw[:4] == DICT_MAGIC:
                host = torch.frombuffer(bytearray(r._decode_dict_record(raw)),
                                        dtype=torch.uint8)
            else:
                host = host_decode(raw, checked_decode_size(raw, leaf.dtype), pinned)
        else:
            host = slab[leaf.at : leaf.at + leaf.n]
            if leaf.redo or leaf.route == "scalar":
                decompress_into(bytes(frame), host.numpy())
        split = frame[0] == FORMAT_VERSION and bool(frame[2] & FLAG_SPLIT)
        decoded.append((leaf.i, host.view(leaf.dtype).reshape(leaf.shape), split))
    if error is not None:
        raise error
    return decoded


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
    all files.
    """
    from .dist import _group
    from .dist._sharded import shard_span

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
        span, writer = shard_span(obj)
        local = obj.to_local()
        if tuple(local.shape) != tuple(b - a for a, b in span):
            raise ValueError(
                f"a DTensor's local shard is {tuple(local.shape)}, its placements "
                f"{obj.placements} give the span {span}"
            )
        # an empty shard (uneven split) and a replica are no record
        spans = [span] if writer and local.numel() else []
        manifest_leaves.append({"k": "sharded", "n": len(spans), "spans": spans})
        if spans:
            records.append(("device" if _on_cuda(local) else "host", local))

    manifest = json.dumps({
        "version": _MANIFEST_VERSION,
        "tree": skeleton,
        "leaf_records": manifest_leaves,
        "process": pid,
    }).encode()
    with StreamWriter(f"{path_prefix}.p{pid}.tpbs", opts, checksum=checksum) as w:
        w.write(manifest, Options(type_size=1))
        _write_leaf_records(w, records, opts)


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
