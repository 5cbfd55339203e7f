"""One frame from several processes, each compressing its slice.

Counterpart: ``tpu_blosc/dist/multihost.py``.  Each process filters and
compresses the blocks of its contiguous slice of the global byte stream
on its host cores, the per-block sizes and payloads are exchanged with
``torch.distributed`` all-gathers (on ``comm_device()``: NCCL on the
CUDA device, Gloo on the CPU), and every process assembles the identical
frame in header order.  Frames are byte-identical to
``chunk.compress_chunked``'s for every process count.

Every process calls with the same global metadata:

    frame = compress_chunked_multihost(global_n, my_slice_bytes, opts)

where process p owns global bytes ``process_slice(global_n, block_size,
p, num_processes)``.  Start the group first with
``dist.initialize_distributed``; with no group there is one process.
"""

from __future__ import annotations

import struct
import time

import numpy as np
import torch

from .. import chunk as _chunk
from ..errors import InvalidCodecError, InvalidDataError
from ..format import HEADER_SIZE, Header, parse_header
from ..native import backend as _nb
from ..options import Options
from . import _group


def process_slice(global_n: int, block_size: int, process_id: int,
                  num_processes: int) -> tuple[int, int]:
    """The [start, end) byte range process p owns: contiguous runs of
    whole blocks, remainder blocks to the leading processes."""
    nb = -(-global_n // block_size)
    per = nb // num_processes
    extra = nb % num_processes
    first = process_id * per + min(process_id, extra)
    count = per + (1 if process_id < extra else 0)
    start = min(first * block_size, global_n)
    end = min((first + count) * block_size, global_n)
    return start, end


def slot_payloads(slots: np.ndarray, slot: int, sizes: np.ndarray,
                  memcpy_flags: np.ndarray) -> tuple[list[bytes], list[bool]]:
    """``compress_slots``' output as a list of payloads and their memcpy
    flags."""
    payloads = [slots[i * slot : i * slot + int(s)].tobytes() for i, s in enumerate(sizes)]
    return payloads, [bool(m) for m in memcpy_flags]


def _compress_local_blocks(local, block_size: int, opts: Options):
    """Filter and compress this process's blocks in one native call."""
    native = _chunk.native_pipeline_codec(opts.codec, opts.level)
    if native is None:
        raise InvalidCodecError(f"blosc: unsupported codec: {opts.codec}")
    if len(local) == 0:  # more processes than blocks
        return [], []
    native_codec, depth = native
    return slot_payloads(*_nb.compress_slots(
        local, block_size, opts.type_size, int(opts.shuffle), native_codec, depth,
        num_threads=opts.num_threads,
    ))


def allgather_payloads(payloads: list[bytes], memf: list[bool],
                       group=None) -> tuple[list[bytes], list[bool]]:
    """Ordered all-gather of per-block compressed payloads across
    processes: every process contributes its blocks in local order and
    receives the global list in process order, which is header order.

    Three exchanges: the block counts; the sizes (int64, padded with -1
    to the largest count) with the memcpy flags; the payload bytes (uint8,
    padded to the largest blob).  A process with no block sends a count of
    0 and padding only.  One process returns its input.
    """
    num_processes = _group.world_size(group)
    if num_processes == 1:
        return list(payloads), list(memf)
    n_local = len(payloads)
    counts = _group.all_gather_rows(torch.tensor([n_local], dtype=torch.int64), group).cpu()
    max_blocks = max(int(counts.max()), 1)
    table = np.zeros((2, max_blocks), dtype=np.int64)
    table[0] = -1
    table[0, :n_local] = [len(p) for p in payloads]
    table[1, :n_local] = memf
    tables = _group.all_gather_rows(torch.from_numpy(table)[None], group).cpu().numpy()
    sizes_all = tables[:, 0]
    blob_len = np.where(sizes_all >= 0, sizes_all, 0).sum(axis=1)
    padded_blob = np.zeros(max(int(blob_len.max()), 1), dtype=np.uint8)
    local_blob = np.frombuffer(b"".join(payloads), dtype=np.uint8)
    padded_blob[: local_blob.size] = local_blob
    blobs = _group.all_gather_rows(torch.from_numpy(padded_blob)[None], group).cpu().numpy()
    all_payloads: list[bytes] = []
    all_memf: list[bool] = []
    for p in range(num_processes):
        off = 0
        for k in range(int(counts[p])):
            sz = int(sizes_all[p, k])
            all_payloads.append(blobs[p, off : off + sz].tobytes())
            all_memf.append(bool(tables[p, 1, k]))
            off += sz
    return all_payloads, all_memf


def assemble_payload_frame(opts: Options, n: int, block_size: int,
                           payloads: list[bytes], memf: list[bool]) -> bytes:
    """The FLAG_SPLIT frame of ``n`` bytes whose blocks are ``payloads``,
    in order (``chunk.split_header`` checks the uint32 fields)."""
    entries = [len(p) | (_chunk.ENTRY_MEMCPY if m else 0) for p, m in zip(payloads, memf)]
    prefix = _chunk.split_header(opts, n, block_size, entries, sum(len(p) for p in payloads))
    return prefix + b"".join(payloads)


def compress_chunked_multihost(global_n: int, local_data, opts: Options,
                               stats: dict | None = None, group=None) -> bytes:
    """Compress a globally-sharded byte stream into one FLAG_SPLIT frame.

    Every process passes the same ``global_n`` and its own slice (see
    process_slice); all processes return the identical frame.

    ``stats``, when given, receives this process's work-division record:
    process, num_processes, local_bytes, global_bytes, local_blocks,
    local_compress_s (the parallel phase) and gather_s (the collective,
    which includes waiting for stragglers).
    """
    opts = opts.clamped()
    if global_n <= 0:
        raise InvalidDataError("blosc: invalid compressed data: empty input")
    block_size = _chunk.choose_block_size(global_n, opts.type_size, opts.block_size)
    num_processes = _group.world_size(group)
    pid = _group.rank(group)
    start, end = process_slice(global_n, block_size, pid, num_processes)
    local = bytes(local_data)
    if len(local) != end - start:
        raise InvalidDataError(
            f"blosc: process {pid} slice is {len(local)} bytes, "
            f"expected {end - start}"
        )

    t0 = time.perf_counter()
    payloads, memf = _compress_local_blocks(local, block_size, opts)
    t1 = time.perf_counter()
    all_payloads, all_memf = allgather_payloads(payloads, memf, group)
    if stats is not None:
        stats.update(
            process=pid,
            num_processes=num_processes,
            local_bytes=len(local),
            global_bytes=global_n,
            local_blocks=len(payloads),
            local_compress_s=t1 - t0,
            gather_s=time.perf_counter() - t1,
        )
    return assemble_payload_frame(opts, global_n, block_size, all_payloads, all_memf)


def decompress_chunked_multihost(frame, group=None) -> tuple[bytes, int, int]:
    """Decompress THIS process's slice of a FLAG_SPLIT frame.

    Every process receives the full frame, but each decodes only the
    blocks of its contiguous slice (the process_slice partition
    compress_chunked_multihost uses), so per-process work is n/P with no
    traffic between processes.

    Returns (local_bytes, start, end): the decoded slice and its global
    byte range.  With one process this is (decompress(frame), 0, n).
    """
    from ..api import decompress

    raw = bytes(frame)
    header = parse_header(raw)
    if not header.is_split:
        out = decompress(raw)
        return out, 0, len(out)
    entries, offset = _chunk.parse_block_table(raw, header)
    n = header.nbytes_orig
    block_size = header.block_size
    _chunk.validate_block_layout(n, block_size, len(entries))

    start, end = process_slice(n, block_size, _group.rank(group), _group.world_size(group))
    first_blk = start // block_size
    last_blk = -(-end // block_size)  # exclusive
    if first_blk >= last_blk:
        return b"", start, start

    # re-frame the local blocks as a FLAG_SPLIT frame of their own and
    # decode it with the whole-frame native decoder
    local_entries = entries[first_blk:last_blk]
    sizes = [s for s, _ in entries]
    pay_start = offset + sum(sizes[:first_blk])
    pay_end = pay_start + sum(sizes[first_blk:last_blk])
    table = struct.pack(
        f"<I{len(local_entries)}I", len(local_entries),
        *[s | (_chunk.ENTRY_MEMCPY if m else 0) for s, m in local_entries],
    )
    sub_header = Header(
        version=header.version,
        version_lz=header.version_lz,
        flags=header.flags,
        type_size=header.type_size,
        nbytes_orig=end - start,
        block_size=block_size,
        nbytes_comp=HEADER_SIZE + len(table) + (pay_end - pay_start),
    )
    return decompress(sub_header.to_bytes() + table + raw[pay_start:pay_end]), start, end
