"""The rle strategy of compress_array: run scan on the device, LZ4
streams written on the host from run records.

Counterpart: ``_compress_array_rle`` (``tpu_blosc/device.py:1087-1225``)
with its device programs ``_device_filter_seg_counts`` and
``_device_rows_rle`` (:165-207, here filters/rle.py over csrc/rle.cu) and
``_device_rows_gather`` (:210-213, here match.gather_rows).

Each full block is filtered on the tensor's device and seen as ts segments
of seg = bs/ts bytes (under byte shuffle, one byte plane each).  The
device counts each segment's runs.  Segments with at most max(seg/40, 64)
runs are "sparse": they cross to the host as (byte, length) records, the
others as bytes.  The host writes an LZ4 stream straight from the records
for blocks whose segments are all sparse, and rebuilds and re-encodes the
others.  The frames are valid LZ4 frames but not the host encoder's; they
equal tpu_blosc's rle frames byte for byte.

The JAX package pads the row list and the records to shape buckets for its
compiler; none of it changes a byte, and the port does none of it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import filters
from . import match as _match
from .chunk import ENTRY_MEMCPY, native_pipeline_codec, split_header
from .filters import rle as _frle
from .native import backend as _nb
from .options import Options


def sparse_rows(counts: np.ndarray, seg: int) -> np.ndarray:
    """Which segments ship as records: about 5 bytes a run, so at most
    max(seg/40, 64) runs undercut the segment's bytes by about 8x."""
    return counts <= max(seg // 40, 64)


def run_records(segs: torch.Tensor, sparse_idx: np.ndarray, counts: np.ndarray):
    """(vals, lens, rec_first) of the rows ``sparse_idx``: the runs'
    bytes and lengths on the host, and the first record of each row (one
    entry more than rows): one device scan, two copies."""
    vals, lens = _frle.rows_rle(segs, sparse_idx, counts[sparse_idx])
    rec_first = np.zeros(sparse_idx.size + 1, dtype=np.int64)
    np.cumsum(counts[sparse_idx], out=rec_first[1:])
    return vals.cpu().numpy(), lens.cpu().numpy().astype(np.int64), rec_first


def emit_sparse_blocks(block_size: int, nb_full: int, ts: int, sparse: np.ndarray,
                       sparse_idx: np.ndarray, vals: np.ndarray, lens: np.ndarray,
                       rec_first: np.ndarray):
    """(payloads, entries, rest): a block whose segments are all sparse
    is written by the native emitter from its records, and kept when the
    stream is at most 1/16 of the block; ``rest`` lists the other blocks,
    whose payloads and entries are still empty."""
    seg_sparse = sparse.reshape(nb_full, ts)
    payloads: list[bytes] = [b""] * nb_full
    entries = [0] * nb_full
    rest = []
    for blk in range(nb_full):
        if seg_sparse[blk].all():
            j0 = int(np.searchsorted(sparse_idx, blk * ts))
            a, b = rec_first[j0], rec_first[j0 + ts]
            stream = _nb.lz4_emit_runs(vals[a:b], lens[a:b], block_size)
            if len(stream) <= block_size // 16:
                payloads[blk] = stream
                entries[blk] = len(stream)
                continue
        rest.append(blk)
    return payloads, entries, rest


def rebuild_blocks(rest: list[int], ts: int, seg: int, sparse: np.ndarray,
                   sparse_idx: np.ndarray, vals: np.ndarray, lens: np.ndarray,
                   rec_first: np.ndarray, dense_idx: np.ndarray,
                   dense: np.ndarray | None) -> np.ndarray:
    """The filtered bytes of the blocks ``rest`` on the host, one row a
    segment: sparse segments repeated from their records, dense ones
    placed.  (The JAX package rebuilds every block, those it has emitted
    too; the frame reads only these.)"""
    buf = np.empty((len(rest) * ts, seg), dtype=np.uint8)
    for i, blk in enumerate(rest):
        for t in range(ts):
            s = blk * ts + t
            if sparse[s]:
                j = np.searchsorted(sparse_idx, s)
                a, b = rec_first[j], rec_first[j + 1]
                buf[i * ts + t] = np.repeat(vals[a:b], lens[a:b])
            else:
                buf[i * ts + t] = dense[np.searchsorted(dense_idx, s)]
    return buf


def encode_blocks(opts: Options, block_size: int, rest: list[int], blocks: np.ndarray,
                  payloads: list, entries: list) -> None:
    """Fill in the payloads and entries of the blocks ``rest`` from their
    filtered bytes ``blocks`` with the native codec; a block it stores raw
    is unfiltered back to the tensor's bytes."""
    ts = opts.type_size
    native_codec, depth = native_pipeline_codec(opts.codec, opts.level)
    slots, slot, sizes, memcpy_flags = _nb.compress_slots(
        blocks, block_size, ts, 0, native_codec, depth, num_threads=opts.num_threads,
    )
    for j, blk in enumerate(rest):
        payload = slots[j * slot : j * slot + sizes[j]]
        if memcpy_flags[j]:
            payloads[blk] = filters.unfilter_bytes(payload, ts, opts.shuffle).tobytes()
            entries[blk] = ENTRY_MEMCPY | block_size
        else:
            payloads[blk] = payload.tobytes()
            entries[blk] = len(payload)


def compress_array_rle(flat: torch.Tensor, opts: Options, nb_full: int,
                       block_size: int) -> bytes | None:
    """The rle strategy over the flat uint8 tensor ``flat``; None when
    the geometry or the data does not suit it (the caller then takes the
    transfer route): a block not a whole number of elements, no sparse
    segment, or under 1/8 of the bytes in sparse segments."""
    ts = opts.type_size
    if block_size % ts:
        return None
    seg = block_size // ts
    nseg = nb_full * ts
    body = nb_full * block_size
    segs = filters.filter_blocks(flat[:body].view(nb_full, block_size), ts,
                                 opts.shuffle).view(nseg, seg)
    counts = _frle.seg_run_counts(segs).cpu().numpy().astype(np.int64)

    sparse = sparse_rows(counts, seg)
    sparse_idx = np.flatnonzero(sparse)
    dense_idx = np.flatnonzero(~sparse)
    if sparse_idx.size == 0 or sparse_idx.size * seg < (nseg * seg) // 8:
        return None

    vals, lens, rec_first = run_records(segs, sparse_idx, counts)
    dense = _match.gather_rows(segs, dense_idx) if dense_idx.size else None
    payloads, entries, rest = emit_sparse_blocks(block_size, nb_full, ts, sparse, sparse_idx,
                                                 vals, lens, rec_first)
    if rest:
        blocks = rebuild_blocks(rest, ts, seg, sparse, sparse_idx, vals, lens, rec_first,
                                dense_idx, dense)
        encode_blocks(opts, block_size, rest, blocks, payloads, entries)
    tail = flat[body:].cpu().numpy()
    if tail.size:
        payload, entry = _match.tail_payload(tail, opts)
        payloads.append(payload)
        entries.append(entry)
    prefix = split_header(opts, body + tail.size, block_size, entries,
                          sum(len(p) for p in payloads))
    return prefix + b"".join(payloads)
