"""The match strategy of compress_array: match discovery on the device,
LZ4 streams written on the host from literal records.

Counterpart: ``tpu_blosc/device.py``: ``_match_offsets`` (:230-245), the
count phase and the literal-mask stage of ``_device_match_core_fused``
(:277-349) and ``_device_match_core`` (:352-444), the monolithic plan of
``_fetch_match_records`` (:558-578) with ``_device_gather_vals``
(:463-467) and ``_device_rows_gather`` (:210-213), ``_filter_host`` and
``_unfilter_host`` (:879-890, here filters.filter_bytes and
unfilter_bytes), ``_reconstruct_match_row`` (:893-916) and
``_compress_array_match`` (:919-1084).

Each full block is filtered on the tensor's device with the pair
``opts.shuffle`` names (byte or bit shuffle) and seen as ts segments of
seg = bs/ts bytes (under byte shuffle, one byte plane each).  Per segment the
device picks the candidate offset d with the most equal bytes x[p] ==
x[p-d] (the count kernel), then builds the literal mask by an opening of
the equality runs (the mask kernel; both in filters/match.py, over
csrc/match.cu).
Segments with at most seg/10 literals are "sparse": only their literal
positions and bytes cross to the host.  The host writes an LZ4 stream
straight from the records for blocks whose segments are all sparse, and
rebuilds and re-encodes the others.  The frames are valid LZ4 frames but
not the host encoder's; they equal tpu_blosc's match frames byte for
byte.

The JAX package ships the positions as u16 deltas, overlaps the fetch
with a thread and pads to shape buckets, all for its TPU link; none of
it changes a byte, and the port does none of it.  Where the mask's
popcount and the positions disagree the JAX package quietly takes the
transfer route; here that can only be a fault in the kernel, so it
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import filters
from .chunk import ENTRY_MEMCPY, native_pipeline_codec, split_header
from .filters import match as _fmatch
from .native import backend as _nb
from .options import Options


def match_offsets(seg: int) -> tuple[int, ...]:
    """Candidate match offsets below ``seg``: powers of two and three
    times powers of two, up to 1024."""
    return tuple(
        d
        for d in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96,
                  128, 192, 256, 384, 512, 768, 1024)
        if d < seg
    )


def literal_mask(segs: torch.Tensor, row_d: torch.Tensor):
    """(lit_counts, packed) of ``segs`` at the offsets ``row_d``:
    lit_counts[r] is row r's literal count (int32), and packed (nseg,
    seg/8) holds bit i of byte j = byte 8j+i is literal, zeroed on rows
    with more than seg/10 literals."""
    seg = segs.shape[1]
    if seg % 8:
        # tpu_blosc's bit-pack fails on the same geometry, with a
        # TypeError; compress_array never gives it (blocks are a
        # multiple of 8 * ts)
        raise TypeError(f"the match mask packs 8 bytes a bit-byte; seg={seg} % 8 != 0")
    lit_counts, packed = _fmatch.literal_mask(segs, row_d)
    packed.masked_fill_((lit_counts > seg // 10)[:, None], 0)
    return lit_counts, packed


def match_core(segs: torch.Tensor, offsets: tuple[int, ...]):
    """(best, lit_counts, packed) of filtered segments, as
    ``_device_match_core`` returns them (without the segments)."""
    best = _fmatch.count_best(segs, offsets)
    offs = _fmatch.kernels.offsets_tensor(tuple(offsets), segs.device)
    return (best, *literal_mask(segs, offs[best]))


def gather_values(segs: torch.Tensor, pos: np.ndarray) -> np.ndarray:
    """The bytes of ``segs`` at flat positions ``pos``: one upload, one
    gather on the device, one copy back."""
    index = torch.from_numpy(pos).to(segs.device)
    return segs.view(-1).index_select(0, index).cpu().numpy()


def gather_rows(segs: torch.Tensor, rows: np.ndarray) -> np.ndarray:
    """Rows ``rows`` of ``segs`` on the host: one gather, one copy."""
    index = torch.from_numpy(rows).to(segs.device)
    return segs.index_select(0, index).cpu().numpy()


def literal_records(segs: torch.Tensor, packed: torch.Tensor, n_real: int):
    """(positions, bytes) of the ``n_real`` literals the packed mask
    marks: one copy of the mask to the host, the native position scan,
    then gather_values."""
    pos = _nb.mask_positions(packed.cpu().numpy().reshape(-1), n_real)
    if pos is None or pos.size != n_real:
        found = "more" if pos is None else pos.size
        raise RuntimeError(
            f"match mask holds {found} literals, its row counts {n_real}"
        )
    return pos, gather_values(segs, pos)


def reconstruct_match_row(seg: int, d: int, rel_pos: np.ndarray,
                          vals: np.ndarray) -> np.ndarray:
    """A filtered row from its literal records: out[i] is the literal at
    i, else out[i-d].  Positions below d are always literal."""
    if d == 1:
        row = np.zeros(seg, np.uint8)
        row[rel_pos] = vals
        idx = np.zeros(seg, np.int64)
        idx[rel_pos] = rel_pos
        np.maximum.accumulate(idx, out=idx)
        return row[idx]
    m = -(-seg // d)
    row = np.zeros(m * d, np.uint8)
    row[rel_pos] = vals
    mask = np.zeros(m * d, bool)
    mask[rel_pos] = True
    idxm = np.where(mask.reshape(m, d), np.arange(m)[:, None], 0)
    np.maximum.accumulate(idxm, axis=0, out=idxm)
    out = np.take_along_axis(row.reshape(m, d), idxm, axis=0).reshape(-1)
    return out[:seg]


def emit_blocks(opts: Options, seg: int, block_size: int, nb_full: int,
                d_all: np.ndarray, sparse: np.ndarray, pos: np.ndarray,
                vals: np.ndarray, dense_idx: np.ndarray, dense: np.ndarray | None):
    """(payloads, entries) of the full blocks.  A block whose rows are all
    sparse is written by the native emitter from its records; the others
    are rebuilt on the host and re-encoded by the native codec."""
    ts = opts.type_size
    native_codec, depth = native_pipeline_codec(opts.codec, opts.level)
    # records of block b: pos[block_first[b]:block_first[b+1]]; of row s:
    # pos[row_first[s]:row_first[s+1]] (dense rows have none)
    block_first = np.searchsorted(pos, np.arange(nb_full + 1, dtype=np.int32) * block_size)
    row_first = np.searchsorted(pos, np.arange(d_all.size + 1, dtype=np.int32) * seg)
    row_sparse = sparse.reshape(nb_full, ts)
    payloads: list[bytes] = [b""] * nb_full
    entries = [0] * nb_full
    rebuild = []
    for blk in range(nb_full):
        if row_sparse[blk].all():
            a, b = block_first[blk], block_first[blk + 1]
            stream = _nb.lz4_emit_mixed(
                pos[a:b] - blk * block_size, vals[a:b],
                d_all[blk * ts : (blk + 1) * ts], seg, block_size,
                cap=block_size // 4,
            )
            if stream is not None:
                payloads[blk] = stream
                entries[blk] = len(stream)
                continue
        rebuild.append(blk)
    if not rebuild:
        return payloads, entries

    parts = []
    for blk in rebuild:
        for s in range(blk * ts, (blk + 1) * ts):
            if sparse[s]:
                a, b = row_first[s], row_first[s + 1]
                parts.append(reconstruct_match_row(seg, int(d_all[s]), pos[a:b] - s * seg, vals[a:b]))
            else:
                parts.append(dense[np.searchsorted(dense_idx, s)])
    slots, slot, sizes, memcpy_flags = _nb.compress_slots(
        np.concatenate(parts), block_size, ts, 0, native_codec, depth,
        num_threads=opts.num_threads,
    )
    for j, blk in enumerate(rebuild):
        payload = slots[j * slot : j * slot + sizes[j]]
        if memcpy_flags[j]:
            payloads[blk] = filters.unfilter_bytes(payload, ts, opts.shuffle).tobytes()
            entries[blk] = ENTRY_MEMCPY | block_size
        else:
            payloads[blk] = payload.tobytes()
            entries[blk] = len(payload)
    return payloads, entries


def tail_payload(tail: np.ndarray, opts: Options) -> tuple[bytes, int]:
    """(payload, entry) of the ragged tail: the host filter, then one LZ4
    or LZ4HC block, or the raw bytes when that does not shrink it."""
    depth = native_pipeline_codec(opts.codec, opts.level)[1]
    comp = _nb.lz4_compress(filters.filter_bytes(tail, opts.type_size, opts.shuffle), depth)
    if len(comp) >= tail.size:
        return tail.tobytes(), ENTRY_MEMCPY | tail.size
    return comp, len(comp)


def compress_array_match(flat: torch.Tensor, opts: Options, nb_full: int,
                         block_size: int) -> bytes | None:
    """The match strategy over the flat uint8 tensor ``flat``; None when
    the geometry or the data does not suit it (the caller then takes the
    transfer route): a block not a whole number of elements, segments
    under 256 bytes, 2 GiB or more of full blocks (positions are int32),
    or under 1/8 of the bytes in sparse rows."""
    ts = opts.type_size
    if block_size % ts:
        return None
    seg = block_size // ts
    body = nb_full * block_size
    if seg < 256 or body >= 2**31:
        return None
    offsets = match_offsets(seg)
    segs = filters.filter_blocks(flat[:body].view(nb_full, block_size), ts,
                                 opts.shuffle).view(-1, seg)
    best, lit_counts, packed = match_core(segs, offsets)
    lit_counts = lit_counts.cpu().numpy().astype(np.int64)
    d_all = np.asarray(offsets, dtype=np.int32)[best.cpu().numpy()]
    nseg = d_all.size

    # a record row ships about 5 bytes a literal: a 2x margin over bytes
    sparse = lit_counts <= seg // 10
    dense_idx = np.flatnonzero(~sparse)
    if np.count_nonzero(sparse) * seg < (nseg * seg) // 8:
        return None

    pos, vals = literal_records(segs, packed, int(lit_counts[sparse].sum()))
    dense = gather_rows(segs, dense_idx.astype(np.int32)) if dense_idx.size else None
    payloads, entries = emit_blocks(
        opts, seg, block_size, nb_full, d_all, sparse, pos, vals, dense_idx, dense
    )
    tail = flat[body:].cpu().numpy()
    if tail.size:
        payload, entry = tail_payload(tail, opts)
        payloads.append(payload)
        entries.append(entry)
    prefix = split_header(opts, body + tail.size, block_size, entries,
                          sum(len(p) for p in payloads))
    return prefix + b"".join(payloads)
