"""Blocks sharded over the ranks of a process group: the multi-device
compress pipeline.

Counterpart: ``tpu_blosc/dist/mesh.py``.  Chunked frames (chunk.py) split
data into independent blocks, and blocks are the data-parallel unit:

    host bytes ──split──▶ (nb, bs) uint8 ──rows [d*per, (d+1)*per) to rank d──▶
    on each rank's device: shuffle/bitshuffle filter, sampled byte
    histogram, per-block diff counts  ──▶ all_reduce / all_gather of the
    metadata ──▶ per-rank codec on its slice of the blocks (native,
    OpenMP) ──▶ ordered gather of per-block payloads ──▶ the frame, on
    every rank

One rank is one process with one device (``dist.initialize_distributed``
first; with no group there is one rank).  Where the JAX package shards
one array over a ``Mesh`` inside one program, here every rank runs the
same call on the whole ``data`` and takes its rows.  The filter is per
block, so the only collectives are the metadata's (a 1 KiB histogram and
4 bytes a block) and the payloads'; frames are byte-identical to
``chunk.compress_chunked``'s at every world size.

The JAX package's split into word and byte filter programs
(``_swar_route``, ``_apply_sharded_words``, ``_filter_sharded``) works
around its compiler; here ``filters.filter_blocks`` serves every type
size with one kernel pair.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import filters
from ..chunk import (
    choose_block_size,
    native_pipeline_codec,
    registered_codec,
    registry_payloads,
)
from ..device import _decode_filtered_blocks, compress_filtered_slots
from ..errors import InvalidDataError
from ..filters import rle as _rle
from ..format import Shuffle, parse_header
from ..options import Options
from . import _group
from ._group import initialize_distributed
from .multihost import (
    _compress_local_blocks,
    allgather_payloads,
    assemble_payload_frame,
    process_slice,
    slot_payloads,
)

__all__ = [
    "MeshStats",
    "compress_chunked_mesh",
    "decompress_chunked_mesh",
    "filter_blocks_sharded",
    "initialize_distributed",
    "rank_step",
    "rows_to_device",
    "sample_histogram",
    "unfilter_blocks_sharded",
]


def _pad_batch(nb: int, n_shards: int) -> int:
    """Blocks per shard after padding the batch axis to divide evenly."""
    return -(-nb // n_shards)


def _rank_rows(arr: np.ndarray, shard: int, per: int) -> np.ndarray:
    """Rows [shard*per, (shard+1)*per) of ``arr``, the rows past its end
    as zeros: the shard of the zero-padded batch."""
    nb = arr.shape[0]
    lo = min(shard * per, nb)
    hi = min(lo + per, nb)
    if hi - lo == per:
        return arr[lo:hi]
    local = np.zeros((per, arr.shape[1]), dtype=np.uint8)
    local[: hi - lo] = arr[lo:hi]
    return local


def rows_to_device(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """``rows`` as a tensor on ``device``.  The rows may be a view of the
    caller's read-only bytes: the tensor is only ever read."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(rows)).to(device)


def _sharded_rows(arr: np.ndarray, fn, group, device) -> np.ndarray:
    """Apply the per-row ``fn`` to ``arr``'s rows, each rank to its shard
    of the zero-padded batch on ``device``, and gather the rows in rank
    order; the padding is dropped."""
    device = filters.target_device(device, "filter_blocks_sharded")
    nb = arr.shape[0]
    per = _pad_batch(nb, _group.world_size(group))
    y = fn(rows_to_device(_rank_rows(arr, _group.rank(group), per), device))
    if _group.is_grouped():
        y = _group.all_gather_rows(y, group)
    return y.cpu().numpy()[:nb]


def filter_blocks_sharded(arr: np.ndarray, type_size: int, mode: Shuffle,
                          group=None, device=None) -> np.ndarray:
    """Filter (nb, bs) blocks across the group's ranks; byte-identical to
    the host path.  Every rank passes the whole ``arr`` and returns the
    whole result."""
    if mode == Shuffle.NOSHUFFLE or type_size <= 1:
        return np.asarray(arr)
    return _sharded_rows(arr, lambda x: filters.filter_blocks(x, type_size, mode),
                         group, device)


def unfilter_blocks_sharded(arr: np.ndarray, type_size: int, mode: Shuffle,
                            group=None, device=None) -> np.ndarray:
    """Inverse of filter_blocks_sharded."""
    if mode == Shuffle.NOSHUFFLE or type_size <= 1:
        return np.asarray(arr)
    return _sharded_rows(arr, lambda x: filters.unfilter_blocks(x, type_size, mode),
                         group, device)


# ---------------------------------------------------------------------------
# end-to-end chunked frame compress/decompress over the group
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshStats:
    """Metadata of the sharded filter step, the same on every rank.

    ``histogram`` is the byte histogram, summed over the ranks, of a
    uniform chunk sample of the filtered stream (an entropy proxy, the
    signal suggest_codec uses) covering ``sample_bytes`` bytes: at most
    about _HIST_CAP a rank.  When a rank's shard fits under the cap the
    sample is the full stream.  ``block_diffs`` is the per-block count of
    bytes differing from their predecessor (a run-structure proxy),
    gathered in header order, exact.
    """

    histogram: np.ndarray
    block_diffs: np.ndarray
    sample_bytes: int = 0


#: histogram sampling: 512-byte chunks, at most ~256 KiB per rank
_HIST_CHUNK = 512
_HIST_CAP = 256 << 10


def _hist_stride(n_chunks: int) -> int:
    return max(1, n_chunks // (_HIST_CAP // _HIST_CHUNK))


def _hist_sample_accounting(
    n_shards: int, per: int, block_size: int, nb_full: int
) -> tuple[int, int]:
    """(total sampled bytes, sampled bytes that fall in zero padding
    rows) for the step's per-rank chunk sampling."""
    shard_bytes = per * block_size
    sample = pad = 0
    for d in range(n_shards):
        real_b = max(0, min(nb_full - d * per, per)) * block_size
        if shard_bytes % _HIST_CHUNK:
            sample += shard_bytes
            pad += shard_bytes - real_b
            continue
        nch = shard_bytes // _HIST_CHUNK
        starts = np.arange(0, nch, _hist_stride(nch)) * _HIST_CHUNK
        sample += starts.size * _HIST_CHUNK
        pad += int(
            np.clip(starts + _HIST_CHUNK - real_b, 0, _HIST_CHUNK).sum()
        )
    return sample, pad


def sample_histogram(y: torch.Tensor) -> torch.Tensor:
    """The 256-bin int32 byte histogram of one rank's filtered rows ``y``:
    of their 512-byte chunks at ``_hist_stride``, or of the whole shard
    when its size is no multiple of 512 (such shards are small)."""
    if y.numel() % _HIST_CHUNK == 0:
        chunks = y.view(-1, _HIST_CHUNK)
        samp = chunks[:: _hist_stride(chunks.shape[0])].reshape(-1)
    else:
        samp = y.reshape(-1)
    return torch.bincount(samp, minlength=256).to(torch.int32)


def rank_step(x: torch.Tensor, type_size: int, mode: Shuffle):
    """One rank's part of the filter step, before the collectives
    (≙ ``step`` in tpu_blosc/dist/mesh.py:298-310): filter the (per, bs)
    rows, and return them with the 256-bin int32 histogram of their chunk
    sample and each row's count of bytes unlike their left neighbour
    (int32).  ``mode`` NOSHUFFLE leaves the rows as they are."""
    y = x if mode == Shuffle.NOSHUFFLE else filters.filter_blocks(x, type_size, mode)
    return y, sample_histogram(y), _rle.seg_run_counts(y) - 1


def mesh_stats(hist: np.ndarray, diffs: np.ndarray, n_shards: int, per: int,
               block_size: int, nb_full: int) -> MeshStats:
    """MeshStats from the ranks' summed histogram and their diffs in rank
    order: the padding rows are all zero, so their sampled bytes leave bin
    0 and the diff counts past ``nb_full`` are dropped."""
    sample_bytes, pad_bytes = _hist_sample_accounting(n_shards, per, block_size, nb_full)
    hist = np.array(hist, dtype=np.int32)
    hist[0] -= pad_bytes
    return MeshStats(histogram=hist,
                     block_diffs=np.asarray(diffs, dtype=np.int32)[:nb_full],
                     sample_bytes=sample_bytes - pad_bytes)


def _mesh_filter_step(x: torch.Tensor, type_size: int, mode: Shuffle, group):
    """rank_step, then the collectives: the histograms summed over the
    ranks and the diff counts gathered in rank order (both returned on
    the host)."""
    y, hist, diffs = rank_step(x, type_size, mode)
    if _group.is_grouped():
        hist = hist.to(_group.comm_device(group))
        dist.all_reduce(hist, group=group)
        diffs = _group.all_gather_rows(diffs, group)
    return y, hist.cpu().numpy(), diffs.cpu().numpy()


def compress_chunked_mesh(data, opts: Options, group=None, device=None,
                          return_stats: bool = False):
    """Compress into a FLAG_SPLIT frame with the filter stage on the
    ranks' devices.

    Every rank of ``group`` (None: the default group, or one rank when
    none is initialised) calls with the whole ``data`` and returns the
    same frame, byte-identical to chunk.compress_chunked's at every world
    size.  ``device`` is this rank's device (None: the current CUDA
    device).  Each rank compresses the blocks of its ``process_slice``,
    filtered on its device, and the payloads are gathered in header order.

    With ``return_stats`` rank d first filters rows [d*per, (d+1)*per) of
    the full blocks for the statistics (the codec stage then filters only
    the few blocks of its slice that are not among them), and the
    MeshStats are returned alongside the frame (None when the data has no
    full block).  Every rank passes the same ``return_stats``: the
    statistics have collectives of their own.
    """
    raw = np.frombuffer(data.tobytes() if isinstance(data, np.ndarray) else bytes(data),
                        dtype=np.uint8)
    opts = opts.clamped()
    native = native_pipeline_codec(opts.codec, opts.level)
    if native is None:  # a registered codec, called block by block
        registered_codec(opts.codec)
    device = filters.target_device(device, "compress_chunked_mesh")
    n = raw.size
    if n == 0:
        raise InvalidDataError("blosc: invalid compressed data: empty input")
    ts = opts.type_size
    block_size = choose_block_size(n, ts, opts.block_size)
    nb_full = n // block_size
    body = nb_full * block_size
    blocks = raw[:body].reshape(nb_full, block_size)
    use_filter = opts.shuffle != Shuffle.NOSHUFFLE and ts > 1
    n_shards, pid = _group.world_size(group), _group.rank(group)

    # this rank's shard of the filter stage, and the statistics
    stats = y = None
    first = 0
    if return_stats and nb_full:
        per = _pad_batch(nb_full, n_shards)
        first = pid * per
        y, hist, diffs = _mesh_filter_step(
            rows_to_device(_rank_rows(blocks, pid, per), device), ts,
            opts.shuffle if use_filter else Shuffle.NOSHUFFLE, group,
        )
        stats = mesh_stats(hist, diffs, n_shards, per, block_size, nb_full)

    # this rank's slice of the codec stage: contiguous blocks, the ragged
    # tail included, remainder blocks to the leading ranks
    lo_byte, hi_byte = process_slice(n, block_size, pid, n_shards)
    if not use_filter:
        local = _compress_local_blocks(raw[lo_byte:hi_byte], block_size, opts)
    elif hi_byte == lo_byte:
        local = [], []
    else:
        lo, hi_full = lo_byte // block_size, min(hi_byte, body) // block_size
        staged = torch.empty(hi_byte - lo_byte, dtype=torch.uint8)
        filtered = staged.numpy()
        if hi_full > lo:  # the one device-to-host copy
            rows = _codec_rows(blocks, y, first, lo, hi_full, ts, opts.shuffle, device)
            staged[: (hi_full - lo) * block_size].view(hi_full - lo, block_size).copy_(rows)
        if hi_byte > body:  # the tail is filtered on the host
            tail = raw[body:]
            filtered[body - lo_byte :] = (
                filters.filter_bytes(tail, ts, opts.shuffle) if tail.size >= ts else tail
            )
        if native is None:
            local = registry_payloads(filtered, block_size, opts, raw[lo_byte:hi_byte])
        else:
            local = slot_payloads(*compress_filtered_slots(filtered, opts, block_size))

    payloads, memf = allgather_payloads(*local, group)
    nb_total = -(-n // block_size)
    if len(payloads) != nb_total:
        raise InvalidDataError(
            f"blosc: mesh gather returned {len(payloads)} blocks, expected {nb_total}"
        )
    frame = assemble_payload_frame(opts, n, block_size, payloads, memf)
    return (frame, stats) if return_stats else frame


def _codec_rows(blocks: np.ndarray, y, first: int, lo: int, hi: int,
                type_size: int, mode: Shuffle, device: torch.device) -> torch.Tensor:
    """The filtered full blocks [lo, hi) on ``device``.  Those among the
    rows ``y`` that the filter step left there (blocks ``first``...; None:
    no step ran) are taken from it.  The others are filtered now: a run
    before ``y``'s and a run after, since both partitions are contiguous
    (they differ where the block count does not divide by the world
    size)."""
    def filt(a: int, b: int) -> torch.Tensor:
        return filters.filter_blocks(rows_to_device(blocks[a:b], device), type_size, mode)

    held = 0 if y is None else y.shape[0]
    a0, a1 = max(lo, first), min(hi, first + held)
    if a1 <= a0:
        return filt(lo, hi)
    parts = [y[a0 - first : a1 - first]]
    if a0 > lo:
        parts.insert(0, filt(lo, a0))
    if hi > a1:
        parts.append(filt(a1, hi))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def decompress_chunked_mesh(data, group=None, device=None, type_size: int = 0) -> bytes:
    """Decompress a FLAG_SPLIT frame with the unfilter stage on the ranks'
    devices: every rank decodes the codec stage on its host, rank d
    unfilters its shard of the full filtered blocks on ``device`` (None:
    the current CUDA device), and the rows are gathered in rank order, so
    every rank returns the whole data.  A frame that is not split, is not
    filtered or whose blocks the block kernels do not take is decoded on
    the host."""
    from ..api import decompress_with_size

    raw = bytes(data)
    header = parse_header(raw)
    mode = header.shuffle_mode
    ts = type_size if type_size > 0 else header.type_size
    n, bs = header.nbytes_orig, header.block_size
    quantum = 8 * ts if mode == Shuffle.BITSHUFFLE else ts
    if (not header.is_split or mode == Shuffle.NOSHUFFLE or ts < 2 or bs == 0
            or bs % quantum or n < bs):
        return decompress_with_size(raw, type_size)
    # a registered codec decodes the blocks on the host, block by block
    # (≙ tpu_blosc/dist/mesh.py:497-529)
    native = native_pipeline_codec(header.codec, 1)
    decoded = _decode_filtered_blocks(raw, header, n, native[0] if native else None)
    if decoded is None:  # the layout does not add up, or no codec: the host path raises
        return decompress_with_size(raw, type_size)
    stream, entries = decoded
    host = stream.numpy()
    nb_full = n // bs
    body = nb_full * bs
    blocks = host[:body].reshape(nb_full, bs)
    todo = [i for i, (_, is_memcpy) in enumerate(entries[:nb_full]) if not is_memcpy]
    if len(todo) == nb_full:
        blocks[:] = unfilter_blocks_sharded(blocks, ts, mode, group, device)
    elif todo:  # blocks stored raw stay as they are
        blocks[todo] = unfilter_blocks_sharded(blocks[todo], ts, mode, group, device)
    if n - body >= ts and not entries[nb_full][1]:
        host[body:] = filters.unfilter_bytes(host[body:], ts, mode)
    return host.tobytes()
