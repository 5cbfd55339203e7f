"""Device tensors in, Blosc frames out, and back.

Counterpart: ``tpu_blosc/device.py``: ``compress_array`` (:692-876; its
match strategy in ``match.py``, its rle strategy in ``rle.py``) and
``decompress_array`` (:1455-1535, :1592-1710; its records strategy in
``records.py``).

Compress: every full block of the tensor's bytes is filtered on the
tensor's device (byte shuffle: filters.batched.shuffle_blocks; bit
shuffle: filters.batched.bit_shuffle_blocks), the filtered stream crosses
to the host in one copy, the ragged tail is filtered there, and the
native codec writes a FLAG_SPLIT frame.  The frames are byte-identical to
``api.compress_with_options(x.cpu().numpy().tobytes(), opts)``: filtering
on the device is an execution choice, never a format choice.
``compress_array`` is ``_compress_array_stage2(_compress_array_stage1(...))``
(≙ tpu_blosc/device.py:717-726), so checkpoint writers that pipeline the
two halves write the same frames by construction.

Decompress ("device"): the host decodes the codec stage only, one copy
takes the still-filtered stream to the device, and the device unfilters
it, passing blocks that were stored raw through untouched.

A codec registered with ``register_codec`` (a new ID, or one in place of
a builtin) changes the host stage only: the filter still runs on the
device, and the registered codec compresses the filtered blocks one by
one (stage 2), to the frame ``compress_with_options`` writes under the
same registry; the "device" decode has it decode the blocks on the host
and unfilters them on the device (the JAX package decodes such a frame
on the host, tpu_blosc/device.py:1664-1666).

Match ("match", and "auto", which is the same): for LZ4 and LZ4HC, match
discovery on the device and LZ4 streams written from literal records
(``match.py``); other codecs, a codec registered in place of LZ4 or LZ4HC,
and data the match strategy does not suit, take the transfer route.  (The
JAX package writes such an override's rows with its native LZ4 emitter and
the tail with the registered codec, a frame the override's own decoder
may not read; the port does not copy that.)

Rle ("rle"): for LZ4 and LZ4HC, run scan on the device and LZ4 streams
written from run records (``rle.py``), with the same fallbacks to the
transfer route.

Decompress ("rle", and "records", which is the same): for filtered
multi-block LZ4 frames only the literal records of the decoded, still
filtered stream cross to the device, which rebuilds and unfilters it
(``records.py``); other frames take the transfer route.

A strategy name that none of these is takes the transfer route.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from . import filters
from . import match as _match
from . import records as _records
from . import rle as _rle
from .api import (
    AUTO_BLOCK_THRESHOLD,
    compress_with_options,
    decompress_into,
    get_decompressed_size,
)
from .chunk import (
    assemble_payload_frame,
    assemble_split_frame,
    choose_block_size,
    native_pipeline_codec,
    parse_block_table,
    payload_offsets,
    registry_blocks_decode,
    registry_payloads,
)
from .codecs.registry import get_codec
from .errors import InvalidDataError
from .format import HEADER_SIZE, Codec, Shuffle, parse_header
from .native import backend as _nb
from .options import Options

# bit 3 of the native shuffle mode: the stream arrives already filtered
# (tpu_blosc/device.py:818-821); zlib's byte identity depends on it
_PREFILTERED = 8


def tensor_bytes(x: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes in logical C order, as a flat uint8 tensor on its
    device (the bytes of ``np.asarray(x).tobytes()``)."""
    flat = x.detach().resolve_conj().resolve_neg().contiguous().reshape(-1)
    if flat.dtype == torch.uint8:
        return flat
    if flat.is_complex():
        flat = torch.view_as_real(flat).reshape(-1)
    return flat.view(torch.uint8)


def compress_array(x: torch.Tensor, opts: Options | None = None,
                   strategy: str = "transfer") -> bytes:
    """Compress a tensor with the filter stage on its device.

    ``opts.type_size`` left at the default (4) takes the dtype's element
    size instead, as in tpu_blosc/device.py:740-747.  Single-block,
    unfiltered and sub-block inputs take the host route.  ``strategy``
    is "transfer" (frames byte-identical to the host path), "match" or
    "auto", or "rle" (see the module docstring).
    """
    return _compress_array_stage2(_compress_array_stage1(x, opts, strategy))


def _compress_array_stage1(x: torch.Tensor, opts: Options | None, strategy: str):
    """The device and copy half of compress_array: the finished frame
    (bytes) when the tensor took the host route or the match or the rle
    strategy engaged, else ``(filtered host stream, options, block size)`` for
    _compress_array_stage2 (≙ tpu_blosc/device.py:720-770)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"compress_array takes a torch.Tensor, got {type(x)!r}")
    if opts is None:
        opts = Options()
    itemsize = x.element_size()
    if opts.type_size == Options().type_size and itemsize != opts.type_size:
        opts = replace(opts, type_size=itemsize)
    opts = opts.clamped()

    flat = tensor_bytes(x)
    n = flat.numel()
    if n == 0:
        raise InvalidDataError("blosc: invalid compressed data: empty input")
    block_size = choose_block_size(n, opts.type_size, opts.block_size)
    nb_full = n // block_size
    do_filter = opts.shuffle != Shuffle.NOSHUFFLE and opts.type_size > 1
    use_chunked = opts.block_size > 0 or n > AUTO_BLOCK_THRESHOLD
    if not use_chunked or not do_filter or nb_full == 0:
        return compress_with_options(flat.cpu().numpy(), opts)
    engage = {"match": _match.compress_array_match, "auto": _match.compress_array_match,
              "rle": _rle.compress_array_rle}.get(strategy)
    # the strategies emit the native LZ4 format: not for a registered override
    if (engage is not None and opts.codec in (Codec.LZ4, Codec.LZ4HC)
            and native_pipeline_codec(opts.codec, opts.level) is not None):
        frame = engage(flat, opts, nb_full, block_size)
        if frame is not None:
            return frame
    return _device_filter_fetch(flat, opts, nb_full, block_size), opts, block_size


def _device_filter_fetch(flat: torch.Tensor, opts: Options, nb_full: int,
                         block_size: int) -> np.ndarray:
    """Filter the full blocks on the device with the pair ``opts.shuffle``
    names, copy the stream to the host once, filter the ragged tail there
    (≙ tpu_blosc/device.py:773-792).  A tail shorter than one element,
    and under bit shuffle the bytes past its last whole group of 8
    elements, stay verbatim."""
    ts = opts.type_size
    body = nb_full * block_size
    staged = torch.empty_like(flat)
    filters.filter_blocks(
        flat[:body].view(nb_full, block_size), ts, opts.shuffle,
        out=staged[:body].view(nb_full, block_size),
    )
    staged[body:] = flat[body:]
    host = staged.cpu().numpy()  # the one device-to-host copy
    if host.size - body >= ts:
        host[body:] = filters.filter_bytes(host[body:], ts, opts.shuffle)
    return host


def _compress_array_stage2(staged) -> bytes:
    """The host half of compress_array: run the native codec over the
    filtered stream and write the frame (≙ tpu_blosc/device.py:795-876);
    a finished frame from stage 1 passes through."""
    if isinstance(staged, bytes):
        return staged
    filtered, opts, block_size = staged
    if native_pipeline_codec(opts.codec, opts.level) is None:
        payloads, memf = registry_payloads(filtered, block_size, opts)
        return assemble_payload_frame(opts, filtered.size, block_size, payloads, memf)
    return assemble_split_frame(
        opts, filtered.size, block_size, *compress_filtered_slots(filtered, opts, block_size)
    )


def compress_filtered_slots(filtered: np.ndarray, opts: Options, block_size: int):
    """``native.backend.compress_slots`` of an already filtered stream
    (whole blocks of ``block_size``, the last one may be short), for a
    codec the native pipeline serves.

    Blocks that take the memcpy fallback must carry their raw bytes, so
    their filtered bytes are unfiltered back on the host, with the
    inverse of the filter that made them.
    """
    native_codec, depth = native_pipeline_codec(opts.codec, opts.level)
    slots, slot, sizes, memcpy_flags = _nb.compress_slots(
        filtered, block_size, opts.type_size, _PREFILTERED, native_codec,
        depth, num_threads=opts.num_threads,
    )
    for i in np.flatnonzero(memcpy_flags):
        payload = slots[i * slot : i * slot + sizes[i]]
        payload[:] = filters.unfilter_bytes(payload, opts.type_size, opts.shuffle)
    return slots, slot, sizes, memcpy_flags


def decompress_array(data, dtype: torch.dtype, shape=None, device=None,
                     strategy: str = "auto") -> torch.Tensor:
    """Decompress a frame into a tensor of ``dtype`` on ``device``.

    ``device=None`` means the current CUDA device.  ``shape`` defaults to
    1-D.  Strategies: "auto" and "transfer" decode on the host and copy
    the result once; "device" decodes the codec stage on the host and
    unfilters on the device, for byte- and bit-shuffled multi-block frames
    at any type size (other frames take the host decode, as in the JAX
    package, which takes this route at type size 4 only); "rle" and
    "records" ship only literal records to the device, for filtered
    multi-block LZ4 frames without a ragged tail or a block stored raw
    (other frames take the host decode).
    """
    target = filters.target_device(device, "decompress_array")
    n = checked_decode_size(data, dtype)
    out = None
    if strategy == "device":
        out = _decompress_array_devfilter(data, n, target)
    elif strategy in ("rle", "records"):
        out = _records.decompress_array_records(data, n, target)
    if out is None:
        out = host_decode(data, n).to(target)
    out = out.view(dtype)
    return out.reshape(shape) if shape is not None else out


def checked_decode_size(data, dtype: torch.dtype) -> int:
    """The frame's decoded size, which must be whole ``dtype`` elements
    (≙ tpu_blosc/device.py:1504-1522)."""
    n = get_decompressed_size(data)
    if n % dtype.itemsize:
        raise InvalidDataError(
            f"blosc: {n} bytes is not a whole number of {dtype} elements"
        )
    return n


def host_decode(data, n: int) -> torch.Tensor:
    """The host half of decompress_array's transfer route: the frame's
    ``n`` bytes decoded into a fresh CPU uint8 tensor
    (≙ tpu_blosc/device.py:1525-1535)."""
    host = torch.empty(n, dtype=torch.uint8)
    decompress_into(data, host.numpy())
    return host


def _decode_filtered_blocks(raw: bytes, header, n: int, native_codec: int | None,
                            forbid_memcpy: bool = False):
    """Host decode of a FLAG_SPLIT frame's blocks to the still-filtered
    stream (shuffle mode 0), as a CPU uint8 tensor, with the block table;
    ``native_codec`` None decodes with the codec registered under the
    frame's ID, block by block.  None when the layout does not add up or
    no codec serves the ID: the host path then raises with full context
    (≙ tpu_blosc/device.py:1592-1627).  Blocks stored raw come back raw;
    with ``forbid_memcpy`` a frame that has one gives None before anything
    is decoded."""
    if header.nbytes_comp > len(raw) or header.nbytes_comp < HEADER_SIZE:
        return None
    if native_codec is None and get_codec(header.codec) is None:
        return None
    entries, offset = parse_block_table(raw, header)
    if len(entries) != -(-n // header.block_size):
        return None
    if forbid_memcpy and any(m for _, m in entries):
        return None
    offsets, psizes, is_memcpy = payload_offsets(entries, offset)
    if int(offsets[-1] + psizes[-1]) > min(len(raw), header.nbytes_comp):
        return None
    buf = torch.empty(n, dtype=torch.uint8)
    if native_codec is None:
        registry_blocks_decode(raw, header, entries, offset, buf.numpy())
        return buf, entries
    _nb.decompress_blocks(
        np.frombuffer(raw, np.uint8), offsets, psizes, is_memcpy,
        header.block_size, n, header.type_size, 0, native_codec,
        out_addr=buf.data_ptr(),
    )
    return buf, entries


def _decompress_array_devfilter(data, n: int, device: torch.device):
    """The "device" strategy's body; None when the frame does not qualify
    (≙ tpu_blosc/device.py:1630-1710)."""
    raw = bytes(data)
    if len(raw) < HEADER_SIZE or raw[:4] == b"TPB2":
        return None
    header = parse_header(raw)
    mode = header.shuffle_mode
    if not header.is_split or mode == Shuffle.NOSHUFFLE:
        return None
    ts, bs = header.type_size, header.block_size
    quantum = 8 * ts if mode == Shuffle.BITSHUFFLE else ts
    if ts < 2 or bs == 0 or bs % quantum:
        return None
    nb_full = n // bs
    if nb_full == 0:
        return None
    # a registered codec decodes the blocks on the host, the card unfilters
    native = native_pipeline_codec(header.codec, 1)
    decoded = _decode_filtered_blocks(raw, header, n, native[0] if native else None)
    if decoded is None:
        return None
    host, entries = decoded
    body = nb_full * bs
    tail_raw = n > body and entries[nb_full][1]
    if n - body >= ts and not tail_raw:
        host[body:] = torch.from_numpy(filters.unfilter_bytes(host[body:].numpy(), ts, mode))
    stream = host.to(device)  # the one host-to-device copy
    keep = [m for _, m in entries[:nb_full]]
    keep_raw = torch.tensor(keep, dtype=torch.bool).to(device) if any(keep) else None
    out = torch.empty_like(stream)
    filters.unfilter_blocks(
        stream[:body].view(nb_full, bs), ts, mode, keep_raw=keep_raw,
        out=out[:body].view(nb_full, bs),
    )
    out[body:] = stream[body:]
    return out
