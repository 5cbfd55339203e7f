"""The TPB2 container: 64-bit framing for inputs past the uint32 frame.

Counterpart: ``tpu_blosc/container.py:1-230``; the containers are
byte-identical to the JAX package's.  Layout (little-endian):

    bytes 0-3    magic b"TPB2" (byte 0 can never be a frame's version 2)
    byte  4      container version = 1
    byte  5      codec ID
    byte  6      flags (the frame header's bits)
    byte  7      type size
    bytes 8-15   total uncompressed size (uint64)
    bytes 16-19  number of sub-frames (uint32)
    then         nframes x uint64 compressed sub-frame sizes
    then         the sub-frames: independent FLAG_SPLIT Blosc frames, each
                 over a ``frame_limit``-byte slice of the input (1 GiB by
                 default), aligned to 8 * type_size so no shuffle group
                 straddles two sub-frames
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass

import numpy as np

from .errors import InvalidDataError, InvalidHeaderError, SizeMismatchError
from .format import FLAG_BITSHUFFLE, FLAG_SHUFFLE, HEADER_SIZE, Shuffle, parse_header
from .native import backend as _nb
from .options import Options

MAGIC = b"TPB2"
CONTAINER_VERSION = 1
CONTAINER_HEADER_SIZE = 20

# uncompressed bytes per sub-frame: far enough under the uint32 frame cap
# for the header, block table and an incompressible payload
DEFAULT_FRAME_LIMIT = 1 << 30

_HEAD = struct.Struct("<BBBBQI")


def is_container(data) -> bool:
    return bytes(data[:4]) == MAGIC


def compress_container(raw, opts: Options,
                       frame_limit: int = DEFAULT_FRAME_LIMIT) -> bytes:
    """Compress into a container of independent sub-frames."""
    from .api import _compress_frame_sized

    n = len(raw)
    if n == 0:
        raise InvalidDataError("blosc: invalid compressed data: empty input")
    align = 8 * max(opts.type_size, 1)
    frame_limit = max(frame_limit // align * align, align)
    mv = memoryview(raw).cast("B")
    frames = [_compress_frame_sized(mv[start : start + frame_limit], opts)
              for start in range(0, n, frame_limit)]
    flags = 0
    if opts.shuffle == Shuffle.SHUFFLE:
        flags |= FLAG_SHUFFLE
    elif opts.shuffle == Shuffle.BITSHUFFLE:
        flags |= FLAG_BITSHUFFLE
    head = MAGIC + _HEAD.pack(
        CONTAINER_VERSION, int(opts.codec), flags, min(opts.type_size, 255), n, len(frames)
    )
    table = struct.pack(f"<{len(frames)}Q", *(len(f) for f in frames))
    return head + table + b"".join(frames)


def parse_container(data) -> tuple[int, int, int, int, int, list[int], int]:
    """(version, codec, flags, type_size, total, frame_sizes, offset)."""
    raw = bytes(data[:CONTAINER_HEADER_SIZE])
    if len(raw) < CONTAINER_HEADER_SIZE or raw[:4] != MAGIC:
        raise InvalidHeaderError("blosc: invalid container header")
    version, codec, flags, type_size, total, nframes = _HEAD.unpack(raw[4:])
    if version != CONTAINER_VERSION:
        raise InvalidHeaderError(f"blosc: unsupported container version {version}")
    table_end = CONTAINER_HEADER_SIZE + 8 * nframes
    if nframes == 0 or table_end > len(data):
        raise InvalidDataError("blosc: invalid container: bad frame table")
    sizes = list(struct.unpack(f"<{nframes}Q", bytes(data[CONTAINER_HEADER_SIZE:table_end])))
    return version, codec, flags, type_size, total, sizes, table_end


@dataclass(frozen=True)
class ContainerInfo:
    """A container's metadata (get_info's answer for a container)."""

    version: int
    codec: int
    flags: int
    type_size: int
    nbytes_orig: int
    num_frames: int

    @property
    def is_container(self) -> bool:
        return True


def get_container_info(data) -> ContainerInfo:
    version, codec, flags, type_size, total, sizes, _ = parse_container(data)
    return ContainerInfo(version, codec, flags, type_size, total, len(sizes))


def frame_spans(mv, total: int, sizes: list[int], offset: int) -> list[tuple[int, int, int]]:
    """(position, size, nbytes_orig) of each sub-frame, validated before
    any output is allocated: the frames lie inside the input, each holds
    a header, and their sizes add up to the declared total, so a forged
    total fails here (≙ tpu_blosc/container.py:137-170)."""
    if offset + sum(sizes) > len(mv):
        raise InvalidDataError("blosc: invalid container: frames overrun input")
    spans = []
    pos, claimed = offset, 0
    for fs in sizes:
        if fs < HEADER_SIZE:
            raise InvalidDataError(
                "blosc: invalid container: sub-frame shorter than a header"
            )
        n_sub = parse_header(bytes(mv[pos : pos + HEADER_SIZE])).nbytes_orig
        spans.append((pos, fs, n_sub))
        claimed += n_sub
        pos += fs
    if claimed != total:
        raise SizeMismatchError(
            f"blosc: decompressed size mismatch: container declares {total} "
            f"bytes, sub-frames declare {claimed}"
        )
    return spans


def decompress_container(data, type_size: int = 0) -> bytes:
    """Decode every sub-frame, in order, straight into one result; a
    ``type_size`` > 0 overrides the sub-frames' element size."""
    from .api import decompress_into, decompress_with_size

    _, _, _, _, total, sizes, offset = parse_container(data)
    mv = memoryview(data)
    spans = frame_spans(mv, total, sizes, offset)
    if type_size > 0:
        out = b"".join(decompress_with_size(mv[p : p + fs], type_size) for p, fs, _ in spans)
        if len(out) != total:
            raise SizeMismatchError(
                f"blosc: decompressed size mismatch: got {len(out)}, expected {total}"
            )
        return out
    out, addr = _nb.alloc_bytes(total)
    view = np.ctypeslib.as_array(ctypes.cast(addr, ctypes.POINTER(ctypes.c_ubyte)),
                                 shape=(total,))
    pos = 0
    for fpos, fs, n_sub in spans:
        pos += decompress_into(mv[fpos : fpos + fs], view[pos : pos + n_sub])
    return out
