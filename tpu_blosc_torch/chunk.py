"""Multi-block (FLAG_SPLIT) frames on the native host codec.

Counterpart: ``tpu_blosc/chunk.py``: ``choose_block_size`` (:124-133),
``_native_pipeline_codec`` (:79-110), the native branch of
``compress_chunked`` (:156-210), ``parse_block_table`` (:289-299),
``_decompress_chunked_native`` and ``_validate_block_layout``
(:302-382), the range decoders ``decompress_single_block`` and
``decompress_block_run`` (:385-463) and ``decompress_chunked`` (:466-517).

Layout after the 16-byte header (FLAG_SPLIT set):

    bytes 16-19  num_blocks (uint32)
    then         num_blocks x uint32: bits 0-30 payload size,
                 bit 31 = block stored memcpy (raw, unfiltered)
    then         the payloads, in block order

The port has no codec registry: a codec the native library lacks raises
InvalidCodecError.
"""

from __future__ import annotations

import struct

import numpy as np

from .errors import (
    DataTooLargeError,
    DecompressionFailedError,
    InvalidCodecError,
    InvalidDataError,
    SizeMismatchError,
)
from .format import (
    FLAG_BITSHUFFLE,
    FLAG_SHUFFLE,
    FLAG_SPLIT,
    FORMAT_VERSION,
    HEADER_SIZE,
    MAX_UINT32,
    Codec,
    Header,
    Shuffle,
)
from .native import backend as _native
from .options import Options

ENTRY_MEMCPY = 0x80000000
ENTRY_SIZE_MASK = 0x7FFFFFFF

# 1 MiB blocks unless the caller asks for another size (tpu_blosc/chunk.py:120)
DEFAULT_AUTO_BLOCK = 1024 * 1024
MIN_BLOCK = 4096


def hc_depth_for_level(level: int) -> int:
    """Map Blosc levels 1-9 to the LZ4HC search depth
    (≙ tpu_blosc/codecs/lz4_ref.py:229-241)."""
    if level <= 3:
        return 2
    if level <= 5:
        return 16
    if level <= 7:
        return 64
    return 256


def native_pipeline_codec(codec: int, level: int) -> tuple[int, int] | None:
    """Frame codec ID -> (native pipeline codec, level or depth), or None
    for an ID the native library does not implement.

    LZ4 ignores the level, LZ4HC maps it to a chain depth, ZLIB passes it
    through and ZSTD maps it to the zstd levels 1/3/9/19.
    """
    if codec == Codec.BLOSCLZ:
        return _native.NATIVE_BLOSCLZ, 1
    if codec == Codec.LZ4:
        return _native.NATIVE_LZ4, 1
    if codec == Codec.LZ4HC:
        return _native.NATIVE_LZ4HC, hc_depth_for_level(level)
    if codec == Codec.SNAPPY:
        return _native.NATIVE_SNAPPY, 0
    if codec == Codec.ZLIB:
        return _native.NATIVE_ZLIB, level
    if codec == Codec.ZSTD:
        zstd_level = 1 if level <= 2 else 3 if level <= 4 else 9 if level <= 6 else 19
        return _native.NATIVE_ZSTD, zstd_level
    return None


def choose_block_size(n: int, type_size: int, requested: int = 0) -> int:
    """Pick the block size: requested (if > 0) else auto, aligned to 8*ts."""
    align = 8 * max(type_size, 1)
    if requested > 0:
        bs = max(requested, align)
    else:
        bs = max(min(DEFAULT_AUTO_BLOCK, n), MIN_BLOCK)
    bs = (bs // align) * align
    return max(bs, align)


def split_header(opts: Options, n: int, block_size: int,
                 entries: list[int], payload_bytes: int) -> bytes:
    """Header and block table of a FLAG_SPLIT frame; raises
    DataTooLargeError when the frame would overflow the uint32 fields."""
    nb = len(entries)
    total = HEADER_SIZE + 4 + 4 * nb + payload_bytes
    if total > MAX_UINT32:
        raise DataTooLargeError(
            f"blosc: data too large: frame of {total} bytes exceeds uint32 limit"
        )
    flags = FLAG_SPLIT
    if opts.shuffle == Shuffle.SHUFFLE:
        flags |= FLAG_SHUFFLE
    elif opts.shuffle == Shuffle.BITSHUFFLE:
        flags |= FLAG_BITSHUFFLE
    header = Header(
        version=FORMAT_VERSION,
        version_lz=int(opts.codec),
        flags=flags,
        type_size=min(opts.type_size, 255),
        nbytes_orig=n,
        block_size=block_size,
        nbytes_comp=total,
    )
    return header.to_bytes() + struct.pack(f"<I{nb}I", nb, *entries)


def compress_chunked(raw, opts: Options) -> bytes:
    """Compress into a multi-block FLAG_SPLIT frame on the host."""
    native = native_pipeline_codec(opts.codec, opts.level)
    if native is None:
        raise InvalidCodecError(f"blosc: unsupported codec: {opts.codec}")
    native_codec, depth = native
    n = len(raw)
    block_size = choose_block_size(n, opts.type_size, opts.block_size)
    slots, slot, sizes, memcpy_flags = _native.compress_slots(
        raw, block_size, opts.type_size, int(opts.shuffle),
        native_codec, depth, num_threads=opts.num_threads,
    )
    return assemble_split_frame(opts, n, block_size, slots, slot, sizes,
                                memcpy_flags)


def assemble_split_frame(opts: Options, n: int, block_size: int,
                         slots: np.ndarray, slot: int, sizes: np.ndarray,
                         memcpy_flags: np.ndarray) -> bytes:
    """Header, block table and payloads of ``compress_slots``' output."""
    entries = [
        int(s) | (ENTRY_MEMCPY if m else 0) for s, m in zip(sizes, memcpy_flags)
    ]
    prefix = split_header(opts, n, block_size, entries, int(sizes.sum()))
    return _native.gather_frame(prefix, slots, slot, sizes)


def parse_block_table(raw: bytes, header: Header) -> tuple[list[tuple[int, bool]], int]:
    """Return [(payload_size, is_memcpy), ...] and the payload start offset."""
    if len(raw) < HEADER_SIZE + 4:
        raise InvalidDataError("blosc: invalid compressed data: truncated block table")
    (num_blocks,) = struct.unpack_from("<I", raw, HEADER_SIZE)
    table_end = HEADER_SIZE + 4 + 4 * num_blocks
    if num_blocks == 0 or table_end > len(raw) or table_end > header.nbytes_comp:
        raise InvalidDataError("blosc: invalid compressed data: bad block count")
    entries = struct.unpack_from(f"<{num_blocks}I", raw, HEADER_SIZE + 4)
    out = [(e & ENTRY_SIZE_MASK, bool(e & ENTRY_MEMCPY)) for e in entries]
    return out, table_end


def validate_block_layout(n: int, block_size: int, num_blocks: int) -> None:
    """The block table must cover nbytes_orig exactly."""
    if block_size == 0:
        raise InvalidDataError("blosc: invalid compressed data: zero block size")
    expected_blocks = -(-n // block_size) if n else 0
    if num_blocks != expected_blocks:
        raise InvalidDataError(
            f"blosc: invalid compressed data: {num_blocks} blocks for "
            f"{n} bytes at block size {block_size}"
        )


def payload_offsets(entries: list[tuple[int, bool]], offset: int):
    """(offsets, sizes, is_memcpy) arrays of the payloads, for the native
    block decoder."""
    psizes = np.array([s for s, _ in entries], dtype=np.int64)
    offsets = np.zeros_like(psizes)
    np.cumsum(psizes[:-1], out=offsets[1:])
    offsets += offset
    is_memcpy = np.array([m for _, m in entries], dtype=np.uint8)
    return offsets, psizes, is_memcpy


def decompress_chunked_native(raw: bytes, header: Header,
                              entries: list[tuple[int, bool]], offset: int,
                              type_size: int, native_codec: int,
                              out_addr: int | None = None, lo_b: int = 0,
                              hi_b: int | None = None) -> bytes | int:
    """Native decode of blocks [lo_b, hi_b] (default: every block); with
    ``out_addr`` the bytes go there and the byte count is returned.  A
    whole-frame decode validates the block layout here; a sub-range caller
    (decompress_block_run) validates it once at its entry point."""
    n = header.nbytes_orig
    block_size = header.block_size
    if hi_b is None:
        validate_block_layout(n, block_size, len(entries))
        hi_b = len(entries) - 1
    sub = entries[lo_b : hi_b + 1]
    base = offset + sum(s for s, _ in entries[:lo_b])
    offsets, psizes, is_memcpy = payload_offsets(sub, base)
    end = int(offsets[-1] + psizes[-1])
    if end > header.nbytes_comp or end > len(raw):
        raise InvalidDataError(
            "blosc: invalid compressed data: block payload overruns frame"
        )
    for k, (psz, m) in enumerate(sub):
        if m and psz != min(block_size, n - (lo_b + k) * block_size):
            raise SizeMismatchError(
                f"blosc: decompressed size mismatch in memcpy block {lo_b + k}"
            )
    cover = min(n, (hi_b + 1) * block_size) - lo_b * block_size
    try:
        return _native.decompress_blocks(
            np.frombuffer(raw, dtype=np.uint8), offsets, psizes, is_memcpy,
            block_size, cover, type_size, int(header.shuffle_mode), native_codec,
            out_addr=out_addr,
        )
    except DecompressionFailedError:
        raise DecompressionFailedError(
            "blosc: decompression failed: malformed block payload"
        ) from None


def decompress_single_block(raw: bytes, header: Header,
                            entries: list[tuple[int, bool]], poff: int,
                            bi: int, type_size: int) -> bytes:
    """Decode block ``bi`` alone, its payload at ``poff``
    (≙ tpu_blosc/chunk.py:385-432).  The caller validated the layout."""
    n = header.nbytes_orig
    this_block = min(header.block_size, n - bi * header.block_size)
    psize, is_memcpy = entries[bi]
    if poff + psize > header.nbytes_comp or poff + psize > len(raw):
        raise InvalidDataError(
            "blosc: invalid compressed data: block payload overruns frame"
        )
    if is_memcpy:
        if psize != this_block:
            raise SizeMismatchError(
                f"blosc: decompressed size mismatch in memcpy block {bi}"
            )
        return bytes(raw[poff : poff + psize])
    native = native_pipeline_codec(header.codec, 1)
    if native is None:
        raise InvalidCodecError(f"blosc: unsupported codec: {header.codec}")
    return _native.decompress_frame(
        bytes(raw), poff, psize, this_block, type_size, int(header.shuffle_mode), native[0]
    )


def decompress_block_run(raw: bytes, header: Header,
                         entries: list[tuple[int, bool]], offset: int,
                         lo_b: int, hi_b: int, type_size: int) -> bytes:
    """Decode blocks [lo_b, hi_b] into one bytes: runs of 4 or more in one
    parallel native call, shorter runs block by block
    (≙ tpu_blosc/chunk.py:435-463)."""
    native = native_pipeline_codec(header.codec, 1)
    if native is not None and hi_b - lo_b + 1 >= 4:
        return decompress_chunked_native(
            raw, header, entries, offset, type_size, native[0], lo_b=lo_b, hi_b=hi_b,
        )
    parts = []
    poff = offset + sum(s for s, _ in entries[:lo_b])
    for bi in range(lo_b, hi_b + 1):
        parts.append(decompress_single_block(raw, header, entries, poff, bi, type_size))
        poff += entries[bi][0]
    return b"".join(parts)


def decompress_chunked(raw: bytes, header: Header, type_size: int) -> bytes:
    """Decompress a FLAG_SPLIT frame."""
    entries, offset = parse_block_table(raw, header)
    if type_size <= 0:
        type_size = header.type_size
    validate_block_layout(header.nbytes_orig, header.block_size, len(entries))
    native = native_pipeline_codec(header.codec, 1)
    if native is None:
        raise InvalidCodecError(f"blosc: unsupported codec: {header.codec}")
    return decompress_chunked_native(
        raw, header, entries, offset, type_size, native[0]
    )
