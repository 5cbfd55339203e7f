"""Multi-block (FLAG_SPLIT) frames on the native host codec.

Counterpart: ``tpu_blosc/chunk.py``: ``choose_block_size`` (:124-133),
``_native_pipeline_codec`` with its memo (:62-110), ``compress_chunked``
(:156-247), ``parse_block_table`` (:289-299),
``_decompress_chunked_native`` and ``_validate_block_layout``
(:302-382), the range decoders ``decompress_single_block`` and
``decompress_block_run`` (:385-463) and ``decompress_chunked`` (:466-517).

Layout after the 16-byte header (FLAG_SPLIT set):

    bytes 16-19  num_blocks (uint32)
    then         num_blocks x uint32: bits 0-30 payload size,
                 bit 31 = block stored memcpy (raw, unfiltered)
    then         the payloads, in block order

Codec IDs whose registry entry is the builtin codec run the native
pipeline; any other registered codec (a new ID, or one registered in
place of a builtin) is called on each block, with the memcpy fallback,
as in the JAX package (codecs/registry.py).  An ID with no codec raises
InvalidCodecError.  On the route without a native build
(``TPU_BLOSC_NO_NATIVE=1``) every ID takes that per-block route, the
builtin codecs in pure Python, as ``tpu_blosc/chunk.py:88-89`` does when
its library is missing; the host filters of its blocks then run the
plain versions (``filters/reference.py``).
"""

from __future__ import annotations

import struct

import numpy as np

from . import filters
from .codecs.registry import get_codec, registry_version
from .codecs.standard import hc_depth_for_level, is_builtin
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


_resolve_cache: dict = {}


def native_pipeline_codec(codec: int, level: int) -> tuple[int, int] | None:
    """Frame codec ID -> (native pipeline codec, level or depth), or None
    when the registry entry of the ID is not its builtin codec (an ID the
    native library lacks, or one a register_codec call took over) or the
    native library is off.

    LZ4 ignores the level, LZ4HC maps it to a chain depth, ZLIB passes it
    through and ZSTD maps it to the zstd levels 1/3/9/19.  Memoized on the
    registry's version.
    """
    key = (codec, level, registry_version())
    try:
        return _resolve_cache[key]
    except KeyError:
        pass
    if len(_resolve_cache) > 256:  # registry churn; stay bounded
        _resolve_cache.clear()
    result = _resolve_cache[key] = _native_pipeline_codec(codec, level)
    return result


def _native_pipeline_codec(codec: int, level: int) -> tuple[int, int] | None:
    if not _native.available() or not is_builtin(codec):
        return None
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


def registered_codec(codec_id: int, what=None):
    """The codec registered under ``codec_id``; InvalidCodecError naming
    ``what`` (default the ID) when there is none."""
    impl = get_codec(codec_id)
    if impl is None:
        raise InvalidCodecError(
            f"blosc: unsupported codec: {codec_id if what is None else what}")
    return impl


def filter_block(block, type_size: int, mode: int) -> bytes:
    """The host filter of ``mode`` over one block; unfiltered (NOSHUFFLE,
    or one-byte elements) it is the block itself."""
    if mode in (Shuffle.SHUFFLE, Shuffle.BITSHUFFLE) and type_size > 1:
        return filters.filter_bytes(block, type_size, mode).tobytes()
    return bytes(block)


def unfilter_block(block, type_size: int, mode: int) -> bytes:
    """Inverse of filter_block."""
    if mode in (Shuffle.SHUFFLE, Shuffle.BITSHUFFLE) and type_size > 1:
        return filters.unfilter_bytes(block, type_size, mode).tobytes()
    return bytes(block)


def registry_payloads(filtered, block_size: int, opts: Options,
                      raw=None) -> tuple[list[bytes], list[bool]]:
    """(payloads, memcpy flags) of the registered codec of ``opts.codec``
    over each block of the filtered stream ``filtered``
    (≙ tpu_blosc/chunk.py:212-226, tpu_blosc/device.py:826-856).  A block
    the codec does not shrink is stored raw: its bytes from ``raw`` (the
    unfiltered stream) when given, else the block unfiltered back."""
    compressor = registered_codec(opts.codec)
    payloads: list[bytes] = []
    memf: list[bool] = []
    for pos in range(0, len(filtered), block_size):
        block = bytes(filtered[pos : pos + block_size])
        comp = compressor.compress(block, opts.level)
        if len(comp) >= len(block):
            payloads.append(bytes(raw[pos : pos + len(block)]) if raw is not None
                            else unfilter_block(block, opts.type_size, opts.shuffle))
            memf.append(True)
        else:
            payloads.append(bytes(comp))
            memf.append(False)
    return payloads, memf


def registry_blocks(raw, block_size: int, opts: Options) -> tuple[list[bytes], list[bool]]:
    """registry_payloads of the unfiltered stream ``raw``, each block
    filtered on the host first (≙ tpu_blosc/chunk.py:212-226)."""
    filtered = b"".join(filter_block(raw[i : i + block_size], opts.type_size, opts.shuffle)
                        for i in range(0, len(raw), block_size))
    return registry_payloads(filtered, block_size, opts, raw)


def registry_block(decompressor, payload, this_block: int, is_memcpy: bool, bi: int) -> bytes:
    """Block ``bi`` of a registered codec's frame, still filtered: its
    payload when it was stored raw, else the codec's decode; its size must
    be ``this_block``."""
    if is_memcpy:
        if len(payload) != this_block:
            raise SizeMismatchError(f"blosc: decompressed size mismatch in memcpy block {bi}")
        return bytes(payload)
    dec = decompressor.decompress(payload, this_block)
    if len(dec) != this_block:
        raise SizeMismatchError(
            f"blosc: decompressed size mismatch: block {bi} got {len(dec)}, "
            f"expected {this_block}"
        )
    return dec


def registry_blocks_decode(raw: bytes, header: Header, entries: list[tuple[int, bool]],
                           offset: int, out: np.ndarray) -> None:
    """The registered codec's decode of every block of a FLAG_SPLIT frame,
    its payloads from ``offset`` on, into the uint8 array ``out`` of
    ``nbytes_orig`` bytes, still filtered (blocks stored raw come back
    raw; ≙ tpu_blosc/chunk.py:475-517).  The caller validated the
    layout."""
    n, block_size = header.nbytes_orig, header.block_size
    decompressor = None
    if not all(m for _, m in entries):
        decompressor = registered_codec(header.codec)
    for i, (psize, is_memcpy) in enumerate(entries):
        if offset + psize > header.nbytes_comp or offset + psize > len(raw):
            raise InvalidDataError(
                "blosc: invalid compressed data: block payload overruns frame"
            )
        pos = i * block_size
        this_block = min(block_size, n - pos)
        block = registry_block(decompressor, raw[offset : offset + psize], this_block,
                               is_memcpy, i)
        out[pos : pos + this_block] = np.frombuffer(block, np.uint8)
        offset += psize


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
    n = len(raw)
    block_size = choose_block_size(n, opts.type_size, opts.block_size)
    native = native_pipeline_codec(opts.codec, opts.level)
    if native is None:  # the registry route
        return assemble_payload_frame(opts, n, block_size, *registry_blocks(raw, block_size, opts))
    native_codec, depth = native
    slots, slot, sizes, memcpy_flags = _native.compress_slots(
        raw, block_size, opts.type_size, int(opts.shuffle),
        native_codec, depth, num_threads=opts.num_threads,
    )
    return assemble_split_frame(opts, n, block_size, slots, slot, sizes,
                                memcpy_flags)


def assemble_payload_frame(opts: Options, n: int, block_size: int,
                           payloads: list[bytes], memf: list[bool]) -> bytes:
    """The FLAG_SPLIT frame of ``n`` bytes whose blocks are ``payloads``,
    in order (split_header checks the uint32 fields)."""
    entries = [len(p) | (ENTRY_MEMCPY if m else 0) for p, m in zip(payloads, memf)]
    prefix = split_header(opts, n, block_size, entries, sum(len(p) for p in payloads))
    return prefix + b"".join(payloads)


def assemble_split_frame(opts: Options, n: int, block_size: int,
                         slots: np.ndarray, slot: int, sizes: np.ndarray,
                         memcpy_flags: np.ndarray, tail=None) -> bytes:
    """Header, block table and payloads of ``compress_slots``' output;
    ``tail``, a (payload, memcpy flag) pair, is a last block compressed
    apart from the others."""
    entries = [
        int(s) | (ENTRY_MEMCPY if m else 0) for s, m in zip(sizes, memcpy_flags)
    ]
    payload_bytes = int(sizes.sum())
    if tail is not None:
        entries.append(tail[0].size | (ENTRY_MEMCPY if tail[1] else 0))
        payload_bytes += tail[0].size
    prefix = split_header(opts, n, block_size, entries, payload_bytes)
    return _native.gather_frame(prefix, slots, slot, sizes,
                                None if tail is None else tail[0])


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


def checked_payloads(raw, header: Header, entries: list[tuple[int, bool]],
                     offset: int, lo_b: int = 0, hi_b: int | None = None):
    """(offsets, sizes, is_memcpy, covered bytes) of blocks [lo_b, hi_b]
    (default: every block) for the native block decoder, the payloads
    checked against the frame and the blocks stored raw against their
    size.  The whole frame's block layout is validated here; a sub-range
    caller (decompress_block_run) validates it once at its entry point."""
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
    return offsets, psizes, is_memcpy, cover


def decompress_chunked_native(raw: bytes, header: Header,
                              entries: list[tuple[int, bool]], offset: int,
                              type_size: int, native_codec: int,
                              out_addr: int | None = None, lo_b: int = 0,
                              hi_b: int | None = None) -> bytes | int:
    """Native decode of blocks [lo_b, hi_b] (default: every block); with
    ``out_addr`` the bytes go there and the byte count is returned
    (checked_payloads validates them)."""
    offsets, psizes, is_memcpy, cover = checked_payloads(raw, header, entries, offset,
                                                         lo_b, hi_b)
    try:
        return _native.decompress_blocks(
            np.frombuffer(raw, dtype=np.uint8), offsets, psizes, is_memcpy,
            header.block_size, cover, type_size, int(header.shuffle_mode), native_codec,
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
    if native is not None:
        return _native.decompress_frame(
            bytes(raw), poff, psize, this_block, type_size, int(header.shuffle_mode), native[0]
        )
    block = registry_block(registered_codec(header.codec), raw[poff : poff + psize],
                           this_block, False, bi)
    return unfilter_block(block, type_size, header.shuffle_mode)


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
    n, block_size = header.nbytes_orig, header.block_size
    validate_block_layout(n, block_size, len(entries))
    native = native_pipeline_codec(header.codec, 1)
    if native is not None:
        return decompress_chunked_native(
            raw, header, entries, offset, type_size, native[0]
        )
    # the registry route: decode every block, then unfilter those not
    # stored raw (≙ tpu_blosc/chunk.py:475-517)
    out = np.empty(n, np.uint8)
    registry_blocks_decode(raw, header, entries, offset, out)
    for i, (_, is_memcpy) in enumerate(entries):
        if not is_memcpy:
            block = out[i * block_size : (i + 1) * block_size]
            block[:] = np.frombuffer(
                unfilter_block(block, type_size, header.shuffle_mode), np.uint8)
    return out.tobytes()
