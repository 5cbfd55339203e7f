"""Blosc frame format: header pack/parse, flags, codec and shuffle enums.

Counterpart: ``tpu_blosc/format.py:30-173``.  The 16-byte little-endian
header:

    byte  0      Version      (must == 2)
    byte  1      VersionLZ    codec ID
    byte  2      Flags        0x1 byte-shuffle, 0x2 memcpy, 0x4 bit-shuffle,
                              0x8 split (multi-block frame with block table)
    byte  3      TypeSize     uint8 element size for shuffle
    bytes 4-7    NBytesOrig   uint32 LE original size
    bytes 8-11   BlockSize    uint32 LE block size
    bytes 12-15  NBytesComp   uint32 LE total compressed size INCLUDING header

Multi-block (FLAG_SPLIT) frames carry a per-block table after the header;
see chunk.py.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass

from .errors import InvalidHeaderError, InvalidVersionError

VERSION = "1.1.0"
FORMAT_VERSION = 2
HEADER_SIZE = 16
MIN_HEADER_SIZE = 16
MAX_UINT32 = 0xFFFFFFFF

_HEADER_STRUCT = struct.Struct("<BBBBIII")


class Codec(enum.IntEnum):
    """Compression codec identifiers (≙ tpu_blosc/format.py:39-51)."""

    BLOSCLZ = 0
    LZ4 = 1
    LZ4HC = 2
    SNAPPY = 3
    ZLIB = 4
    ZSTD = 5

    def __str__(self) -> str:
        return self.name.lower()


class Shuffle(enum.IntEnum):
    """Shuffle mode for byte/bit reordering (≙ tpu_blosc/format.py:64-74)."""

    NOSHUFFLE = 0x0
    SHUFFLE = 0x1
    BITSHUFFLE = 0x2

    def __str__(self) -> str:
        return self.name.lower()


FLAG_SHUFFLE = 0x1
FLAG_MEMCPY = 0x2
FLAG_BITSHUFFLE = 0x4
FLAG_SPLIT = 0x8


@dataclass
class Header:
    """The 16-byte Blosc frame header (≙ tpu_blosc/format.py:84-138)."""

    version: int = FORMAT_VERSION
    version_lz: int = 0  # codec ID
    flags: int = 0
    type_size: int = 1
    nbytes_orig: int = 0
    block_size: int = 0
    nbytes_comp: int = 0

    def to_bytes(self) -> bytes:
        """Serialize to 16 little-endian bytes."""
        return _HEADER_STRUCT.pack(
            self.version & 0xFF,
            self.version_lz & 0xFF,
            self.flags & 0xFF,
            self.type_size & 0xFF,
            self.nbytes_orig & MAX_UINT32,
            self.block_size & MAX_UINT32,
            self.nbytes_comp & MAX_UINT32,
        )

    @property
    def has_shuffle(self) -> bool:
        return bool(self.flags & FLAG_SHUFFLE)

    @property
    def has_bitshuffle(self) -> bool:
        return bool(self.flags & FLAG_BITSHUFFLE)

    @property
    def is_memcpy(self) -> bool:
        return bool(self.flags & FLAG_MEMCPY)

    @property
    def is_split(self) -> bool:
        return bool(self.flags & FLAG_SPLIT)

    @property
    def shuffle_mode(self) -> Shuffle:
        """BitShuffle wins when both flags are set."""
        if self.has_bitshuffle:
            return Shuffle.BITSHUFFLE
        if self.has_shuffle:
            return Shuffle.SHUFFLE
        return Shuffle.NOSHUFFLE

    @property
    def codec(self) -> int:
        return self.version_lz


def parse_header(data: bytes | bytearray | memoryview) -> Header:
    """Parse a Blosc header (≙ tpu_blosc/format.py:141-173).

    Raises InvalidHeaderError on short input, InvalidVersionError when
    byte 0 != 2.
    """
    if len(data) < HEADER_SIZE:
        raise InvalidHeaderError(
            f"blosc: invalid header: need {HEADER_SIZE} bytes, got {len(data)}"
        )
    fields = _HEADER_STRUCT.unpack_from(bytes(data[:HEADER_SIZE]))
    if fields[0] != FORMAT_VERSION:
        raise InvalidVersionError(
            f"blosc: unsupported format version: got {fields[0]}, "
            f"expected {FORMAT_VERSION}"
        )
    return Header(*fields)
