"""The six standard codecs, registered at import.

Counterpart: ``tpu_blosc/codecs/standard.py:41-228``, with the same
objects, names and level mapping:

  BloscLZ, LZ4 — level ignored
  LZ4HC  — 1-3 / 4-5 / 6-7 / 8-9 chain-depth tiers
  ZLIB   — passthrough 1-9
  ZSTD   — 1-2 fastest / 3-4 default / 5-6 better / 7-9 best
  Snappy — no levels

Each object but ZLIB's and ZSTD's calls the native library
(``native/backend.py``), or, on the route without a native build
(``TPU_BLOSC_NO_NATIVE=1``), its pure-Python version (``lz4_ref``,
``snappy_ref``, ``blosclz_ref``), chosen on each call as in
``tpu_blosc/codecs/standard.py:32-105``.  ZLIB runs CPython's ``zlib``;
ZSTD runs ``zstandard``, and is registered only where that module
imports.  With it missing, ``is_builtin(ZSTD)`` still holds (no entry is
the builtin entry), so the native ZSTD pipeline keeps working, as in the
JAX package; on the route without a native build ZSTD then has no codec
and raises InvalidCodecError, as there.
"""

from __future__ import annotations

import io
import threading
import zlib as _zlib

from ..errors import CompressionFailedError, DecompressionFailedError
from ..format import Codec
from ..native import backend as _native
from . import blosclz_ref, lz4_ref, snappy_ref
from .lz4_ref import hc_depth_for_level
from .registry import get_codec, register_codec


class BloscLzCodec:
    """BloscLZ (codec ID 0); level ignored."""

    def name(self) -> str:
        return "blosclz"

    def compress(self, data: bytes, level: int) -> bytes:
        if _native.available():
            return _native.blosclz_compress(data)
        return blosclz_ref.compress(data)

    def decompress(self, data: bytes, expected_size: int) -> bytes:
        if _native.available():
            return _native.blosclz_decompress(data, expected_size)
        return blosclz_ref.decompress(data, expected_size)


class Lz4Codec:
    """LZ4 block codec; level ignored."""

    def name(self) -> str:
        return "lz4"

    def compress(self, data: bytes, level: int) -> bytes:
        if _native.available():
            return _native.lz4_compress(data, depth=1)
        return lz4_ref.compress_block(data, max_search_depth=1)

    def decompress(self, data: bytes, expected_size: int) -> bytes:
        if _native.available():
            return _native.lz4_decompress(data, expected_size)
        return lz4_ref.decompress_block(data, expected_size)


class Lz4HcCodec:
    """LZ4 with a deeper match search; decodes as LZ4."""

    def name(self) -> str:
        return "lz4hc"

    def compress(self, data: bytes, level: int) -> bytes:
        depth = hc_depth_for_level(level)
        if _native.available():
            return _native.lz4_compress(data, depth=depth)
        return lz4_ref.compress_block(data, max_search_depth=depth)

    def decompress(self, data: bytes, expected_size: int) -> bytes:
        if _native.available():
            return _native.lz4_decompress(data, expected_size)
        return lz4_ref.decompress_block(data, expected_size)


class SnappyCodec:
    """Raw Snappy; no levels."""

    def name(self) -> str:
        return "snappy"

    def compress(self, data: bytes, level: int) -> bytes:
        if _native.available():
            return _native.snappy_compress(data)
        return snappy_ref.compress(data)

    def decompress(self, data: bytes, expected_size: int) -> bytes:
        if _native.available():
            return _native.snappy_decompress(data, expected_size)
        return snappy_ref.decompress(data, expected_size)


class ZlibCodec:
    """ZLIB/deflate through CPython's zlib; levels pass through."""

    def name(self) -> str:
        return "zlib"

    def compress(self, data: bytes, level: int) -> bytes:
        if not 1 <= level <= 9:
            raise CompressionFailedError(f"zlib: invalid compression level {level}")
        return _zlib.compress(bytes(data), level)

    def decompress(self, data: bytes, expected_size: int) -> bytes:
        try:
            return _zlib.decompress(bytes(data))
        except _zlib.error as exc:
            raise DecompressionFailedError(f"zlib: {exc}") from exc


class ZstdCodec:
    """Zstandard with one cached compressor per speed tier (zstd levels
    1/3/9/19) and one decompressor per thread (an instance is not safe to
    share between threads)."""

    _TIER_LEVELS = (1, 3, 9, 19)

    def __init__(self) -> None:
        try:
            import zstandard as zstd
        except ImportError:
            raise RuntimeError("zstandard module unavailable") from None
        self._zstd = zstd
        self._encoders = [zstd.ZstdCompressor(level=lv) for lv in self._TIER_LEVELS]
        self._local = threading.local()

    def _decoder(self):
        d = getattr(self._local, "d", None)
        if d is None:
            d = self._local.d = self._zstd.ZstdDecompressor()
        return d

    def name(self) -> str:
        return "zstd"

    @staticmethod
    def _tier(level: int) -> int:
        return 0 if level <= 2 else 1 if level <= 4 else 2 if level <= 6 else 3

    def compress(self, data: bytes, level: int) -> bytes:
        return self._encoders[self._tier(level)].compress(bytes(data))

    def decompress(self, data: bytes, expected_size: int) -> bytes:
        # across frames, as the native decoder reads them; one byte past
        # the expected size makes a trailing frame a size mismatch
        try:
            return self._decoder().stream_reader(
                io.BytesIO(bytes(data)), read_across_frames=True
            ).read(expected_size + 1)
        except self._zstd.ZstdError as exc:
            raise DecompressionFailedError(f"zstd: {exc}") from exc


# The instances register_standard_codecs installed; the native pipeline
# serves an ID only while the registry still maps it to its builtin
# instance (a register_codec override must win).
_BUILTIN_INSTANCES: dict[int, object] = {}


def register_standard_codecs() -> None:
    pairs = [
        (Codec.BLOSCLZ, BloscLzCodec()),
        (Codec.LZ4, Lz4Codec()),
        (Codec.LZ4HC, Lz4HcCodec()),
        (Codec.SNAPPY, SnappyCodec()),
        (Codec.ZLIB, ZlibCodec()),
    ]
    try:
        pairs.append((Codec.ZSTD, ZstdCodec()))
    except RuntimeError:
        pass  # no zstandard: ZSTD stays native-only
    for cid, impl in pairs:
        _BUILTIN_INSTANCES[int(cid)] = impl
        register_codec(cid, impl)


def is_builtin(codec_id: int) -> bool:
    """True when the registry entry of ``codec_id`` is the builtin one."""
    return get_codec(codec_id) is _BUILTIN_INSTANCES.get(int(codec_id))


register_standard_codecs()
