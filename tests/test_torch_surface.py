"""The port's quick-start surface against the JAX package's, on the CPU.

``import tpu_blosc_torch as blosc; blosc.compress(data, blosc.LZ4, 5,
blosc.SHUFFLE, 4)`` must work as tpu_blosc's quick-start does
(tpu_blosc/__init__.py:11-16): compress and compress_batch give
tpu_blosc's frames byte for byte and each package decodes the other's,
the constants and aliases are equal, the in-place buffer filters give the
same bytes, and the names tpu_blosc exports that the port does not are
exactly those whose modules are not ported yet.  Every comparison is
exact.
"""

from __future__ import annotations

import numpy as np
import pytest

import tpu_blosc as jb
import tpu_blosc_torch as tb

# names of tpu_blosc.__all__ whose modules (stats.py, the codec registry)
# the port does not have yet; the change that ports one shortens this list
QUEUED = {"CompressionStats", "FrameStats", "compress_with_stats", "frame_stats",
          "get_codec", "list_codecs", "register_codec"}

CODECS = ["LZ4", "LZ4HC", "ZSTD", "ZLIB", "BLOSCLZ", "SNAPPY"]
SHUFFLES = ["NOSHUFFLE", "SHUFFLE", "BITSHUFFLE"]


def _data(n: int, seed: int) -> bytes:
    """n bytes: a float32 random walk (compressible once shuffled), cut."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.integers(-3, 4, n // 4 + 1)).astype(np.float32)
    return walk.tobytes()[:n]


def test_the_quick_start_round_trips_and_equals_tpu_blosc():
    data = b"x" * 4096
    frame = tb.compress(data, tb.LZ4, 5, tb.SHUFFLE, 4)
    assert tb.decompress(frame) == data
    assert frame == jb.compress(data, jb.LZ4, 5, jb.SHUFFLE, 4)
    assert tb.compress(data) == jb.compress(data) == tb.compress_with_options(
        data, tb.default_options())


@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("n,type_size", [(1, 4), (4099, 4), (100_000, 8), (5 << 20, 2)])
def test_compress_equals_tpu_blosc(codec, shuffle, n, type_size):
    """Single-block frames, one with a ragged tail, and a multi-block one
    (above AUTO_BLOCK_THRESHOLD); level 11 is clamped to 9 by both."""
    data = _data(n, seed=n + type_size)
    level = 11 if n == 4099 else 5
    mine = tb.compress(data, tb.Codec[codec], level, tb.Shuffle[shuffle], type_size)
    theirs = jb.compress(data, jb.Codec[codec], level, jb.Shuffle[shuffle], type_size)
    assert mine == theirs
    assert jb.decompress(mine) == data
    assert tb.decompress(theirs) == data


@pytest.mark.parametrize("item", ["bytearray", "memoryview", "ndarray"])
def test_compress_takes_what_tpu_blosc_takes(item):
    arr = np.frombuffer(_data(40_000, 3), dtype=np.float32)
    data = {"bytearray": bytearray(arr.tobytes()), "memoryview": memoryview(arr.tobytes()),
            "ndarray": arr}[item]
    assert tb.compress(data, tb.ZSTD, 3, tb.BITSHUFFLE, 4) == jb.compress(
        data, jb.ZSTD, 3, jb.BITSHUFFLE, 4)


def test_compress_refuses_empty_input_as_tpu_blosc_does():
    with pytest.raises(tb.InvalidDataError):
        tb.compress(b"")
    with pytest.raises(jb.InvalidDataError):
        jb.compress(b"")
    with pytest.raises(tb.InvalidDataError, match="batch item 1"):
        tb.compress_batch([b"abcd", b""])


@pytest.mark.parametrize("codec,shuffle,type_size", [
    ("LZ4", "SHUFFLE", 4), ("ZSTD", "BITSHUFFLE", 8), ("LZ4HC", "NOSHUFFLE", 1),
    ("ZLIB", "SHUFFLE", 2),
])
def test_compress_batch_equals_tpu_blosc(codec, shuffle, type_size):
    """Small items, an ndarray, and one above AUTO_BLOCK_THRESHOLD: the
    frames of tpu_blosc.compress_batch and of compress, item by item."""
    items = [_data(n, seed=n) for n in (7, 1000, 65_536, 100_003)]
    items.append(np.frombuffer(_data(80_000, 9), dtype=np.float64))
    items.append(_data((4 << 20) + 4096, seed=1))
    args = (tb.Codec[codec], 5, tb.Shuffle[shuffle], type_size)
    mine = tb.compress_batch(items, *args)
    theirs = jb.compress_batch(items, jb.Codec[codec], 5, jb.Shuffle[shuffle], type_size)
    assert mine == theirs
    assert mine == [tb.compress(x, *args) for x in items]
    raw = [x.tobytes() if isinstance(x, np.ndarray) else x for x in items]
    assert tb.decompress_batch(theirs) == raw
    assert jb.decompress_batch(mine) == raw
    assert tb.compress_batch([], *args) == []


def test_constants_and_aliases_equal_tpu_blosc():
    for name in ("VERSION", "__version__", "FORMAT_VERSION", "HEADER_SIZE", "MIN_HEADER_SIZE",
                 "FLAG_SHUFFLE", "FLAG_MEMCPY", "FLAG_BITSHUFFLE", "FLAG_SPLIT",
                 "AUTO_BLOCK_THRESHOLD"):
        assert getattr(tb, name) == getattr(jb, name), name
    for name in CODECS:
        assert getattr(tb, name) is tb.Codec[name]
        assert int(getattr(tb, name)) == int(getattr(jb, name))
    for name in SHUFFLES:
        assert getattr(tb, name) is tb.Shuffle[name]
        assert int(getattr(tb, name)) == int(getattr(jb, name))
    mine, theirs = tb.default_options(), jb.default_options()
    assert isinstance(mine, tb.Options)
    for field in ("codec", "level", "shuffle", "type_size", "block_size", "num_threads"):
        assert getattr(mine, field) == getattr(theirs, field), field


def test_header_and_parse_header_equal_tpu_blosc():
    frame = tb.compress(_data(10_000, 5), tb.ZSTD, 7, tb.BITSHUFFLE, 8)
    mine, theirs = tb.parse_header(frame), jb.parse_header(frame)
    assert isinstance(mine, tb.Header) and mine == tb.get_info(frame)
    for field in ("version", "version_lz", "flags", "type_size", "nbytes_orig", "block_size",
                  "nbytes_comp"):
        assert getattr(mine, field) == getattr(theirs, field), field
    assert mine.flags & tb.FLAG_BITSHUFFLE and not mine.flags & tb.FLAG_SPLIT
    assert mine.to_bytes() == theirs.to_bytes() == frame[: tb.HEADER_SIZE]


@pytest.mark.parametrize("kind", ["bytearray", "ndarray"])
@pytest.mark.parametrize("mode", SHUFFLES)
@pytest.mark.parametrize("n,type_size", [(4096, 4), (1003, 8), (37, 2), (64, 1)])
def test_buffer_filters_equal_tpu_blosc(n, type_size, mode, kind):
    """shuffle_buffer and unshuffle_buffer change a bytearray or a uint8
    array in place, to tpu_blosc's bytes, and undo each other; NOSHUFFLE
    leaves the buffer as it is."""
    raw = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    make = (lambda: bytearray(raw.tobytes())) if kind == "bytearray" else raw.copy
    mine, theirs = make(), make()
    assert tb.shuffle_buffer(mine, type_size, tb.Shuffle[mode]) is None
    jb.shuffle_buffer(theirs, type_size, jb.Shuffle[mode])
    assert bytes(mine) == bytes(theirs)
    if mode == "NOSHUFFLE":
        assert bytes(mine) == raw.tobytes()
    else:
        whole = {"SHUFFLE": tb.shuffle_bytes, "BITSHUFFLE": tb.bit_shuffle}[mode]
        assert bytes(mine) == whole(raw, type_size).tobytes()
    tb.unshuffle_buffer(mine, type_size, tb.Shuffle[mode])
    jb.unshuffle_buffer(theirs, type_size, jb.Shuffle[mode])
    assert bytes(mine) == bytes(theirs) == raw.tobytes()


@pytest.mark.parametrize("name", ["shuffle_bytes", "unshuffle_bytes", "bit_shuffle",
                                  "bit_unshuffle"])
def test_whole_buffer_filters_are_exported_and_equal_tpu_blosc(name):
    raw = np.random.default_rng(8).integers(0, 256, 8 * 4 * 33 + 5, dtype=np.uint8)
    assert np.array_equal(getattr(tb, name)(raw, 4), getattr(jb, name)(raw, 4))


def test_the_names_still_missing_are_exactly_the_queued_modules():
    assert set(jb.__all__) - set(tb.__all__) == QUEUED
    for name in tb.__all__:
        assert hasattr(tb, name), name
    assert len(set(tb.__all__)) == len(tb.__all__)
