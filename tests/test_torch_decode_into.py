"""``decompress_into`` of a plain single-block frame: one native call that
decodes straight into the caller's buffer.

A frame of a native codec with neither FLAG_SPLIT nor FLAG_MEMCPY goes to
``native.backend.decompress_frames_into`` (the batch entry that
``decompress_batch_into`` calls), with no intermediate ``bytes`` object;
every other frame, and every frame whose decode fails, takes
``decompress_with_size`` and copies its result, as before.  The first test
holds the direct decode to that path and to tpu_blosc's decode over the
native codecs, the three shuffle modes, four type sizes and three sizes
up to the largest single block (4 MiB), with a spy on
``backend.decompress_frame`` (the scalar path's decoder) that must see no
call, and sentinel bytes past the frame's size that must stay as they
were.  The second holds the frames the direct decode must not take, and
broken frames, to the outcome of ``decompress_with_size(frame, 0)``, the
line that decoded every single-block frame before: the same bytes, or the
same exception type and message.  Tolerance: equal bytes.
"""

from __future__ import annotations

import numpy as np
import pytest
from torch_registry import both_registries, make_codec
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc_torch import api
from tpu_blosc_torch.format import HEADER_SIZE, parse_header
from tpu_blosc_torch.native import backend

SIZES = {"100kb": 100_000, "1mib": 1 << 20, "4mib": 4 << 20}
SENTINEL = 0xA5


def _data(n: int, type_size: int, seed: int) -> bytes:
    """``n`` bytes of slowly rising little-endian integers of ``type_size``
    bytes with a little noise: every codec finds matches, no block is
    stored raw."""
    rng = np.random.default_rng(seed)
    count = n // type_size
    values = np.arange(count) // 7 + rng.integers(0, 4, count)
    return values.astype(f"<u{type_size}").tobytes()


def _frame(data: bytes, codec: str, shuffle: str, type_size: int) -> bytes:
    return tb.compress_with_options(data, tb.Options(
        codec=tb.Codec[codec], level=5, shuffle=tb.Shuffle[shuffle], type_size=type_size))


def _spy(monkeypatch) -> list:
    """Calls of the scalar path's single-block decoder."""
    calls: list = []
    real = backend.decompress_frame

    def spy(*args):
        calls.append(args[3])
        return real(*args)

    monkeypatch.setattr(backend, "decompress_frame", spy)
    return calls


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("type_size", [1, 2, 4, 8])
@pytest.mark.parametrize("shuffle", ["NOSHUFFLE", "SHUFFLE", "BITSHUFFLE"])
@pytest.mark.parametrize("codec", ["BLOSCLZ", "LZ4", "LZ4HC", "SNAPPY", "ZLIB", "ZSTD"])
def test_a_single_block_frame_decodes_straight_into_the_buffer(monkeypatch, codec, shuffle,
                                                               type_size, size):
    n = SIZES[size]
    data = _data(n, type_size, seed=type_size * 31 + n % 97)
    frame = _frame(data, codec, shuffle, type_size)
    header = parse_header(frame)
    assert not header.is_split and not header.is_memcpy and header.nbytes_orig == n
    want = api.decompress_with_size(frame, 0)
    assert want == data == jb.decompress(frame)
    out = np.full(n + 64, SENTINEL, dtype=np.uint8)
    calls = _spy(monkeypatch)
    assert api.decompress_into(frame, out) == n
    assert calls == []
    assert out[:n].tobytes() == want
    assert (out[n:] == SENTINEL).all()


def _patched(frame: bytes, offset: int, value: int) -> bytes:
    """The frame with the 32-bit header field at ``offset`` set to ``value``."""
    b = bytearray(frame)
    b[offset:offset + 4] = int(value).to_bytes(4, "little")
    return bytes(b)


def _truncated(frame: bytes) -> bytes:
    """The payload cut short, NBytesComp saying so: the header checks pass,
    the codec runs out of input."""
    cut = frame[: len(frame) - len(frame) // 3]
    return _patched(cut, 12, len(cut))


def _corrupt_token(frame: bytes) -> bytes:
    """The payload's first byte (LZ4's first token; ZSTD's frame magic)
    flipped."""
    b = bytearray(frame)
    b[HEADER_SIZE] ^= 0xFF
    return bytes(b)


N = 1 << 20
RAMP = _data(N, 4, seed=5)
NOISE = np.random.default_rng(6).integers(0, 256, N, dtype=np.uint8).tobytes()

# (frame, whether it must raise); the registry cases make their frames
# under the registry they install
CASES = {
    "memcpy": lambda: (_frame(NOISE, "LZ4", "SHUFFLE", 4), False),
    "memcpy-truncated": lambda: (_truncated(_frame(NOISE, "LZ4", "SHUFFLE", 4)), True),
    "registered-lz4": lambda: (_frame(RAMP, "LZ4", "SHUFFLE", 4), False),
    "registered-zlib": lambda: (_frame(RAMP, "ZLIB", "BITSHUFFLE", 4), False),
    "header-truncated": lambda: (_frame(RAMP, "LZ4", "SHUFFLE", 4)[:-100], True),
    "lz4-truncated": lambda: (_truncated(_frame(RAMP, "LZ4", "SHUFFLE", 4)), True),
    "zstd-truncated": lambda: (_truncated(_frame(RAMP, "ZSTD", "BITSHUFFLE", 4)), True),
    "nbytes-orig-short": lambda: (_patched(_frame(RAMP, "LZ4", "SHUFFLE", 4), 4, N - 4096),
                                  True),
    "nbytes-orig-long": lambda: (_patched(_frame(RAMP, "ZSTD", "SHUFFLE", 4), 4, N + 4096),
                                 True),
    "lz4-corrupt-token": lambda: (_corrupt_token(_frame(RAMP, "LZ4", "SHUFFLE", 4)), True),
    "zstd-corrupt-token": lambda: (_corrupt_token(_frame(RAMP, "ZSTD", "SHUFFLE", 4)), True),
}
REGISTERED = {"registered-lz4": (tb.Codec.LZ4, "counting-lz4"),
              "registered-zlib": (tb.Codec.ZLIB, "zlib1")}


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as err:  # the parity under test is the exception's
        return type(err), str(err)


def _check(case: str, monkeypatch):
    frame, raises = CASES[case]()
    n = int.from_bytes(frame[4:8], "little")
    want = _outcome(lambda: api.decompress_with_size(frame, 0))
    out = np.full(n + 64, SENTINEL, dtype=np.uint8)

    def into():
        assert api.decompress_into(frame, out) == n
        return out[:n].tobytes()

    got = _outcome(into)
    assert (want[0] != "ok") == raises, want
    assert got == want
    if not raises:
        assert (out[n:] == SENTINEL).all()
        calls = _spy(monkeypatch)
        api.decompress_into(frame, out)
        assert calls == []  # the registry or the memcpy path, not the native one


@pytest.mark.parametrize("case", sorted(CASES))
def test_frames_the_direct_decode_does_not_take_keep_their_outcome(monkeypatch, case):
    """Memcpy frames, a codec registered in place of a builtin, and broken
    frames: the bytes or the exception of ``decompress_with_size``."""
    if case not in REGISTERED:
        _check(case, monkeypatch)
        return
    codec_id, kind = REGISTERED[case]
    with both_registries() as register:
        impl = register(codec_id, make_codec(kind))
        _check(case, monkeypatch)
        if kind.startswith("counting"):
            assert impl.decompressed > 0
