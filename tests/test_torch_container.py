"""The port's TPB2 container against the JAX package's, on the CPU.

After tests/test_container.py, with a small ``frame_limit`` so that
containers of a few sub-frames stay small; the 4 GiB + 1 MiB case stays
the JAX package's.  Containers are compared byte for byte, and each
package reads the other's.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc import container as jc
from tpu_blosc.options import Options as JOptions
from tpu_blosc_torch import container as tc


def _opts(**kw):
    jkw, tkw = dict(kw), dict(kw)
    for key, enum in (("codec", "Codec"), ("shuffle", "Shuffle")):
        if key in kw:
            jkw[key] = getattr(jb, enum)[kw[key]]
            tkw[key] = getattr(tb, enum)[kw[key]]
    return JOptions(**jkw), tb.Options(**tkw)


@pytest.mark.parametrize(
    "kw,limit",
    [
        (dict(block_size=16384), 65536),
        (dict(codec="ZSTD", type_size=4), 65536),
        (dict(shuffle="BITSHUFFLE", type_size=8), 1000),  # aligned down to 960
        (dict(shuffle="NOSHUFFLE", type_size=1), 30_000),
    ],
)
def test_container_same_bytes_and_cross_read(kw, limit):
    data = np.arange(100_000, dtype=np.float32).tobytes()
    jo, to = _opts(**kw)
    mine = tc.compress_container(data, to, frame_limit=limit)
    theirs = jc.compress_container(data, jo, frame_limit=limit)
    assert mine == theirs
    assert tc.is_container(mine)
    assert tb.decompress(theirs) == data
    assert tc.decompress_container(theirs) == data
    assert jb.decompress(mine) == data


def test_container_info():
    data = np.arange(50_000, dtype=np.float32).tobytes()
    comp = tc.compress_container(data, tb.Options(codec=tb.Codec.ZSTD), frame_limit=65536)
    info = tb.get_info(comp)
    assert info.is_container
    assert info.codec == int(tb.Codec.ZSTD)
    assert info.nbytes_orig == len(data)
    assert info.num_frames == -(-len(data) // 65536)
    assert tb.get_decompressed_size(comp) == len(data)
    assert tb.get_info(comp) == tc.ContainerInfo(*jb.get_info(comp).__dict__.values())


def test_container_frame_alignment_respects_type_size():
    data = np.arange(3000, dtype=np.float64).tobytes()
    comp = tc.compress_container(
        data, tb.Options(type_size=8, shuffle=tb.Shuffle.BITSHUFFLE), frame_limit=1000
    )
    _, _, _, _, total, sizes, _ = tc.parse_container(comp)
    assert total == len(data)
    assert len(sizes) == -(-len(data) // 960)
    assert tb.decompress(comp) == data


def test_container_magic_never_collides_with_frames():
    frame = tb.compress_with_options(b"hello world" * 10,
                                     tb.Options(shuffle=tb.Shuffle.NOSHUFFLE, type_size=1))
    assert not tc.is_container(frame)
    with pytest.raises(tb.BloscError):
        tc.parse_container(frame)


def test_container_malformed():
    data = np.arange(10_000, dtype=np.float32).tobytes()
    comp = tc.compress_container(data, tb.Options(), frame_limit=8192)
    with pytest.raises(tb.InvalidHeaderError):
        tc.parse_container(b"TPB2\x07" + comp[5:])
    with pytest.raises(tb.BloscError):
        tb.decompress(comp[: len(comp) // 2])
    with pytest.raises(tb.BloscError):
        tc.decompress_container(comp[:16])


def test_container_type_size_override_roundtrip():
    data = np.arange(20_000, dtype=np.float32).tobytes()
    comp = tc.compress_container(data, tb.Options(type_size=4), frame_limit=16384)
    assert tb.decompress_with_size(comp, 4) == data
    assert tb.decompress_with_size(comp, 4) == jb.decompress_with_size(comp, 4)


def test_container_forged_total_rejected_before_allocation():
    data = bytes(range(256)) * 64
    blob = bytearray(tc.compress_container(data, tb.Options(), frame_limit=4096))
    blob[8:16] = struct.pack("<Q", 1 << 50)
    with pytest.raises(tb.BloscError):
        tc.decompress_container(bytes(blob))
    blob[8:16] = struct.pack("<Q", len(data))
    assert tc.decompress_container(bytes(blob)) == data


def test_container_decodes_into_and_by_range():
    data = np.arange(60_000, dtype=np.int32).tobytes()
    comp = tc.compress_container(data, tb.Options(block_size=8192), frame_limit=50_000)
    buf = bytearray(len(data))
    assert tb.decompress_into(comp, buf) == len(data) and bytes(buf) == data
    for start, size in ((0, 10), (49_990, 30), (70_000, 100_000), (0, len(data))):
        want = data[start : start + size]
        assert tb.decompress_range(comp, start, size) == want
        assert jb.decompress_range(comp, start, size) == want
    with pytest.raises(tb.SizeMismatchError):
        tb.decompress_range(comp, len(data) - 4, 8)


def test_compress_with_options_routes_past_the_frame_limit(monkeypatch):
    """Inputs past FRAME_SAFE_LIMIT go into a container, as in
    tpu_blosc/api.py:186-189 (here with the limit lowered)."""
    data = np.arange(40_000, dtype=np.float32).tobytes()
    monkeypatch.setattr(tb.api, "FRAME_SAFE_LIMIT", 100_000)
    comp = tb.compress_with_options(data, tb.Options())
    assert tc.is_container(comp)
    assert comp == tc.compress_container(data, tb.Options())
    assert tb.decompress(comp) == data
