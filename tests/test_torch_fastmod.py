"""The port's fastcall module (_tpbfast) against its ctypes route, on the CPU.

After tests/test_fastmod.py:34-81.  The module is a front door to the same
entry points of the port's library, so equality here is about the binding
layer: buffers, staging, allocation and the error paths.  ``compress()``
on the module writes tpu_blosc's frame, whose ``compress()`` takes a
memoized lane, and follows ``register_codec`` as it does.  Tolerance:
equal bytes.
"""

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig

import ml_dtypes
import numpy as np
import pytest
from torch_registry import both_registries, make_codec
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc_torch import api
from tpu_blosc_torch.errors import DecompressionFailedError, SizeMismatchError
from tpu_blosc_torch.native import backend

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ramp(n: int) -> bytes:
    """``i % 256`` (BASELINE.json config 1 at 100 KB)."""
    return (np.arange(n) % 256).astype(np.uint8).tobytes()


@pytest.fixture
def fast():
    """The fastcall module; Python's headers are present here."""
    assert os.path.exists(os.path.join(sysconfig.get_paths()["include"], "Python.h"))
    assert backend.fastcall_status() == "fastcall: loaded"
    return backend.fastmod()


@pytest.mark.parametrize("shuffle_mode", [0, 1, 2])
def test_compress_frame_matches_ctypes(monkeypatch, fast, shuffle_mode):
    data = _ramp(100 * 1024)
    got = backend.compress_frame(data, 4, shuffle_mode, 1, 1, 1)
    monkeypatch.setattr(backend, "_fast", None)
    assert backend.compress_frame(data, 4, shuffle_mode, 1, 1, 1) == got


def test_decompress_frame_matches_ctypes(monkeypatch, fast):
    data = np.arange(25000, dtype=np.float32).tobytes()
    frame = backend.compress_frame(data, 4, 1, 1, 1, 1)
    got = backend.decompress_frame(frame, 16, len(frame) - 16, len(data), 4, 1, 1)
    monkeypatch.setattr(backend, "_fast", None)
    assert backend.decompress_frame(frame, 16, len(frame) - 16, len(data), 4, 1, 1) == got == data


@pytest.mark.parametrize("wrap", [bytearray, memoryview, lambda d: np.frombuffer(d, np.uint8)])
def test_buffer_inputs(fast, wrap):
    data = _ramp(4096)
    assert backend.compress_frame(wrap(data), 4, 1, 1, 1, 1) == backend.compress_frame(
        data, 4, 1, 1, 1, 1)


def _errors(monkeypatch, call):
    """(type, message) of ``call()`` through the fastcall module and then
    through ctypes."""
    out = []
    for _ in range(2):
        with pytest.raises((DecompressionFailedError, SizeMismatchError)) as info:
            call()
        out.append((type(info.value), str(info.value)))
        monkeypatch.setattr(backend, "_fast", None)
    return out


def test_malformed_payload_raises_the_same_error(monkeypatch, fast):
    frame = backend.compress_frame(_ramp(4096), 4, 1, 1, 1, 1)
    fast_err, ctypes_err = _errors(monkeypatch, lambda: backend.decompress_frame(
        frame, 16, max(1, (len(frame) - 16) // 2), 4096, 4, 1, 1))
    assert fast_err == ctypes_err and fast_err[0] is DecompressionFailedError


def test_wrong_size_raises_the_same_error(monkeypatch, fast):
    frame = backend.compress_frame(_ramp(4096), 4, 0, 1, 1, 1)
    fast_err, ctypes_err = _errors(monkeypatch, lambda: backend.decompress_frame(
        frame, 16, len(frame) - 16, 5000, 4, 0, 1))
    assert fast_err == ctypes_err


def test_payload_range_validated(fast):
    with pytest.raises(ValueError):
        fast.decompress_frame(b"\x00" * 8, 4, 100, 16, 4, 0, 1)


def _batch_items():
    rng = np.random.default_rng(3)
    return [
        _ramp(100 * 1024),
        np.arange(3000, dtype=np.float32),
        (rng.normal(size=(32, 48)) * 0.02).astype(ml_dtypes.bfloat16),
        rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),  # memcpy frame
        bytearray(b"tiny"),
    ]


def test_batch_calls_match_ctypes(monkeypatch, fast):
    items = [api._coerce_buffer(x) for x in _batch_items()]
    native_map = api._decode_native_map()

    def run():
        frames = backend.compress_frames(items, 2, 1, 1, 1, 1)
        decoded = backend.decompress_frames(frames, 0, native_map)
        outs = [np.zeros(api._buffer_nbytes(x), np.uint8) for x in items] + [None]
        counts = backend.decompress_frames_into(frames + [frames[0]], outs, native_map)
        return frames, decoded, counts, [o.tobytes() for o in outs[:-1]]

    got = run()
    monkeypatch.setattr(backend, "_fast", None)
    assert run() == got
    frames, decoded, counts, outs = got
    assert frames == [backend.compress_frame(x, 2, 1, 1, 1, 1) for x in items]
    want = [np.asarray(x).tobytes() for x in items]
    # the memcpy frame punts to the scalar path in both routes
    assert decoded[:3] == outs[:3] == want[:3] and decoded[3] is None
    assert counts[-1] is None and counts[0] == len(want[0])


@pytest.mark.parametrize("codec,shuffle,type_size", [
    ("LZ4", "SHUFFLE", 4), ("LZ4", "NOSHUFFLE", 4), ("LZ4HC", "BITSHUFFLE", 2),
    ("BLOSCLZ", "SHUFFLE", 8), ("ZLIB", "SHUFFLE", 4), ("ZSTD", "SHUFFLE", 4),
    ("SNAPPY", "BITSHUFFLE", 4),
])
def test_compress_writes_the_full_paths_frame(codec, shuffle, type_size):
    data = _ramp(100 * 1024)
    args = (tb.Codec[codec], 5, tb.Shuffle[shuffle], type_size)
    frame = tb.compress(data, *args)
    assert frame == tb.compress_with_options(data, tb.Options(*args))
    assert frame == jb.compress(data, jb.Codec[codec], 5, jb.Shuffle[shuffle], type_size)
    assert tb.compress(data, tb.Codec[codec], 0, tb.Shuffle[shuffle], 0) == \
        tb.compress_with_options(data, tb.Options(tb.Codec[codec], 0, tb.Shuffle[shuffle], 0))


def test_compress_follows_register_codec():
    data = _ramp(100 * 1024)
    builtin = tb.compress(data)
    with both_registries() as register:
        counting = register(tb.LZ4, make_codec("counting-lz4"))
        frame = tb.compress(data)
        assert counting.compressed == 1
        assert frame == jb.compress(data)
        register(tb.LZ4, make_codec("zlib1"))
        assert tb.compress(data) == jb.compress(data) != frame
    assert tb.compress(data) == builtin


def test_no_fast_gives_the_ctypes_route():
    """TPU_BLOSC_NO_FAST gives the ctypes binding and the same frame."""
    code = (
        "import numpy as np, tpu_blosc_torch as tb\n"
        "from tpu_blosc_torch.native import backend\n"
        "d = (np.arange(102400) % 256).astype(np.uint8).tobytes()\n"
        "f = tb.compress(d)\n"
        "assert backend.fastmod() is None and tb.decompress(f) == d\n"
        "print(backend.fastcall_status()); print(f.hex())\n"
    )
    env = dict(os.environ, PYTHONPATH=_ROOT, TPU_BLOSC_NO_FAST="1")
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120, env=env,
                         capture_output=True, text=True).stdout.splitlines()
    assert out[0] == "fastcall: off (TPU_BLOSC_NO_FAST)"
    assert bytes.fromhex(out[1]) == tb.compress(_ramp(100 * 1024))
