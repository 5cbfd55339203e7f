"""The port's decoders against the JAX package's on mutated frames, on the
CPU (after tests/test_fuzz.py).

Valid frames of both packages (single-block and chunked, byte and bit
shuffle, a block stored raw, a ragged tail, a TPB2 container) are mutated
with flipped bytes, truncations, rewritten header bytes and trailing
junk; each decoder of the port must give tpu_blosc's bytes for the same
input, or raise an error of the class tpu_blosc raises: decompress,
decompress_into, decompress_range(_into), get_info,
get_decompressed_size, and decompress_array(..., device="cpu") with the
strategies "device", "records" and "transfer".  Hypothesis runs
derandomized, at most 200 examples a test.  One case runs 16 threads of
encoders and decoders at once.
"""

from __future__ import annotations

import dataclasses
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc.container import compress_container
from tpu_blosc.options import Options as JOptions

FUZZ = settings(max_examples=200, deadline=None, derandomize=True,
                suppress_health_check=[HealthCheck.too_slow])
ARRAYS = settings(FUZZ, max_examples=150)


def _base_frames() -> list[tuple[bytes, int]]:
    """(frame, decoded size) of the seed frames, all written by tpu_blosc."""
    rng = np.random.default_rng(17)
    ramp = (np.arange(6000) % 700).astype(np.float32).tobytes()
    walk = np.cumsum(rng.integers(-2, 3, 9000)).astype(np.float32).tobytes() + b"xyz"
    noisy = bytearray(np.arange(8192, dtype=np.uint32).tobytes())
    noisy[4096:8192] = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    out = [
        (jb.compress(ramp, jb.LZ4, 5, jb.SHUFFLE, 4), len(ramp)),
        (jb.compress(ramp, jb.ZSTD, 3, jb.BITSHUFFLE, 4), len(ramp)),
        (jb.compress(b"abc" * 30, jb.BLOSCLZ, 5, jb.NOSHUFFLE, 1), 90),
    ]
    for data, kw in ((walk, dict(block_size=4096)),
                     (walk, dict(block_size=4096, shuffle=jb.BITSHUFFLE)),
                     (bytes(noisy), dict(block_size=4096)),
                     (ramp, dict(block_size=8192, codec=jb.ZLIB, type_size=8))):
        out.append((jb.compress_with_options(data, JOptions(**kw)), len(data)))
    # a TPB2 container of three sub-frames
    out.append((compress_container(walk, JOptions(block_size=4096), frame_limit=12_000),
                len(walk)))
    return out


BASES = _base_frames()


@st.composite
def mutated(draw):
    """(a seed frame mutated once or twice, its decoded size before)."""
    frame, n = BASES[draw(st.integers(0, len(BASES) - 1))]
    buf = bytearray(frame)
    for _ in range(draw(st.integers(1, 2))):
        kind = draw(st.sampled_from(["flip", "truncate", "header", "junk"]))
        if kind == "flip" and buf:
            for _ in range(draw(st.integers(1, 4))):
                buf[draw(st.integers(0, len(buf) - 1))] ^= draw(st.integers(1, 255))
        elif kind == "truncate":
            del buf[draw(st.integers(0, len(buf))):]
        elif kind == "header" and buf:
            # the 16-byte header and the block table behind it
            pos = draw(st.integers(0, min(len(buf), 48) - 1))
            buf[pos] = draw(st.sampled_from([0, 1, 2, 4, 8, 16, 0x7F, 0x80, 0xFF]))
        else:
            buf += draw(st.binary(min_size=1, max_size=64))
    return bytes(buf), n


def outcome(fn, *args):
    """("ok", result) or ("error", the exception's class name)."""
    try:
        return "ok", fn(*args)
    except Exception as exc:  # the class is what is compared
        return "error", type(exc).__name__


def both(name: str, *args):
    return outcome(getattr(jb, name), *args), outcome(getattr(tb, name), *args)


@FUZZ
@given(case=mutated())
def test_decompress_and_the_size_queries(case):
    frame, _ = case
    for name in ("decompress", "get_decompressed_size"):
        theirs, mine = both(name, frame)
        assert mine == theirs, name
    theirs, mine = both("get_info", frame)
    if theirs[0] == "ok" and mine[0] == "ok":  # a Header, or a container's ContainerInfo
        assert type(mine[1]).__name__ == type(theirs[1]).__name__
        assert dataclasses.astuple(mine[1]) == dataclasses.astuple(theirs[1])
    else:
        assert mine == theirs


@FUZZ
@given(case=mutated(), extra=st.integers(-8, 8))
def test_decompress_into(case, extra):
    frame, n = case
    size = max(0, n + extra)
    bufs = np.zeros(size, np.uint8), np.zeros(size, np.uint8)
    theirs = outcome(jb.decompress_into, frame, bufs[0])
    mine = outcome(tb.decompress_into, frame, bufs[1])
    assert mine == theirs
    if mine[0] == "ok":  # what a failed decode left in the buffer is no contract
        assert bufs[1].tobytes() == bufs[0].tobytes()


@FUZZ
@given(case=mutated(), start=st.integers(-2, 40_000), size=st.integers(-2, 40_000))
def test_decompress_range_and_range_into(case, start, size):
    frame, _ = case
    theirs, mine = both("decompress_range", frame, start, size)
    assert mine == theirs
    out = np.zeros(max(size, 0), np.uint8), np.zeros(max(size, 0), np.uint8)
    theirs = outcome(jb.decompress_range_into, frame, start, size, out[0])
    mine = outcome(tb.decompress_range_into, frame, start, size, out[1])
    assert mine == theirs
    if mine[0] == "ok":
        assert out[1].tobytes() == out[0].tobytes()


@ARRAYS
@given(case=mutated(), strategy=st.sampled_from(["device", "records", "transfer"]))
def test_decompress_array_on_the_cpu(case, strategy):
    """The port on the CPU against tpu_blosc on its CPU devices: the same
    float32 values (compared as bytes) or the same error class."""
    frame, _ = case
    theirs = outcome(lambda: np.asarray(jb.decompress_array(frame, np.float32,
                                                            strategy=strategy)).tobytes())
    mine = outcome(lambda: tb.decompress_array(frame, torch.float32, device="cpu",
                                               strategy=strategy).numpy().tobytes())
    assert mine == theirs


def test_the_seed_frames_decode_in_both_packages():
    for frame, n in BASES:
        assert len(tb.decompress(frame)) == n and tb.decompress(frame) == jb.decompress(frame)


def test_sixteen_threads_of_encoders_and_decoders():
    """16 threads at once, each job a compress, decompress, compress_array
    or decompress_array (all three strategies) of its own data on the CPU,
    held to tpu_blosc's frames and bytes made beforehand on this thread;
    the interpreter switches threads every 10 us."""
    rng = np.random.default_rng(23)
    jobs = []
    for k in range(64):
        data = (np.arange(20_000 + 512 * k) % (50 + k)).astype(np.float32)
        if k % 3 == 0:
            data[rng.integers(0, data.size, 200)] = rng.random(200, dtype=np.float32)
        opts = dict(block_size=8192, shuffle=(jb.SHUFFLE, jb.BITSHUFFLE)[k % 2])
        frame = jb.compress_with_options(data.tobytes(), JOptions(**opts))
        jobs.append((k, data, tb.Options(**opts), frame))

    def run(job):
        k, data, opts, frame = job
        kind = k % 4
        if kind == 0:
            return tb.compress_with_options(data.tobytes(), opts) == frame
        if kind == 1:
            return tb.decompress(frame) == data.tobytes()
        if kind == 2:
            return tb.compress_array(torch.from_numpy(data), opts) == frame
        strategy = ("device", "records", "transfer")[k // 4 % 3]
        got = tb.decompress_array(frame, torch.float32, device="cpu", strategy=strategy)
        return got.numpy().tobytes() == data.tobytes()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(16) as pool:
            results = list(pool.map(run, jobs * 4, timeout=300))
    finally:
        sys.setswitchinterval(interval)
    assert len(results) == 256 and all(results)


@pytest.mark.parametrize("frame, n", BASES)
def test_every_seed_frame_truncated_at_every_byte_of_its_header(frame, n):
    for cut in range(0, min(len(frame), 40)):
        theirs, mine = both("decompress", frame[:cut])
        assert mine == theirs
