"""The port's compressibility probe and advisors against the JAX package's.

stream_probe and the per-tile sums of the probe's plain version are held
to tpu_blosc's Pallas probe (interpret mode) on the cases of
tests/test_probe.py; suggest_codec and suggest_options to tpu_blosc's on
the CPU, where both packages take the NumPy statistic.  Inputs come from
numpy seeds; every comparison is exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc.filters import pallas_kernels as pk
from tpu_blosc_torch.filters import kernels
from tpu_blosc_torch.filters import probe as tp

MIB = 1 << 20


def _structured() -> bytes:
    rng = np.random.default_rng(0)
    return np.concatenate([
        np.zeros(30_000, np.uint8),
        rng.integers(0, 256, 30_000, dtype=np.uint8),
        (np.arange(30_000) % 7).astype(np.uint8),
    ]).tobytes()


def _runs_then_noise() -> bytes:
    rng = np.random.default_rng(3)
    runs = np.zeros(6 * MIB, np.uint8)
    noise = rng.integers(0, 256, 18 * MIB, dtype=np.uint8)
    return np.concatenate([runs, noise]).tobytes()


PROBE_CASES = {
    "zeros": lambda: bytes(100_000),
    "random": lambda: np.random.default_rng(1).integers(0, 256, 200_000, dtype=np.uint8).tobytes(),
    "structured": _structured,
    "two-tiles": lambda: (np.arange(1_500_000) % 13).astype(np.uint8).tobytes(),
    "sampled-24MiB": _runs_then_noise,
    "prefix-4MiB": lambda: _runs_then_noise()[: 4 * MIB],
    "ndarray": lambda: np.arange(300_000, dtype=np.float32),
}


@pytest.mark.parametrize("name", list(PROBE_CASES))
def test_stream_probe_equals_tpu_blosc(name):
    data = PROBE_CASES[name]()
    assert tp.stream_probe(data, device="cpu") == pk.stream_probe(data)


@pytest.mark.parametrize("name", ["zeros", "structured", "two-tiles", "sampled-24MiB"])
def test_probe_ready_and_tile_sums_equal_tpu_blosc(name):
    """The padded, snapped (rows, 512) layout and each tile's sums equal
    _probe_runs and _probe_bytesum."""
    data = PROBE_CASES[name]()
    words = tp.probe_ready(data, device="cpu")
    jwords = pk.probe_ready(data)
    assert np.array_equal(words.numpy(), np.asarray(jwords))
    assert words.shape[0] // tp.TILE_ROWS in (1, 2, 4)
    sums = tp.probe_tiles(words).numpy()
    assert np.array_equal(sums[:, 0], np.asarray(pk._probe_runs(jwords))[:, 0, 0])
    assert np.array_equal(sums[:, 1], np.asarray(pk._probe_bytesum(jwords))[:, 0, 0])


@pytest.mark.parametrize("rows", [512, 700, 2048])
def test_stream_probe_of_a_word_tensor_equals_tpu_blosc(rows):
    """A (rows, 512) int32 tensor is taken as it is: no padding
    correction, and rows past the last whole tile are not read."""
    rng = np.random.default_rng(rows)
    words = rng.integers(0, 4, (rows, 512), dtype=np.int32) * 0x01010101
    got = tp.stream_probe(torch.from_numpy(words))
    assert got == pk.stream_probe(jnp.asarray(words))
    assert got["n"] == rows * 512 * 4


def test_probe_tiles_plain_counts_pairs_inside_words():
    """3 of the 4 adjacent pairs per word, and every byte in the sum,
    against a direct count."""
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 3, 2 * tp.TILE_BYTES, dtype=np.uint8)
    sums = tp.probe_tiles(torch.from_numpy(raw.view(np.int32).reshape(-1, 512))).numpy()
    for t in range(2):
        b = raw[t * tp.TILE_BYTES : (t + 1) * tp.TILE_BYTES].reshape(-1, 4)
        runs = sum(int(np.count_nonzero(b[:, j] == b[:, j + 1])) for j in range(3))
        assert sums[t, 0] == runs
        assert sums[t, 1] == int(b.astype(np.int64).sum())


def test_probe_ready_without_a_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.probe_ready(b"abcd")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.stream_probe(b"abcd")


def test_stream_probe_refuses_other_tensors():
    for bad in (torch.zeros((512, 256), dtype=torch.int32),
                torch.zeros((512, 512), dtype=torch.int64)):
        with pytest.raises(TypeError):
            tp.stream_probe(bad)
        with pytest.raises(TypeError):
            pk.stream_probe(jnp.asarray(bad.numpy()))


def test_probe_kernel_wrapper_takes_cuda_tensors_only():
    words = torch.zeros((512, 512), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.probe_tiles(words)
    with pytest.raises(ValueError, match="no probe route"):
        tp.probe_tiles(words.to("meta"))


# ---------------------------------------------------------------------------
# advisors (tests/test_probe.py:52-124)
# ---------------------------------------------------------------------------


def _text() -> bytes:
    rng = np.random.default_rng(3)
    words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"compression"]
    return b" ".join(rng.choice(words) for _ in range(20_000))


CODEC_CASES = {
    "f32-ramp": (lambda: np.arange(100_000, dtype=np.float32).tobytes(), 4),
    "random": (lambda: np.random.default_rng(2).integers(0, 256, 100_000, dtype=np.uint8).tobytes(), 1),
    "text": (_text, 1),
    "runs-then-noise-16MiB": (
        lambda: bytes(2 << 20)
        + np.random.default_rng(12).integers(0, 256, 14 << 20, dtype=np.uint8).tobytes(),
        1,
    ),
    "zeros-2MiB": (lambda: bytes(2 << 20), 1),
    "f64-signal": (lambda: np.sin(np.linspace(0, 50, 200_000)).tobytes(), 8),
}

OPTION_CASES = {
    "f32-ramp": (lambda: np.arange(200_000, dtype=np.float32).tobytes(), 4),
    "random-int32": (
        lambda: np.random.default_rng(3).integers(0, 2**31, 100_000, np.int32).tobytes(), 4,
    ),
    "runs-uint8": (lambda: (np.arange(400_000) // 1000).astype(np.uint8).tobytes(), 1),
    "linspace-f32": (lambda: np.linspace(0, 1, 100_000, dtype=np.float32).tobytes(), 4),
    "int16-steps": (lambda: (np.arange(300_000) // 3).astype(np.int16).tobytes(), 2),
    "short": (lambda: b"abcdefgh" * 3, 4),
    "type-size-0": (lambda: b"xy" * 5000, 0),
}


@pytest.mark.parametrize("name", list(CODEC_CASES))
def test_suggest_codec_equals_tpu_blosc(name):
    make, ts = CODEC_CASES[name]
    data = make()
    assert int(tb.suggest_codec(data, type_size=ts)) == int(jb.suggest_codec(data, type_size=ts))


@pytest.mark.parametrize("name", list(OPTION_CASES))
def test_suggest_options_equals_tpu_blosc(name):
    make, ts = OPTION_CASES[name]
    data = make()
    got = tb.suggest_options(data, type_size=ts)
    want = jb.suggest_options(data, type_size=ts)
    assert (int(got.codec), int(got.shuffle), got.type_size, got.level, got.block_size) == (
        int(want.codec), int(want.shuffle), want.type_size, want.level, want.block_size
    )


def test_suggested_options_roundtrip():
    data = np.linspace(0, 1, 100_000, dtype=np.float32).tobytes()
    opts = tb.suggest_options(data, type_size=4)
    frame = tb.compress_with_options(data, opts)
    assert tb.decompress(frame) == data
    assert frame == jb.compress_with_options(data, jb.suggest_options(data, type_size=4))


@pytest.mark.parametrize("fn", ["suggest_codec", "suggest_options"])
def test_advisors_reject_empty_input(fn):
    with pytest.raises(tb.InvalidDataError):
        getattr(tb, fn)(b"")
    with pytest.raises(jb.InvalidDataError):
        getattr(jb, fn)(b"")
