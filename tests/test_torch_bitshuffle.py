"""The port's bit shuffle against the JAX package's, on the CPU.

The block bit shuffle's plain PyTorch versions (the CUDA kernel pair in
csrc/bitshuffle.cu is held to them on the card by chip_smoke.py) against
tpu_blosc's XLA device programs (``_bit_shuffle_batch_dev``, its SWAR word
tables) and the NumPy reference; then compress_array and
decompress_array(strategy="device") under BITSHUFFLE against
tpu_blosc.compress_array and the host path, byte for byte, including a
block that takes the memcpy fallback and a ragged tail that ends in a
partial group of 8 elements and an odd byte.  Inputs come from numpy
seeds; every comparison is exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc.filters import batched as jax_batched
from tpu_blosc.filters import reference as jax_ref
from tpu_blosc.options import Options as JOptions
from tpu_blosc_torch.filters import batched, kernels

RNG = np.random.default_rng(20261017)
TYPE_SIZES = [2, 3, 4, 5, 8, 16, 32]


def _rows(nb: int, bs: int) -> np.ndarray:
    return RNG.integers(0, 256, (nb, bs), dtype=np.uint8)


# ---- the block filters -----------------------------------------------


@pytest.mark.parametrize("ts", TYPE_SIZES)
def test_plain_bit_shuffle_equals_xla_program_and_reference(ts):
    nb, bs = 4, 8 * ts * 6
    raw = _rows(nb, bs)
    got = batched.bit_shuffle_blocks_plain(torch.from_numpy(raw), ts).numpy()
    assert np.array_equal(got, np.asarray(jax_batched._bit_shuffle_batch_dev(jnp.asarray(raw), ts)))
    for i in range(nb):
        assert np.array_equal(got[i], jax_ref.bit_shuffle(raw[i].tobytes(), ts))
    assert np.array_equal(got, jax_batched.bit_shuffle_batch(raw, ts))

    keep = np.array([False, True, False, True])
    back = batched.bit_unshuffle_blocks_plain(
        torch.from_numpy(got), ts, keep_raw=torch.from_numpy(keep)
    ).numpy()
    merged = np.asarray(jax_batched._bit_unshuffle_batch_dev(jnp.asarray(got), ts))
    assert np.array_equal(merged, raw)
    assert np.array_equal(back[~keep], raw[~keep])
    assert np.array_equal(back[keep], got[keep])
    assert np.array_equal(batched.bit_unshuffle_blocks_plain(torch.from_numpy(got), ts).numpy(), raw)


@pytest.mark.parametrize("ts", sorted(jax_batched._SWAR_BIT_SHUFFLE))
def test_plain_bit_shuffle_equals_swar_word_kernels(ts):
    fn, quant = jax_batched._SWAR_BIT_SHUFFLE[ts]
    inv, _ = jax_batched._SWAR_BIT_UNSHUFFLE[ts]
    raw = _rows(3, quant * 4 * 5)
    want = np.asarray(fn(jnp.asarray(raw.view(np.uint32)))).view(np.uint8)
    got = batched.bit_shuffle_blocks(torch.from_numpy(raw), ts)
    assert np.array_equal(got.numpy(), want)
    back = np.asarray(inv(jnp.asarray(want.view(np.uint32)))).view(np.uint8)
    assert np.array_equal(batched.bit_unshuffle_blocks(got, ts).numpy(), back)
    assert np.array_equal(back, raw)


def test_routed_wrappers_write_into_out_and_mask_raw_rows():
    raw = torch.from_numpy(_rows(3, 128))
    out = torch.zeros(4, 128, dtype=torch.uint8)
    res = batched.bit_shuffle_blocks(raw, 4, out=out[1:])
    assert res.data_ptr() == out[1:].data_ptr() and not out[0].any()
    assert torch.equal(out[1:], batched.bit_shuffle_blocks_plain(raw, 4))
    back = torch.empty_like(raw)
    keep = torch.tensor([True, False, False])
    batched.bit_unshuffle_blocks(out[1:], 4, keep_raw=keep, out=back)
    assert torch.equal(back[0], out[1]) and torch.equal(back[1:], raw[1:])


@pytest.mark.parametrize(
    "blocks,ts,err",
    [
        (torch.zeros(2, 40, dtype=torch.uint8), 4, ValueError),  # bs % (8*ts)
        (torch.zeros(2, 48, dtype=torch.uint8), 4, ValueError),  # bs % ts == 0 only
        (torch.zeros(2, 32, dtype=torch.uint8), 1, ValueError),  # ts < 2
        (torch.zeros(2, 32, dtype=torch.int16), 2, TypeError),  # not uint8
        (torch.zeros(64, 4, dtype=torch.uint8).t(), 2, ValueError),  # strided
    ],
)
def test_bit_shuffle_blocks_rejects_bad_input(blocks, ts, err):
    for fn in (batched.bit_shuffle_blocks, batched.bit_unshuffle_blocks):
        with pytest.raises(err):
            fn(blocks, ts)


def test_kernel_wrappers_take_cuda_tensors_only():
    blocks = torch.from_numpy(_rows(2, 64))
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.bit_shuffle_blocks(blocks, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.bit_unshuffle_blocks(blocks, 2)
    assert kernels.launches == before
    assert {"bit_shuffle_blocks", "bit_unshuffle_blocks"} <= set(kernels.launches)


@pytest.mark.parametrize("n", [0, 1, 5, 7, 8 * 4 + 3, 8 * 4 * 9 + 21, 4099])
def test_host_bit_shuffle_matches_reference_with_ragged_tails(n):
    a = RNG.integers(0, 256, n, dtype=np.uint8)
    for ts in (2, 3, 4, 8):
        got = tb.filters.bit_shuffle(a, ts)
        assert np.array_equal(got, jax_ref.bit_shuffle(a, ts))
        assert np.array_equal(tb.filters.bit_unshuffle(got, ts), a)


# ---- compress_array / decompress_array under BITSHUFFLE ---------------


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _sensor(n: int, dtype) -> np.ndarray:
    """A slow 12-bit sine with small noise, in ``dtype``."""
    rng = np.random.default_rng(31)
    v = 2048 + 1500 * np.sin(np.arange(n) / 500.0) + rng.normal(scale=3.0, size=n)
    return v.astype(np.float32).astype(dtype)


def _opts(**kw):
    jkw, tkw = dict(kw), dict(kw)
    for key, enum in (("codec", "Codec"), ("shuffle", "Shuffle")):
        if key in kw:
            jkw[key] = getattr(jb, enum)[kw[key]]
            tkw[key] = getattr(tb, enum)[kw[key]]
    return JOptions(**jkw), tb.Options(**tkw)


DTYPES = {
    "float32": np.float32, "float64": np.float64, "int16": np.int16,
    "int32": np.int32, "bfloat16": ml_dtypes.bfloat16,
}


def _cases():
    """name -> (array, options keywords): the bit-shuffled inputs."""
    cases = {name: (_sensor(70_001, dt), {}) for name, dt in DTYPES.items()}
    # a block of random bytes (the memcpy fallback) and a tail of 2 full
    # groups, a partial group of 5 elements and an odd byte, at ts 2
    noisy = _sensor(3 * 16384 + 8 * 2 + 5, np.int16).view(np.uint8)
    noisy = np.concatenate([noisy, np.array([7], np.uint8)])
    noisy[32768:65536] = RNG.integers(0, 256, 32768, dtype=np.uint8)
    cases["memcpy-block-and-ragged-tail"] = (noisy, {"type_size": 2})
    # three-byte elements: a uint8 view read as ts 3
    cases["ts3-view"] = (
        np.random.default_rng(3).integers(0, 4, 3 * 30_001, dtype=np.uint8), {"type_size": 3}
    )
    cases["lz4hc-ts8"] = (_sensor(40_000, np.float64), {"codec": "LZ4HC"})
    cases["zstd-ts4"] = (_sensor(40_000, np.float32), {"codec": "ZSTD"})
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_compress_array_bitshuffle_matches_tpu_blosc(name):
    data, kw = CASES[name]
    jo, to = _opts(shuffle="BITSHUFFLE", block_size=32768,
                   **{"type_size": data.dtype.itemsize, **kw})
    frame = tb.compress_array(_tensor(data), to)
    assert tb.format.parse_header(frame).has_bitshuffle
    assert frame == jb.compress_with_options(data.tobytes(), jo)
    assert frame == tb.compress_with_options(data.tobytes(), to)
    assert frame == jb.compress_array(jnp.asarray(data), jo)
    assert tb.decompress(frame) == data.tobytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_decompress_array_device_strategy_bitshuffle(name):
    data, kw = CASES[name]
    jo, _ = _opts(shuffle="BITSHUFFLE", block_size=32768,
                  **{"type_size": data.dtype.itemsize, **kw})
    frame = jb.compress_with_options(data.tobytes(), jo)
    out = tb.decompress_array(frame, torch.uint8, device="cpu", strategy="device")
    assert out.numpy().tobytes() == data.tobytes()


def test_memcpy_block_carries_raw_bytes_under_bitshuffle():
    """Stage 2 unfilters memcpy blocks with the inverse of the filter that
    made them: with the bit shuffle, bit_unshuffle."""
    data, kw = CASES["memcpy-block-and-ragged-tail"]
    _, to = _opts(shuffle="BITSHUFFLE", block_size=32768, **kw)
    frame = tb.compress_array(_tensor(data), to)
    header = tb.format.parse_header(frame)
    entries, offset = tb.chunk.parse_block_table(frame, header)
    assert [m for _, m in entries[:3]] == [False, True, False]
    assert len(data) - 3 * 32768 == 2 * 8 * 2 + 5 * 2 + 1  # the tail
    start = offset + entries[0][0]
    assert frame[start : start + 32768] == data[32768:65536].tobytes()


def test_decompress_array_device_strategy_runs_the_block_bit_unshuffle(monkeypatch):
    data, kw = CASES["memcpy-block-and-ragged-tail"]
    jo, _ = _opts(shuffle="BITSHUFFLE", block_size=32768, **kw)
    frame = jb.compress_with_options(data.tobytes(), jo)
    seen = []
    real = tb.filters.bit_unshuffle_blocks

    def spy(blocks, ts, keep_raw=None, out=None):
        seen.append((tuple(blocks.shape), ts, None if keep_raw is None else keep_raw.tolist()))
        return real(blocks, ts, keep_raw=keep_raw, out=out)

    monkeypatch.setattr(tb.filters, "bit_unshuffle_blocks", spy)
    out = tb.decompress_array(frame, torch.uint8, device="cpu", strategy="device")
    assert out.numpy().tobytes() == data.tobytes()
    assert seen == [((3, 32768), 2, [False, True, False])]


def test_compress_array_bitshuffle_runs_the_block_bit_shuffle(monkeypatch):
    data = _sensor(50_000, np.float32)
    seen = []
    real = tb.filters.bit_shuffle_blocks

    def spy(blocks, ts, out=None):
        seen.append((tuple(blocks.shape), ts))
        return real(blocks, ts, out=out)

    monkeypatch.setattr(tb.filters, "bit_shuffle_blocks", spy)
    frame = tb.compress_array(_tensor(data),
                              tb.Options(shuffle=tb.Shuffle.BITSHUFFLE, block_size=65536))
    assert seen == [((3, 65536), 4)]
    assert tb.decompress(frame) == data.tobytes()


def _tiled(n: int) -> np.ndarray:
    """f32 tiled with a 256-element pattern, 0.1% of it perturbed: sparse
    enough after the bit shuffle for the match emitter to engage."""
    rng = np.random.default_rng(5)
    data = np.tile(rng.random(256).astype(np.float32), n // 256)
    hit = rng.choice(data.size, data.size // 1000, replace=False)
    data[hit] += rng.random(hit.size).astype(np.float32) * 0.01
    return data


@pytest.mark.parametrize("codec", ["LZ4", "LZ4HC"])
def test_match_frames_under_bitshuffle_equal_tpu_blosc(codec):
    data = _tiled(1 << 18)[: (1 << 18) - 1003]  # a ragged tail
    jo, to = _opts(codec=codec, shuffle="BITSHUFFLE", block_size=65536)
    frame = tb.compress_array(_tensor(data), to, strategy="match")
    assert frame == jb.compress_array(jnp.asarray(data), jo, strategy="match")
    assert frame != tb.compress_array(_tensor(data), to)  # the emitter engaged
    assert tb.decompress(frame) == data.tobytes()
    out = tb.decompress_array(frame, torch.float32, device="cpu", strategy="device")
    assert np.array_equal(out.numpy(), data)
