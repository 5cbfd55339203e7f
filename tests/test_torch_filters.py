"""The PyTorch port's byte-shuffle filters against the JAX package's.

Inputs come from a numpy seed and go through both packages; every
comparison is exact byte equality, since the codec is lossless.  On the
CPU the port's block filters run their plain PyTorch versions (the CUDA
kernels need a card; chip_smoke.py holds them to these plain versions
there).  The Pallas kernels run in interpret mode, as in
tests/test_pallas_planes.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_blosc.filters import pallas_kernels as pk
from tpu_blosc.filters import reference as jax_ref
from tpu_blosc_torch import filters
from tpu_blosc_torch.filters import batched, kernels
from tpu_blosc_torch.filters import reference as torch_ref

RNG = np.random.default_rng(1016)


def _rows(nb: int, bs: int) -> np.ndarray:
    return RNG.integers(0, 256, (nb, bs), dtype=np.uint8)


@pytest.mark.parametrize("ts,wdt", [(2, np.uint16), (4, np.uint32)])
@pytest.mark.parametrize("nb,bs", [(2, 16384), (3, 32768)])
def test_shuffle_blocks_matches_pallas_byte_planes(ts, wdt, nb, bs):
    assert pk.byte_plane_fusable(bs, ts)
    raw = _rows(nb, bs)
    planes = pk.byte_plane_split(jnp.asarray(raw.view(wdt)), ts)
    want = np.asarray(planes).reshape(nb, bs)
    got = batched.shuffle_blocks(torch.from_numpy(raw), ts)
    assert np.array_equal(got.numpy(), want)

    merged = pk.byte_plane_merge(jnp.asarray(want.reshape(nb, ts, bs // ts)), ts)
    back = batched.unshuffle_blocks(torch.from_numpy(want.copy()), ts)
    assert np.array_equal(back.numpy(), np.asarray(merged).view(np.uint8).reshape(nb, bs))
    assert np.array_equal(back.numpy(), raw)


@pytest.mark.parametrize("ts", [2, 3, 4, 8, 16, 300])
def test_shuffle_blocks_matches_reference_rows(ts):
    nb, bs = 5, 40 * ts
    raw = _rows(nb, bs)
    got = batched.shuffle_blocks(torch.from_numpy(raw), ts).numpy()
    for i in range(nb):
        assert np.array_equal(got[i], jax_ref.shuffle_bytes(raw[i].tobytes(), ts))

    keep = np.array([True, False, False, True, False])
    back = batched.unshuffle_blocks(
        torch.from_numpy(got), ts, keep_raw=torch.from_numpy(keep)
    ).numpy()
    for i in range(nb):
        want = got[i] if keep[i] else jax_ref.unshuffle_bytes(got[i].tobytes(), ts)
        assert np.array_equal(back[i], want)
    assert np.array_equal(batched.unshuffle_blocks(torch.from_numpy(got), ts).numpy(), raw)


def test_shuffle_blocks_writes_into_out():
    raw = torch.from_numpy(_rows(3, 64))
    out = torch.zeros(4, 64, dtype=torch.uint8)
    res = batched.shuffle_blocks(raw, 8, out=out[1:])
    assert res.data_ptr() == out[1:].data_ptr()
    assert torch.equal(out[1:], batched.shuffle_blocks_plain(raw, 8))
    assert not out[0].any()
    back = torch.empty_like(raw)
    batched.unshuffle_blocks(out[1:], 8, out=back)
    assert torch.equal(back, raw)


@pytest.mark.parametrize("ts", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("n", [0, 1, 7, 64, 1001, 4099])
def test_torch_reference_matches_jax_reference(ts, n):
    a = RNG.integers(0, 256, n, dtype=np.uint8)
    t = torch.from_numpy(a)
    assert np.array_equal(torch_ref.shuffle_bytes(t, ts).numpy(), jax_ref.shuffle_bytes(a, ts))
    assert np.array_equal(torch_ref.unshuffle_bytes(t, ts).numpy(), jax_ref.unshuffle_bytes(a, ts))


@pytest.mark.parametrize("ts", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("n", [5, 1000, 65539])
def test_host_shuffle_bytes_matches_reference(ts, n):
    a = RNG.integers(0, 256, n, dtype=np.uint8)
    shuffled = filters.shuffle_bytes(a, ts)
    assert np.array_equal(shuffled, torch_ref.shuffle_bytes(torch.from_numpy(a), ts).numpy())
    assert np.array_equal(filters.unshuffle_bytes(shuffled, ts), a)


@pytest.mark.parametrize(
    "blocks,ts,err",
    [
        (torch.zeros(2, 30, dtype=torch.uint8), 4, ValueError),  # bs % ts
        (torch.zeros(2, 32, dtype=torch.uint8), 1, ValueError),  # ts < 2
        (torch.zeros(64, dtype=torch.uint8), 4, ValueError),  # not 2-D
        (torch.zeros(2, 32, dtype=torch.int16), 4, TypeError),  # not uint8
        (torch.zeros(32, 4, dtype=torch.uint8).t(), 4, ValueError),  # strided
    ],
)
def test_shuffle_blocks_rejects_bad_input(blocks, ts, err):
    with pytest.raises(err):
        batched.shuffle_blocks(blocks, ts)
    with pytest.raises(err):
        batched.unshuffle_blocks(blocks, ts)


def test_shuffle_blocks_refuses_devices_without_a_route():
    blocks = torch.empty(2, 32, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no byte-shuffle route"):
        batched.shuffle_blocks(blocks, 4)
    with pytest.raises(ValueError, match="no byte-shuffle route"):
        batched.unshuffle_blocks(blocks, 4)


def test_kernel_wrappers_take_cuda_tensors_only():
    """The CUDA route never runs a CPU tensor through a plain version:
    handed one, it raises before any build or launch."""
    blocks = torch.from_numpy(_rows(2, 32))
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.shuffle_blocks(blocks, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.unshuffle_blocks(blocks, 4)
    assert kernels.launches == before


def test_backend_name_follows_cuda_availability():
    want = "cuda" if torch.cuda.is_available() else "torch-cpu"
    assert filters.backend_name() == want
