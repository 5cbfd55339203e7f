"""The shuffle pair's two paths: which geometry takes which, and the
port's block shuffle against the JAX package's at the geometries that
take the generic path.

``kernels.shuffle_path`` picks "vec16" (16-byte accesses, type sizes 2,
4, 8 and 16) or "generic" for each launch; the CUDA launchers check the
same preconditions again and refuse a path that does not fit
(chip_smoke.py shows that on the card).  On the CPU the block filters
run their plain PyTorch versions, which these tests hold byte for byte
to ``tpu_blosc``'s ``shuffle_batch``/``unshuffle_batch``, to the Pallas
byte-plane kernels (interpret mode) and to the NumPy reference, on the
same seeded inputs: blocks whose element count is not a multiple of 16,
type size 300, and views that start off a 16-byte boundary.
"""

from __future__ import annotations

import itertools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_blosc.filters import batched as jax_batched
from tpu_blosc.filters import pallas_kernels as pk
from tpu_blosc.filters import reference as jax_ref
from tpu_blosc_torch.filters import batched, kernels

RNG = np.random.default_rng(20261016)
BASE = 1 << 20  # a 16-byte-aligned address for the pure path choice


def _rows(nb: int, bs: int) -> np.ndarray:
    return RNG.integers(0, 256, (nb, bs), dtype=np.uint8)


def _view_at(raw: np.ndarray, offset: int) -> torch.Tensor:
    """``raw`` as an (nb, bs) view ``offset`` bytes into a fresh buffer,
    so its data pointer lies ``offset`` bytes past the buffer's start."""
    nb, bs = raw.shape
    buf = torch.zeros(nb * bs + 64, dtype=torch.uint8)
    view = buf[offset: offset + nb * bs].view(nb, bs)
    view.copy_(torch.tensor(raw))
    assert view.storage_offset() == offset
    return view


# ---- which path ------------------------------------------------------

@pytest.mark.parametrize(
    "bs,ts,src_off,dst_off,want",
    [
        (1 << 20, 4, 0, 0, "vec16"),       # the default 1 MiB block, f32
        (1 << 20, 2, 0, 0, "vec16"),
        (1 << 20, 8, 0, 0, "vec16"),
        (1 << 20, 16, 0, 0, "vec16"),
        (4096, 4, 0, 0, "vec16"),          # chunk.MIN_BLOCK
        (32, 2, 0, 0, "vec16"),            # 16 elements, the smallest block
        (256, 16, 32, 48, "vec16"),        # any multiple of 16 bytes apart
        (1 << 20, 4, 12, 0, "generic"),    # x[3:] of a float32 tensor
        (1 << 20, 4, 0, 4, "generic"),     # an unaligned output
        (1 << 20, 4, 1, 1, "generic"),
        (96, 4, 0, 0, "generic"),          # 24 elements
        (64, 8, 0, 0, "generic"),          # 8 elements: bs a multiple of 8 ts only
        (1 << 20, 32, 0, 0, "generic"),
        (1048560, 3, 0, 0, "generic"),
        (1046400, 300, 0, 0, "generic"),
        ((1 << 31) + (1 << 20), 4, 0, 0, "generic"),  # offsets need 64 bits
    ],
)
def test_shuffle_path_cases(bs, ts, src_off, dst_off, want):
    assert kernels.shuffle_path(bs, ts, BASE + src_off, BASE + dst_off) == want


@pytest.mark.parametrize("ts", [2, 3, 4, 5, 8, 12, 16, 32, 300])
def test_shuffle_path_takes_vec16_exactly_where_every_precondition_holds(ts):
    for ne, src_off, dst_off in itertools.product(
        (8, 16, 24, 48, 4096, 65536), (0, 1, 4, 12, 16), (0, 4, 32)
    ):
        bs = ne * ts
        fits = (ts in (2, 4, 8, 16) and ne % 16 == 0
                and src_off % 16 == 0 and dst_off % 16 == 0)
        got = kernels.shuffle_path(bs, ts, BASE + src_off, BASE + dst_off)
        assert got == ("vec16" if fits else "generic"), (bs, ts, src_off, dst_off)


def test_path_numbers_and_type_sizes_match_the_cuda_source():
    """The wrappers pass each path as the number csrc/shuffle.cu gives it,
    and shuffle_path's type sizes are those the launcher accepts."""
    src = open(os.path.join(kernels.CSRC, "shuffle.cu")).read()
    enum = re.search(r"enum Path \{([^}]*)\}", src).group(1)
    numbers = dict(re.findall(r"k(\w+) = (\d+)", enum))
    assert {k.lower(): int(v) for k, v in numbers.items()} == kernels.SHUFFLE_PATHS
    fits = re.search(r"bool vec16_fits\([^)]*\) \{(.*?)\n\}", src, re.S).group(1)
    sizes = tuple(int(t) for t in re.findall(r"ts == (\d+)", fits))
    assert sizes == kernels.VEC16_TYPE_SIZES


def test_pick_path_takes_shuffle_paths_choice_or_a_known_name():
    blocks = torch.from_numpy(_rows(2, 1024))
    out = torch.empty_like(blocks)
    want = kernels.shuffle_path(1024, 4, blocks.data_ptr(), out.data_ptr())
    assert kernels._pick_path(None, blocks, 4, out) == want
    assert kernels._pick_path("generic", blocks, 4, out) == "generic"
    with pytest.raises(ValueError, match="unknown shuffle path"):
        kernels._pick_path("vec8", blocks, 4, out)


def test_kernel_wrappers_refuse_cpu_tensors_whatever_the_path():
    blocks = torch.from_numpy(_rows(2, 1024))
    before = dict(kernels.launches)
    for path in (None, "vec16", "generic"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.shuffle_blocks(blocks, 4, path=path)
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.unshuffle_blocks(blocks, 4, path=path)
    assert kernels.launches == before
    assert {f"{k}.{p}" for k in ("shuffle_blocks", "unshuffle_blocks")
            for p in kernels.SHUFFLE_PATHS} <= set(kernels.launches)


# ---- the generic path's geometries, against tpu_blosc ----------------

def _hold_to_jax(raw: np.ndarray, x: torch.Tensor, ts: int) -> None:
    """Shuffle ``x`` (holding ``raw``'s bytes) in the port and ``raw``
    in tpu_blosc, then unshuffle both ways, with every other row raw."""
    nb = raw.shape[0]
    got = batched.shuffle_blocks(x, ts)
    want = jax_batched.shuffle_batch(raw, ts)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got[0].numpy(), jax_ref.shuffle_bytes(raw[0].tobytes(), ts))

    keep = np.arange(nb) % 2 == 1
    back = batched.unshuffle_blocks(got, ts, keep_raw=torch.from_numpy(keep)).numpy()
    merged = jax_batched.unshuffle_batch(want, ts)
    assert np.array_equal(merged, raw)
    assert np.array_equal(back[~keep], merged[~keep])
    assert np.array_equal(back[keep], want[keep])


@pytest.mark.parametrize("ts", [2, 3, 4, 5, 8, 12, 16, 32, 300])
@pytest.mark.parametrize("ne", [24, 8 * 3 * 5])
def test_blocks_of_not_16_elements_match_tpu_blosc(ts, ne):
    raw = _rows(4, ne * ts)
    _hold_to_jax(raw, torch.from_numpy(raw.copy()), ts)


@pytest.mark.parametrize("ts", [2, 3, 4, 8, 16, 300])
@pytest.mark.parametrize("offset", [1, 4, 12])
def test_unaligned_views_match_tpu_blosc(ts, offset):
    raw = _rows(3, 64 * ts)
    _hold_to_jax(raw, _view_at(raw, offset), ts)


@pytest.mark.parametrize("ts,wdt", [(2, np.uint16), (4, np.uint32)])
@pytest.mark.parametrize("offset", [1, 4, 12])
def test_unaligned_views_match_pallas_byte_planes(ts, wdt, offset):
    nb, bs = 2, 16384
    assert pk.byte_plane_fusable(bs, ts)
    raw = _rows(nb, bs)
    want = np.asarray(pk.byte_plane_split(jnp.asarray(raw.view(wdt)), ts)).reshape(nb, bs)
    out = _view_at(np.zeros_like(raw), 16 - offset)
    got = batched.shuffle_blocks(_view_at(raw, offset), ts, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert np.array_equal(out.numpy(), want)

    merged = pk.byte_plane_merge(jnp.asarray(want.reshape(nb, ts, bs // ts)), ts)
    back = batched.unshuffle_blocks(_view_at(want, offset), ts)
    assert np.array_equal(back.numpy(), np.asarray(merged).view(np.uint8).reshape(nb, bs))
    assert np.array_equal(back.numpy(), raw)
