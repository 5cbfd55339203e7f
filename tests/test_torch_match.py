"""The port's match strategy against the JAX package's, on the CPU.

compress_array(strategy="match") of tpu_blosc_torch and of tpu_blosc run
on the same numpy inputs, after tests/test_device_api.py:228-680.  Match
frames are not the host encoder's, but they are deterministic, so the
contract is bytes: the two packages' frames must be equal, and each must
decode in both.  The literal-mask kernel's plain version is held to the
Pallas kernel (interpret mode) and to the XLA match core.  Every
comparison is exact.

The JAX frames are computed once per module (interpret-mode Pallas is
slow).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc import device as jdev
from tpu_blosc.filters import pallas_kernels as pk
from tpu_blosc.options import Options as JOptions
from tpu_blosc_torch import match as tm
from tpu_blosc_torch.filters import kernels
from tpu_blosc_torch.filters import match as fm

MIB = 1 << 20


def _tiled_pattern(n_elems: int, period: int = 256, noise_pct: int = 100):
    """f32 tiled with a random pattern plus sparse noise
    (tests/test_device_api.py:228-237)."""
    rng = np.random.default_rng(5)
    data = np.tile(rng.random(period).astype(np.float32), n_elems // period)
    hit = rng.choice(data.size, max(data.size // noise_pct, 1), replace=False)
    data[hit] += rng.random(hit.size).astype(np.float32) * 0.01
    return data


def _periodic_planes(n_elems: int, period: int, dtype, seed=9):
    """Elements tiled with an element period, plus clumped noise
    (tests/test_device_api.py:514-525)."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    pattern = rng.integers(info.min, info.max, period, dtype)
    data = np.tile(pattern, n_elems // period + 1)[:n_elems].copy()
    starts = rng.choice(n_elems - 8, max(n_elems // 512, 1), replace=False)
    for w in range(4):
        data[starts + w] ^= dtype(rng.integers(1, 127))
    return data


def _mixed_int16():
    """Plane 0 periodic, plane 1 noise (tests/test_device_api.py:408-423)."""
    rng = np.random.default_rng(6)
    n = 2 * MIB
    pattern = np.tile(rng.integers(0, 256, 128, np.uint8), n // 128)
    noise = rng.integers(0, 256, n, np.uint8)
    return (pattern.astype(np.int16) | (noise.astype(np.int16) << 8)).astype(np.int16)


def _periodic_bytes(n: int, period: int, seed: int) -> np.ndarray:
    """uint8 bytes tiled with a byte period, with 0.2% of bytes flipped."""
    rng = np.random.default_rng(seed)
    data = np.tile(rng.integers(0, 256, period, np.uint8), n // period + 1)[:n].copy()
    hit = rng.choice(n, n // 500, replace=False)
    data[hit] ^= 0x5A
    return data


# name -> (data, options as keyword arguments, whether the emitter engages)
CASES = {
    "tiled-f32-8MiB": (lambda: _tiled_pattern(2 * MIB), dict(block_size=MIB), True),
    # every block holds a dense row, so every block is rebuilt on the host
    # and re-encoded by the native codec: the transfer frame's bytes
    "mixed-int16-rows": (_mixed_int16, dict(type_size=2, block_size=512 * 1024), False),
    "period-3-int32": (
        lambda: _periodic_planes(MIB, 3, np.int32),
        dict(type_size=4, block_size=512 * 1024), True,
    ),
    "pitch-96-uint16": (
        lambda: _periodic_planes(2 * MIB, 48, np.uint16),
        dict(type_size=2, block_size=512 * 1024), True,
    ),
    "runs-f32": (
        lambda: (np.arange(MIB) // 64).astype(np.float32), dict(block_size=MIB), True,
    ),
    "random-int32": (
        lambda: np.random.default_rng(11).integers(0, 2**31, 2 * MIB, dtype=np.int32),
        dict(block_size=MIB), False,
    ),
    "ragged-tail": (
        lambda: _tiled_pattern(1 << 19)[:(1 << 19) - 4099], dict(block_size=256 * 1024), True,
    ),
    "lz4hc-level-9": (
        lambda: _tiled_pattern(1 << 20),
        dict(codec="LZ4HC", level=9, block_size=512 * 1024), True,
    ),
    "seg-256": (
        lambda: (np.arange(1 << 16) // 64).astype(np.float32), dict(block_size=1024), True,
    ),
    "seg-4096": (lambda: _tiled_pattern(1 << 18, period=96), dict(block_size=16384), True),
    # odd type sizes: the block size is cut to a multiple of 8 * ts, so
    # seg = bs / ts is a multiple of 8 (see test_seg_not_multiple_of_8)
    "ts3-uint8": (
        lambda: _periodic_bytes(3 * 400_000 + 5, 3 * 8, 3),
        dict(type_size=3, block_size=300_001), True,
    ),
    "ts5-uint8": (
        lambda: _periodic_bytes(5 * 200_000, 5 * 16, 4),
        dict(type_size=5, block_size=250_007), True,
    ),
    "zstd-takes-transfer": (
        lambda: _tiled_pattern(1 << 20), dict(codec="ZSTD", block_size=512 * 1024), False,
    ),
}


def _opts(kw):
    jkw, tkw = dict(kw), dict(kw)
    if "codec" in kw:
        jkw["codec"] = jb.Codec[kw["codec"]]
        tkw["codec"] = tb.Codec[kw["codec"]]
    return JOptions(**jkw), tb.Options(**tkw)


class _Frames:
    """Data and tpu_blosc's frames per case, computed on first use."""

    def __init__(self):
        self._cache = {}

    def __call__(self, name: str, strategy: str = "match"):
        key = (name, strategy)
        if key not in self._cache:
            make, kw, _ = CASES[name]
            data = make()
            jo, to = _opts(kw)
            frame = jb.compress_array(jnp.asarray(data), jo, strategy=strategy)
            self._cache[key] = (data, to, frame)
        return self._cache[key]


@pytest.fixture(scope="module")
def jax_frames():
    return _Frames()


@pytest.mark.parametrize("name", list(CASES))
def test_match_frame_equals_tpu_blosc(jax_frames, name):
    data, to, want = jax_frames(name)
    got = tb.compress_array(torch.from_numpy(data), to, strategy="match")
    assert got == want


@pytest.mark.parametrize("name", list(CASES))
def test_match_frame_decodes_in_both_packages(jax_frames, name):
    data, to, frame = jax_frames(name)
    assert jb.decompress(frame) == data.tobytes()
    dtype = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
             np.dtype(np.int16): torch.int16, np.dtype(np.uint16): torch.uint16,
             np.dtype(np.uint8): torch.uint8}[data.dtype]
    out = tb.decompress_array(frame, dtype, device="cpu", strategy="device")
    assert out.numpy().tobytes() == data.tobytes()


@pytest.mark.parametrize("name", list(CASES))
def test_match_engages_or_takes_the_transfer_frame(jax_frames, name):
    data, to, frame = jax_frames(name)
    transfer = tb.compress_array(torch.from_numpy(data), to)
    assert (frame != transfer) == CASES[name][2]


@pytest.mark.parametrize("name", ["tiled-f32-8MiB", "ragged-tail", "random-int32"])
def test_auto_equals_match(jax_frames, name):
    data, to, frame = jax_frames(name)
    assert tb.compress_array(torch.from_numpy(data), to, strategy="auto") == frame
    assert jax_frames(name, "auto")[2] == frame


def test_match_frame_undercuts_transfer(jax_frames):
    data, to, frame = jax_frames("tiled-f32-8MiB")
    assert len(frame) < data.nbytes // 4
    assert tb.get_decompressed_size(frame) == data.nbytes


# ---------------------------------------------------------------------------
# the literal-mask kernel's plain version and the whole match core
# ---------------------------------------------------------------------------


def _structured_rows(rng, nseg: int, seg: int, offs) -> np.ndarray:
    """Small-alphabet rows, half of them periodic at one of ``offs`` with
    1% breaks (tests/test_device_api.py:613-621)."""
    base = rng.integers(0, 6, (nseg, seg), dtype=np.uint8)
    for i in range(0, nseg, 2):
        d = offs[(i * 3 + 1) % len(offs)]
        keep = rng.random(seg) > 0.01
        row = base[i]
        for p in range(d, seg):
            if keep[p]:
                row[p] = row[p - d]
    return base


@pytest.mark.parametrize("pick", ["best", "random"])
def test_plain_nibble_equals_pallas_kernel(pick):
    """The plain version equals match_select_open_nibble in interpret
    mode at the JAX test's geometry (seg 16384, 16 rows), at the rows'
    best offsets and at arbitrary ones."""
    rng = np.random.default_rng(11)
    seg, nseg = 16384, 16
    offs = jdev._match_offsets(seg)
    assert pk.match_fusable(seg, offs)
    rows = _structured_rows(rng, nseg, seg, offs)
    if pick == "best":
        idx = np.asarray(jdev._device_match_core(jnp.asarray(rows), seg, offs)[1])
    else:
        idx = rng.integers(0, len(offs), nseg)
    d = np.asarray(offs, np.int32)[idx]
    bd = jnp.asarray(np.stack([idx, d], axis=1).astype(np.int32))
    want = pk.match_select_open_nibble(jnp.asarray(rows), bd, seg, offs, 16, 8)
    got = fm.match_nibble(torch.from_numpy(rows), torch.from_numpy(d))
    assert np.array_equal(got.numpy(), np.asarray(want))


def _core_rows(seg: int) -> np.ndarray:
    rng = np.random.default_rng(seg)
    offs = jdev._match_offsets(seg)
    rows = _structured_rows(rng, 12, seg, offs)
    rows[1] = np.arange(seg) % 251  # no equal bytes at any offset
    tie = np.arange(seg) % 251
    tie[50], tie[120] = tie[48], tie[116]  # one match at d=2, one at d=4
    rows[3] = tie
    rows[5] = 7  # constant: every offset matches, d=1 has the most
    return rows


@pytest.mark.parametrize("seg", [256, 1024, 4096])
def test_match_core_equals_xla_core(seg):
    """best, lit_counts and packed equal _device_match_core at seg the
    fused gate refuses, with offsets up to 1024, a row with no equal
    bytes (index 0, d = 1) and a tie (the lower index wins)."""
    offs = jdev._match_offsets(seg)
    assert not pk.match_fusable(seg, offs)
    rows = _core_rows(seg)
    _, best, lit_counts, packed = jdev._device_match_core(jnp.asarray(rows), seg, offs)
    got = tm.match_core(torch.from_numpy(rows), tm.match_offsets(seg))
    for name, a, b in zip(("best", "lit_counts", "packed"), got, (best, lit_counts, packed)):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    assert got[0][1] == 0 and got[0][3] == offs.index(2)


@pytest.mark.parametrize("seg", [16384, 262144])
def test_match_offsets_equal_tpu_blosc(seg):
    assert tm.match_offsets(seg) == jdev._match_offsets(seg)


def test_seg_not_multiple_of_8():
    """tpu_blosc's match core raises TypeError when seg % 8 != 0 (its
    eight strided bit-pack slices differ in length); the port raises the
    same.  compress_array never reaches it: block sizes are cut to a
    multiple of 8 * type_size (the ts3 and ts5 cases above)."""
    seg = 300
    rows = np.random.default_rng(0).integers(0, 3, (4, seg), dtype=np.uint8)
    with pytest.raises(TypeError):
        jdev._device_match_core(jnp.asarray(rows), seg, jdev._match_offsets(seg))
    with pytest.raises(TypeError):
        tm.match_core(torch.from_numpy(rows), tm.match_offsets(seg))
    for ts, bs in ((3, 300_001), (5, 250_007), (7, 1 << 20)):
        block = tb.chunk.choose_block_size(1 << 22, ts, bs)
        assert block % (8 * ts) == 0 and (block // ts) % 8 == 0


@pytest.mark.parametrize(
    "seg,d", [(256, 3), (256, 48), (1000, 96), (512, 7), (512, 1), (4096, 1024)]
)
def test_reconstruct_match_row_equals_tpu_blosc(seg, d):
    rng = np.random.default_rng(seg + d)
    row = np.tile(rng.integers(0, 256, d, np.uint8), seg // d + 1)[:seg].copy()
    lit = np.zeros(seg, bool)
    lit[:d] = True
    bad = rng.choice(np.arange(d, seg), min(10, seg - d), replace=False)
    row[bad] = 77
    lit[bad] = True
    for i in range(d, seg):
        if not lit[i]:
            row[i] = row[i - d]
    pos = np.flatnonzero(lit)
    want = jdev._reconstruct_match_row(seg, d, pos, row[pos])
    got = tm.reconstruct_match_row(seg, d, pos, row[pos])
    assert np.array_equal(got, want)
    assert np.array_equal(got, row)


def test_plain_nibble_offsets_past_the_row():
    """d at or past seg - 16 leaves no run of 8: the whole row is
    literal; a row with d < 1 is too."""
    seg = 256
    rows = torch.zeros((3, seg), dtype=torch.uint8)
    got = fm.match_nibble(rows, torch.tensor([seg - 20, 0, 1], dtype=torch.int32))
    assert bool((got[:2] == 0xF).all())
    lit = torch.stack([(got[2] >> t) & 1 for t in range(4)], dim=1).reshape(-1)
    assert lit[:1].all() and not lit[1 : seg - 16].any() and lit[seg - 16 :].all()


@pytest.mark.parametrize(
    "segs,row_d,tail,T",
    [
        (torch.zeros((2, 258), dtype=torch.uint8), torch.ones(2, dtype=torch.int32), 16, 8),
        (torch.zeros((2, 256), dtype=torch.int8), torch.ones(2, dtype=torch.int32), 16, 8),
        (torch.zeros((2, 256), dtype=torch.uint8), torch.ones(2, dtype=torch.int64), 16, 8),
        (torch.zeros((2, 256), dtype=torch.uint8), torch.ones(3, dtype=torch.int32), 16, 8),
        (torch.zeros((2, 256), dtype=torch.uint8), torch.ones(2, dtype=torch.int32), -1, 8),
        (torch.zeros((2, 256), dtype=torch.uint8), torch.ones(2, dtype=torch.int32), 16, 10),
        (torch.zeros((2, 512), dtype=torch.uint8)[:, ::2], torch.ones(2, dtype=torch.int32), 16, 8),
    ],
    ids=["seg-not-4", "dtype", "d-dtype", "d-shape", "tail", "T", "strided"],
)
def test_match_nibble_refuses_bad_arguments(segs, row_d, tail, T):
    with pytest.raises(ValueError):
        fm.match_nibble(segs, row_d, tail, T)


def test_match_kernel_wrapper_takes_cuda_tensors_only():
    """A CPU tensor never reaches the CUDA wrapper, and the wrapper
    refuses one without building anything; another device has no route."""
    segs = torch.zeros((2, 256), dtype=torch.uint8)
    d = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.match_nibble(segs, d, 16, 8)
    with pytest.raises(ValueError, match="no match-mask route"):
        fm.match_nibble(segs.to("meta"), d.to("meta"))
