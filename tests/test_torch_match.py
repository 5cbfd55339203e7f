"""The port's match strategy against the JAX package's, on the CPU.

compress_array(strategy="match") of tpu_blosc_torch and of tpu_blosc run
on the same numpy inputs, after tests/test_device_api.py:228-680.  Match
frames are not the host encoder's, but they are deterministic, so the
contract is bytes: the two packages' frames must be equal, and each must
decode in both.  The literal-mask kernel's plain version is held to the
Pallas kernel (interpret mode) and to the XLA match core; the count
kernel's plain version to a NumPy oracle and to the XLA match core.  The
CUDA kernels themselves are held to their plain versions on the card by
chip_smoke.py.  Every comparison is exact.

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


# ---------------------------------------------------------------------------
# the count phase: plain version, router, path choice, wrapper refusals
# ---------------------------------------------------------------------------


def _count_oracle(rows: np.ndarray, offsets) -> np.ndarray:
    """First index of the largest count of p >= d with x[p] == x[p-d]; 0
    where every count is 0 (np.argmax takes the first maximum)."""
    counts = np.stack([(rows[:, d:] == rows[:, :-d]).sum(axis=1) for d in offsets], axis=1)
    return np.argmax(counts, axis=1)


def _count_rows(seg: int) -> np.ndarray:
    """_core_rows plus rows that try the edges of the count: two offsets
    tied with many pairs each, a pair only at the largest offset, and a
    periodic row followed by a row that starts with the same bytes."""
    rng = np.random.default_rng(seg + 1)
    rows = _core_rows(seg)
    distinct = np.arange(seg) % 251
    both = distinct.copy()
    for p in range(64, seg - 8, 16):  # as many pairs at d = 3 as at d = 8
        both[p], both[p + 8] = both[p - 3], both[p]
    far = distinct.copy()
    d_max = jdev._match_offsets(seg)[-1]
    far[seg - 1] = far[seg - 1 - d_max]
    pattern = rng.integers(0, 256, 48, dtype=np.uint8)
    periodic = np.tile(pattern, seg // 48 + 2)
    follower = distinct.copy()
    follower[:48] = periodic[seg: seg + 48]
    follower[100] = follower[99]
    return np.concatenate([rows, np.stack([both, far, periodic[:seg], follower]).astype(np.uint8)])


@pytest.mark.parametrize("n_offsets", [14, 20])
@pytest.mark.parametrize("seg", [256, 1024, 4096])
def test_count_best_plain_equals_oracle_and_xla_core(seg, n_offsets):
    """count_best_plain, and the router on CPU tensors, against NumPy and
    against _device_match_core's best, with the 14 offsets below 256 and
    with every offset below seg."""
    offs = tuple(d for d in jdev._match_offsets(seg) if n_offsets == 20 or d < 256)
    rows = _count_rows(seg)
    want = _count_oracle(rows, offs)
    best = np.asarray(jdev._device_match_core(jnp.asarray(rows), seg, offs)[1])
    assert np.array_equal(best, want)
    for fn in (fm.count_best_plain, fm.count_best):
        got = fn(torch.from_numpy(rows), offs)
        assert got.dtype == torch.int64 and got.shape == (rows.shape[0],)
        assert np.array_equal(got.numpy(), want), fn.__name__
    assert want[1] == 0 and want[3] == offs.index(2) and want[5] == 0
    if n_offsets == 20:  # the row whose only pair lies at the largest offset
        assert want[-3] == len(offs) - 1


@pytest.mark.parametrize("kind", ["distinct", "constant", "tie"])
@pytest.mark.parametrize("seg", [256, 1024, 4096])
def test_count_best_ties_and_empty_rows(seg, kind):
    """A row with no equal bytes gets index 0, a constant row d = 1, and
    of two offsets with the same count the lower index wins, wherever
    the tied offsets stand in the list."""
    distinct = (np.arange(seg) % 251).astype(np.uint8)
    offs = tm.match_offsets(seg)
    if kind == "distinct":
        rows, want = distinct[None], [0]
    elif kind == "constant":
        rows, want = np.full((1, seg), 9, np.uint8), [0]
    else:
        pairs = [(offs[i], offs[j]) for i, j in ((0, 1), (2, 5), (4, len(offs) - 1))]
        rows = np.stack([distinct] * len(pairs))
        for row, (lo, hi) in zip(rows, pairs):
            row[seg // 2] = row[seg // 2 - lo]
            row[seg - 3] = row[seg - 3 - hi]
        want = [offs.index(lo) for lo, _ in pairs]
    got = fm.count_best(torch.from_numpy(rows), offs)
    assert got.tolist() == want
    assert _count_oracle(rows, offs).tolist() == want


@pytest.mark.parametrize(
    "seg,segs_off,out_off,want",
    [
        (262144, 0, 0, "vec16"),     # a 1 MiB block of float32
        (65536, 0, 0, "vec16"),      # of 16-byte elements
        (256, 0, 0, "vec16"),        # the shortest segment compress_array gives
        (64, 32, 48, "vec16"),
        (262144, 4, 0, "generic"),   # rows of a view 4 bytes off
        (262144, 0, 8, "generic"),   # an unaligned output
        (262144, 1, 1, "generic"),
        (1000, 0, 0, "generic"),     # seg % 4 == 0 only
        (349528, 0, 0, "generic"),   # a 1 MiB block of 3-byte elements: seg % 8 == 0
        (16400, 0, 0, "generic"),    # seg % 16 == 0, not 64
        (32, 0, 0, "generic"),
    ],
)
def test_match_path_cases(seg, segs_off, out_off, want):
    base = 1 << 20
    assert kernels.match_path(seg, base + segs_off, base + out_off) == want
    if out_off == 0:  # the count kernel's call: no output to align
        assert kernels.match_path(seg, base + segs_off) == want


def test_match_path_takes_vec16_exactly_where_every_precondition_holds():
    base = 1 << 20
    for seg in (4, 60, 64, 128, 1000, 4096, 4100, 262144):
        for a in (0, 1, 4, 12, 16):
            for b in (0, 4, 32):
                fits = seg % 64 == 0 and a % 16 == 0 and b % 16 == 0
                got = kernels.match_path(seg, base + a, base + b)
                assert got == ("vec16" if fits else "generic"), (seg, a, b)


def test_match_constants_equal_the_cuda_source():
    """The wrappers pass each path as the number csrc/match.cu gives it,
    and refuse what its launchers refuse."""
    import os
    import re

    src = open(os.path.join(kernels.CSRC, "match.cu")).read()
    enum = re.search(r"enum Path \{([^}]*)\}", src).group(1)
    numbers = {k.lower(): int(v) for k, v in re.findall(r"k(\w+) = (\d+)", enum)}
    assert numbers == kernels.MATCH_PATHS
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kMaxOffsets"] == kernels.MATCH_MAX_OFFSETS
    assert const["kMaxT"] == kernels.MATCH_MAX_T
    assert kernels.MATCH_MAX_SEG == 2**31 - 1 - 2 * const["kTile"]
    assert "seg % 64 == 0" in src
    assert max(tm.match_offsets(1 << 20)) <= const["kHalo"]


def test_pick_match_path_takes_match_paths_choice_or_a_known_name():
    segs = torch.zeros((2, 256), dtype=torch.uint8)
    assert kernels._pick_match_path(None, segs) == kernels.match_path(256, segs.data_ptr())
    assert kernels._pick_match_path("generic", segs, 16) == "generic"
    with pytest.raises(ValueError, match="unknown match path"):
        kernels._pick_match_path("vec8", segs)


@pytest.mark.parametrize(
    "segs,offsets",
    [
        (torch.zeros((2, 256), dtype=torch.int8), (1, 2)),
        (torch.zeros((2, 512), dtype=torch.uint8)[:, ::2], (1, 2)),
        (torch.zeros(256, dtype=torch.uint8), (1, 2)),
        (torch.zeros((2, 258), dtype=torch.uint8), (1, 2)),
        (torch.zeros((2, 256), dtype=torch.uint8), (1, 256)),
        (torch.zeros((2, 256), dtype=torch.uint8), (0, 1)),
        (torch.zeros((2, 256), dtype=torch.uint8), tuple(range(1, 34))),
        (torch.zeros((2, 256), dtype=torch.uint8), ()),
        (torch.zeros((2, 256), dtype=torch.uint8), (1.0, 2)),
    ],
    ids=["dtype", "strided", "1-D", "seg-not-4", "d-at-seg", "d-0", "33-offsets",
         "no-offsets", "float-offset"],
)
def test_count_best_refuses_bad_arguments(segs, offsets):
    with pytest.raises(ValueError):
        fm.count_best(segs, offsets)
    with pytest.raises(ValueError):
        kernels.check_count_args(segs, offsets)


def test_count_kernel_wrapper_takes_cuda_tensors_only():
    """A CPU tensor never reaches the CUDA wrapper, and the wrapper
    refuses one without building anything, whatever the path; another
    device has no route; no launch is counted."""
    segs = torch.zeros((2, 256), dtype=torch.uint8)
    before = dict(kernels.launches)
    for path in (None, "vec16", "generic"):
        with pytest.raises(ValueError, match="CUDA"):
            kernels.match_count(segs, (1, 2), path=path)
        with pytest.raises(ValueError, match="CUDA"):
            kernels.match_nibble(segs, torch.ones(2, dtype=torch.int32), 16, 8, path=path)
    with pytest.raises(ValueError, match="no match-count route"):
        fm.count_best(segs.to("meta"), (1, 2))
    assert kernels.launches == before
    assert {f"{k}.{p}" for k in ("match_nibble", "match_count")
            for p in kernels.MATCH_PATHS} | {"match_count"} <= set(kernels.launches)


def test_match_core_takes_the_router(monkeypatch):
    """match_core's count phase is filters.match.count_best (the router to
    the kernel), not a loop of its own."""
    calls = []
    real = fm.count_best

    def spy(segs, offsets):
        calls.append((tuple(segs.shape), offsets))
        return real(segs, offsets)

    monkeypatch.setattr(fm, "count_best", spy)
    rows = _core_rows(256)
    tm.match_core(torch.from_numpy(rows), tm.match_offsets(256))
    assert calls == [((12, 256), tm.match_offsets(256))]
    assert not hasattr(tm, "count_best")


def test_literal_mask_router_and_wrapper():
    """literal_mask on CPU tensors is the popcount and pack of the plain
    nibbles; the CUDA wrapper of the packed form refuses CPU tensors and
    seg % 8 != 0 without building anything, and counts no launch."""
    rows = torch.from_numpy(_core_rows(256))
    d = torch.tensor([1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64], dtype=torch.int32)
    nib = fm.match_nibble_plain(rows, d)
    counts, packed = fm.literal_mask(rows, d)
    lit = torch.stack([(nib >> t) & 1 for t in range(4)], dim=2).reshape(12, 256)
    assert counts.dtype == torch.int32 and counts.tolist() == lit.sum(dim=1).tolist()
    assert np.array_equal(np.unpackbits(packed.numpy(), axis=1, bitorder="little"), lit.numpy())
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.match_mask(rows, d, 16, 8)
    with pytest.raises(ValueError, match="no match-mask route"):
        fm.literal_mask(rows.to("meta"), d.to("meta"))
    with pytest.raises(ValueError):
        fm.literal_mask(rows, d[:3])
    assert kernels.launches == before
