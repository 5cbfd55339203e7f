"""The port's rle strategy against the JAX package's, on the CPU.

compress_array(strategy="rle") of tpu_blosc_torch and of tpu_blosc run on
the same numpy inputs, after tests/test_device_api.py:132-195.  Rle
frames are not the host encoder's, but they are deterministic, so the
contract is bytes: the two packages' frames must be equal, and each must
decode in both.  The plain versions of the two rle kernels are held to
the XLA device programs they replace and to a NumPy oracle; the CUDA
kernels themselves are held to their plain versions on the card by
chip_smoke.py.  Every comparison is exact.

The JAX frames are computed once per module (each shape compiles).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc import checkpoint as jc
from tpu_blosc import device as jdev
from tpu_blosc.codecs import lz4_ref
from tpu_blosc.native import backend as jnb
from tpu_blosc.options import Options as JOptions
from tpu_blosc_torch import checkpoint as tc
from tpu_blosc_torch import rle as tr
from tpu_blosc_torch.filters import kernels
from tpu_blosc_torch.filters import rle as fr
from tpu_blosc_torch.native import backend as tnb

KIB = 1 << 10


def _ramp(dtype):
    return lambda: (np.arange(300_000) % 700).astype(dtype)


def _staircase(n: int, step: int = 64, dtype=np.int32) -> np.ndarray:
    return (np.arange(n) // step).astype(dtype)


def _mixed_blocks() -> np.ndarray:
    """int32, 64 KiB blocks: blocks 0-3 staircases (all four planes
    run-sparse: the emitter writes them), blocks 4-7 a random low byte
    under constant upper bytes (three sparse planes and a dense one:
    rebuilt and re-encoded), block 8 random (four dense planes)."""
    rng = np.random.default_rng(31)
    per = 64 * KIB // 4
    stairs = _staircase(4 * per)
    noisy = (rng.integers(0, 256, 4 * per) | 0x5A5A00).astype(np.int32)
    return np.concatenate([stairs, noisy, rng.integers(0, 2**31, per, dtype=np.int32)])


def _one_sparse_block_of_nine() -> np.ndarray:
    """4 sparse segments of 36: under 1/8 of the bytes."""
    rng = np.random.default_rng(32)
    per = 64 * KIB // 4
    data = rng.integers(0, 2**31, 9 * per, dtype=np.int32)
    data[3 * per : 4 * per] = 7
    return data


def _flips(n: int, step: int, dtype) -> np.ndarray:
    """Stretches of 0 and of -1: run-sparse under the bit shuffle too,
    whose bytes within a run of equal elements repeat only when every bit
    is the same."""
    return (-(np.arange(n) // step % 2)).astype(dtype)


# name -> (data, options as keyword arguments, whether the frame differs
# from the transfer frame: the emitter wrote a block.  Where the strategy
# engages but rebuilds and re-encodes every block, the native codec writes
# the transfer frame's bytes.)
CASES = {
    "float32": (_ramp(np.float32), dict(type_size=4, block_size=64 * KIB), False),
    "float64": (_ramp(np.float64), dict(type_size=8, block_size=64 * KIB), False),
    "int16": (_ramp(np.int16), dict(type_size=2, block_size=64 * KIB), False),
    "float32-bitshuffle": (
        _ramp(np.float32), dict(type_size=4, block_size=64 * KIB, shuffle="BITSHUFFLE"), False,
    ),
    "lz4hc-level-9": (
        _ramp(np.float32), dict(type_size=4, block_size=64 * KIB, codec="LZ4HC", level=9), False,
    ),
    "ragged-tail": (
        lambda: (np.arange(70_001) % 90).astype(np.float32),
        dict(type_size=4, block_size=64 * KIB), False,
    ),
    "ratio-parity-f64": (
        lambda: (np.arange(600_000) % 1000).astype(np.float64),
        dict(type_size=8, block_size=64 * KIB), False,
    ),
    "stairs-1MiB-blocks": (
        lambda: _staircase(1 << 19), dict(type_size=4, block_size=1 << 20), True,
    ),
    "stairs-float32": (
        lambda: _staircase(100_000, 512, np.float32), dict(type_size=4, block_size=64 * KIB), True,
    ),
    "stairs-float64": (
        lambda: _staircase(100_000, 512, np.float64), dict(type_size=8, block_size=64 * KIB), True,
    ),
    "stairs-int16": (
        lambda: _staircase(200_000, 512, np.int16), dict(type_size=2, block_size=32 * KIB), True,
    ),
    "stairs-lz4hc-level-9": (
        lambda: _staircase(100_000, 512),
        dict(type_size=4, block_size=64 * KIB, codec="LZ4HC", level=9), True,
    ),
    "flips-int32-bitshuffle": (
        lambda: _flips(100_000, 4096, np.int32),
        dict(type_size=4, block_size=64 * KIB, shuffle="BITSHUFFLE"), True,
    ),
    "flips-int16-bitshuffle": (
        lambda: _flips(200_000, 2048, np.int16),
        dict(type_size=2, block_size=32 * KIB, shuffle="BITSHUFFLE"), True,
    ),
    "stairs-ragged-tail": (
        lambda: _staircase(70_001, 512), dict(type_size=4, block_size=64 * KIB), True,
    ),
    "stairs-ragged-tail-of-3-bytes": (
        lambda: _staircase(65_538, 512, np.int16).view(np.uint8)[:131_075].copy(),
        dict(type_size=2, block_size=32 * KIB), True,
    ),
    "mixed-sparse-and-dense": (_mixed_blocks, dict(type_size=4, block_size=64 * KIB), True),
    # the fallbacks: nothing sparse, under 1/8 of the bytes sparse, a codec
    # the emitter does not write
    "random-int32": (
        lambda: np.random.default_rng(1).integers(0, 2**31, 200_000, dtype=np.int32),
        dict(type_size=4, block_size=64 * KIB), False,
    ),
    "one-sparse-block-of-nine": (
        _one_sparse_block_of_nine, dict(type_size=4, block_size=64 * KIB), False,
    ),
    "zstd-takes-transfer": (
        lambda: (np.arange(100_000) % 100).astype(np.float32),
        dict(type_size=4, block_size=64 * KIB, codec="ZSTD"), False,
    ),
}

TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
                np.dtype(np.int32): torch.int32, np.dtype(np.int16): torch.int16,
                np.dtype(np.uint8): torch.uint8}


def _opts(kw):
    jkw, tkw = dict(kw), dict(kw)
    if "codec" in kw:
        jkw["codec"] = jb.Codec[kw["codec"]]
        tkw["codec"] = tb.Codec[kw["codec"]]
    if "shuffle" in kw:
        jkw["shuffle"] = jb.Shuffle[kw["shuffle"]]
        tkw["shuffle"] = tb.Shuffle[kw["shuffle"]]
    return JOptions(**jkw), tb.Options(**tkw)


class _Frames:
    """Data and tpu_blosc's rle frame per case, computed on first use."""

    def __init__(self):
        self._cache = {}

    def __call__(self, name: str):
        if name not in self._cache:
            make, kw, _ = CASES[name]
            data = make()
            jo, to = _opts(kw)
            frame = jb.compress_array(jnp.asarray(data), jo, strategy="rle")
            self._cache[name] = (data, to, frame)
        return self._cache[name]


@pytest.fixture(scope="module")
def jax_frames():
    return _Frames()


@pytest.mark.parametrize("name", list(CASES))
def test_rle_frame_equals_tpu_blosc(jax_frames, name):
    data, to, want = jax_frames(name)
    got = tb.compress_array(torch.from_numpy(data), to, strategy="rle")
    assert got == want


@pytest.mark.parametrize("name", list(CASES))
def test_rle_frame_decodes_in_both_packages(jax_frames, name):
    data, to, frame = jax_frames(name)
    assert jb.decompress(frame) == data.tobytes()
    assert tb.decompress(frame) == data.tobytes()
    out = tb.decompress_array(frame, TORCH_DTYPES[data.dtype], device="cpu", strategy="device")
    assert out.numpy().tobytes() == data.tobytes()


@pytest.mark.parametrize("name", list(CASES))
def test_rle_emits_or_writes_the_transfer_frame(jax_frames, name):
    data, to, frame = jax_frames(name)
    transfer = tb.compress_array(torch.from_numpy(data), to)
    assert transfer == tb.compress_with_options(data.tobytes(), to)
    assert (frame != transfer) == CASES[name][2]


def test_rle_ratio_within_5_percent_of_the_host_encoder(jax_frames):
    data, to, frame = jax_frames("ratio-parity-f64")
    assert len(frame) <= int(len(tb.compress_with_options(data.tobytes(), to)) * 1.05)


def test_rle_mixed_frame_has_emitted_encoded_and_raw_blocks(jax_frames):
    """The mixed case runs every branch: blocks the emitter wrote (their
    payloads are not the host encoder's), rebuilt blocks the native codec
    wrote, and a block stored raw."""
    data, to, frame = jax_frames("mixed-sparse-and-dense")
    header = tb.format.parse_header(frame)
    entries, _ = tb.chunk.parse_block_table(frame, header)
    host_entries, _ = tb.chunk.parse_block_table(
        tb.compress_with_options(data.tobytes(), to), header)
    assert len(entries) == 9
    assert [m for _, m in entries] == [False] * 8 + [True]
    assert entries[:4] != host_entries[:4] and entries[4:] == host_entries[4:]


def test_rle_refuses_a_block_of_broken_elements():
    """block_size % type_size: the strategy returns None before it
    touches the data (compress_array never cuts such blocks itself)."""
    flat = torch.zeros(4 * 65_536, dtype=torch.uint8)
    opts = tb.Options(type_size=3, block_size=65_536)
    assert tr.compress_array_rle(flat, opts, 4, 65_536) is None


def test_unknown_strategy_takes_the_transfer_route():
    data = _ramp(np.float32)()
    jo, to = _opts(dict(type_size=4, block_size=64 * KIB))
    want = jb.compress_array(jnp.asarray(data), jo, strategy="no-such-strategy")
    assert tb.compress_array(torch.from_numpy(data), to, strategy="no-such-strategy") == want
    assert want == tb.compress_with_options(data.tobytes(), to)


# ---------------------------------------------------------------------------
# the plain versions of the two kernels
# ---------------------------------------------------------------------------


def _rows(seg: int) -> np.ndarray:
    """Rows that try the edges: random, small alphabet, constant, one run
    but for the last byte, a change at every byte, and a row that ends
    with the byte the next row begins with."""
    rng = np.random.default_rng(seg)
    rows = [
        rng.integers(0, 256, seg, dtype=np.uint8),
        rng.integers(0, 2, seg, dtype=np.uint8),
        np.full(seg, 9, np.uint8),
        np.concatenate([np.full(seg - 1, 3, np.uint8), [4]]).astype(np.uint8),
        (np.arange(seg) % 2).astype(np.uint8),
        np.repeat(rng.integers(0, 256, seg // 8 + 1, dtype=np.uint8), 8)[:seg],
        np.full(seg, 5, np.uint8),
        np.full(seg, 5, np.uint8),
    ]
    return np.stack(rows)


def _oracle_runs(row: np.ndarray):
    starts = np.flatnonzero(np.concatenate([[True], row[1:] != row[:-1]]))
    return row[starts], np.diff(np.concatenate([starts, [row.size]]))


@pytest.mark.parametrize("seg", [1, 7, 256, 1000, 4096])
def test_plain_run_counts_equal_the_oracle(seg):
    rows = _rows(seg)
    got = fr.seg_run_counts(torch.from_numpy(rows))
    assert got.dtype == torch.int32
    assert got.tolist() == [len(_oracle_runs(r)[0]) for r in rows]


@pytest.mark.parametrize("shuffle", ["SHUFFLE", "BITSHUFFLE"])
@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.float64])
def test_plain_run_counts_equal_the_xla_program(dtype, shuffle):
    """The port's filter and count against _device_filter_seg_counts:
    the same segments, the same counts, the same tail."""
    data = np.concatenate([(np.arange(40_000) // 16).astype(dtype),
                           np.random.default_rng(4).integers(0, 100, 9_003).astype(dtype)])
    ts, bs = data.dtype.itemsize, 16 * KIB
    nb, seg = data.nbytes // bs, bs // ts
    mode = tb.Shuffle[shuffle]
    segs_j, counts_j, tail_j = jdev._device_filter_seg_counts(
        jnp.asarray(data), nb, bs, ts, int(mode), seg)
    flat = tb.device.tensor_bytes(torch.from_numpy(data))
    segs = tb.filters.filter_blocks(flat[: nb * bs].view(nb, bs), ts, mode).view(-1, seg)
    assert np.array_equal(segs.numpy(), np.asarray(segs_j))
    assert np.array_equal(fr.seg_run_counts(segs).numpy(), np.asarray(counts_j))
    assert flat[nb * bs:].numpy().tobytes() == np.asarray(tail_j).tobytes()


@pytest.mark.parametrize("seg", [1, 7, 256, 1000, 4096])
def test_plain_rows_rle_equals_the_oracle(seg):
    rows = _rows(seg)
    pick = np.array([6, 0, 7, 3, 3, 5, 2])  # out of order, one row twice
    counts = fr.seg_run_counts(torch.from_numpy(rows)).numpy()
    vals, lens = fr.rows_rle(torch.from_numpy(rows), pick, counts[pick])
    assert vals.dtype == torch.uint8 and lens.dtype == torch.int32
    want = [_oracle_runs(rows[r]) for r in pick]
    assert np.array_equal(vals.numpy(), np.concatenate([v for v, _ in want]))
    assert np.array_equal(lens.numpy(), np.concatenate([n for _, n in want]))
    # rows 6 and 7 hold one byte: their runs must not join
    assert lens[0] == seg and lens.numpy()[counts[pick][:2].sum()] == seg


@pytest.mark.parametrize("seg", [256, 1000, 4096])
def test_plain_rows_rle_equals_the_xla_program(seg):
    """Against _device_rows_rle, which pads the row list to a power of
    two with its last row and the records to a cap: the real records are
    the same without either."""
    rows = _rows(seg)
    pick = np.array([1, 2, 3, 5, 6, 7])
    counts = fr.seg_run_counts(torch.from_numpy(rows)).numpy().astype(np.int64)
    k, k_pad = pick.size, 8
    padded = np.concatenate([pick, np.full(k_pad - k, pick[-1])]).astype(np.int32)
    n_real = int(counts[pick].sum())
    cap = jdev._pow2(max(n_real + (k_pad - k) * int(counts[pick[-1]]), 4096))
    vals_j, lens_j = jdev._device_rows_rle(jnp.asarray(rows), jnp.asarray(padded), k_pad, cap)
    vals, lens = fr.rows_rle(torch.from_numpy(rows), pick, counts[pick])
    assert vals.numel() == n_real
    assert np.array_equal(vals.numpy(), np.asarray(vals_j[:n_real]))
    assert np.array_equal(lens.numpy(), np.asarray(lens_j[:n_real]))


def test_rows_rle_raises_when_the_counts_disagree():
    rows = torch.from_numpy(_rows(256))
    counts = fr.seg_run_counts(rows).numpy()
    with pytest.raises(RuntimeError, match="disagree"):
        fr.rows_rle(rows, np.array([0, 1]), counts[[0, 1]] + 1)


@pytest.mark.parametrize(
    "call",
    [
        lambda: fr.seg_run_counts(torch.zeros((2, 8), dtype=torch.int32)),
        lambda: fr.seg_run_counts(torch.zeros(16, dtype=torch.uint8)),
        lambda: fr.seg_run_counts(torch.zeros((2, 16), dtype=torch.uint8)[:, ::2]),
        lambda: fr.seg_run_counts(torch.zeros((2, 0), dtype=torch.uint8)),
        lambda: fr.rows_rle(torch.zeros((2, 8), dtype=torch.uint8), np.array([2]), np.array([1])),
        lambda: fr.rows_rle(torch.zeros((2, 8), dtype=torch.uint8), np.array([0, 1]),
                            np.array([1])),
        lambda: kernels.check_rows_args(torch.zeros((2, 8), dtype=torch.uint8),
                                        torch.zeros(2, dtype=torch.int64),
                                        torch.zeros(2, dtype=torch.int64)),
        lambda: kernels.check_rows_args(torch.zeros((2, 8), dtype=torch.uint8),
                                        torch.zeros(2, dtype=torch.int32),
                                        torch.zeros(3, dtype=torch.int64)),
    ],
    ids=["int32-segs", "1-D", "strided", "empty-rows", "row-out-of-range", "counts-short",
         "bases-short", "int32-rows"],
)
def test_rle_wrappers_refuse_bad_geometry(call):
    with pytest.raises(ValueError):
        call()


def test_rle_kernel_wrappers_take_cuda_tensors_only():
    segs = torch.zeros((2, 16), dtype=torch.uint8)
    idx = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.seg_run_counts(segs)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.rows_rle(segs, idx[:2], idx, 2)
    assert all(kernels.launches[k] == 0 for k in ("seg_run_counts", "rows_rle"))


@pytest.mark.parametrize("seg,ptr,want", [(256, 0, "vec16"), (4096, 1 << 20, "vec16"),
                                          (1000, 0, "generic"), (256, 4, "generic"),
                                          (1, 0, "generic")])
def test_rle_path_follows_geometry_and_alignment(seg, ptr, want):
    assert kernels.rle_path(seg, ptr) == want
    assert kernels.fill_path(seg, ptr) == want


def test_rle_constants_equal_the_cuda_source():
    """The wrappers pass each path as the number csrc/rle.cu gives it, and
    refuse the segment lengths its launchers refuse."""
    import os
    import re

    src = open(os.path.join(kernels.CSRC, "rle.cu")).read()
    enum = re.search(r"enum Path \{([^}]*)\}", src).group(1)
    numbers = {k.lower(): int(v) for k, v in re.findall(r"k(\w+) = (\d+)", enum)}
    assert numbers == kernels.RLE_PATHS
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    count_tile = const["kCountChunks"] * const["kThreads"] * const["kChunk"]
    assert kernels.MATCH_MAX_SEG == 2**31 - 1 - 2 * count_tile
    assert "seg <= INT32_MAX - 2 * kCountTile" in src and "seg % 16 == 0" in src


# ---------------------------------------------------------------------------
# the emitter, and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_lz4_emit_runs_against_the_decoders(seed):
    """The port's binding writes what tpu_blosc's does, and both the
    reference decoder and the native one read it back
    (tests/test_device_api.py:181-195)."""
    rng = np.random.default_rng(seed)
    for _ in range(5):
        nr = int(rng.integers(1, 40))
        lens = rng.integers(1, 50 if seed % 2 else 5000, nr).astype(np.int64)
        vals = rng.integers(0, 5, nr).astype(np.uint8)
        data = np.repeat(vals, lens).tobytes()
        stream = tnb.lz4_emit_runs(vals, lens, len(data))
        assert stream == jnb.lz4_emit_runs(vals, lens, len(data))
        assert lz4_ref.decompress_block(stream, len(data)) == data
        assert jnb.lz4_decompress(stream, len(data)) == data


def _ckpt_state():
    rng = np.random.default_rng(3)
    return {
        "stairs": _staircase(1 << 18).reshape(512, 512),
        "ramp": (np.arange(300_000) % 700).astype(np.float64),
        "noise": rng.integers(0, 2**31, 100_000, dtype=np.int32),
        "small": np.arange(100, dtype=np.float32),
        "step": 7,
    }


def _map_arrays(fn, tree):
    return {k: fn(v) if isinstance(v, np.ndarray) else v for k, v in tree.items()}


def test_save_pytree_rle_same_file_and_cross_load(tmp_path, monkeypatch):
    """save_pytree(strategy="rle") through the device-record pipeline
    (CPU tensors handed to it as device records) writes the file tpu_blosc
    writes from jax arrays, with rle frames in it; each package loads the
    other's, and the port's device load with strategy="records" gives
    every leaf back."""
    state = _ckpt_state()
    opts = dict(type_size=4, block_size=64 * KIB)
    mine, theirs, plain = tmp_path / "t.ckpt", tmp_path / "j.ckpt", tmp_path / "p.ckpt"
    monkeypatch.setattr(tc, "_on_cuda", lambda x: isinstance(x, torch.Tensor))
    tensors = _map_arrays(torch.from_numpy, state)
    tc.save_pytree(mine, tensors, tb.Options(**opts), strategy="rle")
    jc.save_pytree(theirs, _map_arrays(jnp.asarray, state), JOptions(**opts), strategy="rle")
    tc.save_pytree(plain, tensors, tb.Options(**opts))
    assert mine.read_bytes() == theirs.read_bytes()
    assert mine.read_bytes() != plain.read_bytes()  # the strategy engaged
    for strategy in ("transfer", "rle", "records"):
        back = tc.load_pytree(theirs, device="cpu", strategy=strategy)
        theirs_back = jc.load_pytree(mine, device=True, strategy=strategy)
        for key, want in state.items():
            if isinstance(want, np.ndarray):
                assert back[key].dtype == TORCH_DTYPES[want.dtype]
                assert np.array_equal(back[key].numpy(), want)
                assert np.array_equal(np.asarray(theirs_back[key]), want)
            else:
                assert back[key] == want and theirs_back[key] == want
    host = tc.load_pytree(mine)
    assert all(np.array_equal(host[k].numpy(), v) for k, v in state.items()
               if isinstance(v, np.ndarray))
