"""The port's records decode against the JAX package's, on the CPU.

decompress_array(strategy="records") (and "rle", the same) of
tpu_blosc_torch must give the transfer decode byte for byte, and what
tpu_blosc's records decode gives, on match, rle and host-encoder frames,
after tests/test_device_api.py:198-225, :434-597 and :642-690.  The fill
kernel's plain version is held to the XLA device program it replaces
(_device_match_decode) and to a NumPy oracle; the CUDA kernel itself is
held to its plain version on the card by chip_smoke.py.  Every comparison
is exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc import device as jdev
from tpu_blosc.options import Options as JOptions
from tpu_blosc_torch import match as tm
from tpu_blosc_torch import records as trec
from tpu_blosc_torch.filters import fill as ff
from tpu_blosc_torch.filters import kernels
from tpu_blosc_torch.native import backend as tnb

KIB = 1 << 10
MIB = 1 << 20

TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
                np.dtype(np.int16): torch.int16, np.dtype(np.uint16): torch.uint16}


# ---------------------------------------------------------------------------
# the fill kernel's plain version
# ---------------------------------------------------------------------------


def _fill_case(seg: int, offsets, seed: int = 0, every: int = 97):
    """One row per offset d: its first d bytes, about one byte in
    ``every`` after them and its last 16 are literal, the rest copies of
    the byte d before.  Returns (rows, row_d, pos, vals)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (len(offsets), seg), dtype=np.uint8)
    lit = np.zeros(rows.shape, bool)
    for r, d in enumerate(offsets):
        lit[r, :d] = True
        lit[r, d:] = rng.random(seg - d) < 1.0 / every
        lit[r, seg - 16:] = True
        for i in range(d, seg):
            if not lit[r, i]:
                rows[r, i] = rows[r, i - d]
    pos = np.flatnonzero(lit).astype(np.int32)
    return rows, np.asarray(offsets, np.int32), pos, rows.reshape(-1)[pos]


@pytest.mark.parametrize("seg,offsets", [
    (256, (1, 2, 3, 48, 96, 192)),
    (1000, (1, 3, 7, 96, 384, 768)),      # 7 and 96 do not divide 1000
    (4096, (1, 3, 48, 96, 1024, 12)),
    (18440, (1, 6, 24, 1024, 768, 512)),
])
def test_plain_fill_equals_the_oracle(seg, offsets):
    rows, row_d, pos, vals = _fill_case(seg, offsets, seed=seg)
    got = ff.match_fill(pos, vals, row_d, len(offsets), seg, "cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == rows.shape
    assert np.array_equal(got.numpy(), rows)
    for r, d in enumerate(offsets):  # the host's row rebuild agrees too
        mine = (pos >= r * seg) & (pos < (r + 1) * seg)
        assert np.array_equal(
            tm.reconstruct_match_row(seg, d, pos[mine] - r * seg, vals[mine]), rows[r])


def test_plain_fill_rows_without_a_record_past_d_and_without_any():
    """A row whose only literals are its first d bytes is those bytes
    repeated; a row with no record at all reads 0 (the JAX program's
    zeroed grid); the records of one row never reach another."""
    seg, d = 512, 48
    head = np.arange(1, d + 1, dtype=np.uint8)
    pos = np.concatenate([np.arange(d), 2 * seg + np.arange(d)]).astype(np.int32)
    vals = np.concatenate([head, head[::-1]])
    got = ff.match_fill(pos, vals, np.full(3, d, np.int32), 3, seg, "cpu").numpy()
    assert np.array_equal(got[0], np.tile(head, seg // d + 1)[:seg])
    assert not got[1].any()
    assert np.array_equal(got[2], np.tile(head[::-1], seg // d + 1)[:seg])


@pytest.mark.parametrize("mode", ["SHUFFLE", "BITSHUFFLE"])
@pytest.mark.parametrize("seg,offsets", [
    (1024, (1, 3, 48, 96, 512, 4, 1, 768)),
    (4096, (1024, 3, 6, 96, 1, 2, 384, 12)),
])
def test_plain_fill_equals_the_xla_program(seg, offsets, mode):
    """Against _device_match_decode, called as _decompress_array_rle
    calls it (padded records, a one-hot select of the offsets present):
    the port's fill and unfilter give its bytes, and filtering those bytes
    again gives the fill: the stream before the unfilter."""
    ts = 4
    bs, nseg = seg * ts, len(offsets)
    rows, row_d, pos, vals = _fill_case(seg, offsets, seed=seg + 1)
    present = tuple(sorted(set(offsets)))
    cap = jdev._cap_bucket(max(pos.size, 4096))
    pos_p = np.full(cap, nseg * seg, np.int32)
    pos_p[: pos.size] = pos
    vals_p = np.zeros(cap, np.uint8)
    vals_p[: pos.size] = vals
    sel = np.zeros((nseg, len(present)), bool)
    sel[np.arange(nseg), np.searchsorted(np.asarray(present), row_d)] = True
    shuffle = tb.Shuffle[mode]
    want = np.asarray(jdev._device_match_decode(
        jnp.asarray(vals_p), jnp.asarray(pos_p), jnp.asarray(sel), present, nseg, seg,
        bs, ts, int(shuffle), False))
    filled = ff.match_fill(pos, vals, row_d, nseg, seg, "cpu")
    got = tb.filters.unfilter_blocks(filled.view(-1, bs), ts, shuffle)
    assert np.array_equal(got.numpy().reshape(-1), want)
    refiltered = tb.filters.filter_blocks(torch.from_numpy(want.copy()).view(-1, bs), ts, shuffle)
    assert torch.equal(refiltered.view(nseg, seg), filled)


def _xla_decode(pos, vals, row_d, nseg, seg, ts, shuffle):
    """_device_match_decode, called as _decompress_array_rle calls it:
    padded records and a one-hot select of the offsets present."""
    present = tuple(sorted(set(row_d.tolist())))
    cap = jdev._cap_bucket(max(pos.size, 4096))
    pos_p = np.full(cap, nseg * seg, np.int32)
    pos_p[: pos.size] = pos
    vals_p = np.zeros(cap, np.uint8)
    vals_p[: pos.size] = vals
    sel = np.zeros((nseg, len(present)), bool)
    sel[np.arange(nseg), np.searchsorted(np.asarray(present), row_d)] = True
    return np.asarray(jdev._device_match_decode(
        jnp.asarray(vals_p), jnp.asarray(pos_p), jnp.asarray(sel), present, nseg, seg,
        seg * ts, ts, int(shuffle), False))


# the offsets by the width the kernel fills them in: bytes, words, uint4
EDGE_OFFSETS = {"bytes": (1, 2, 3, 6), "words": (4, 12, 24), "uint4": (16, 48, 256, 768, 1024)}
TILE = kernels.FILL_TILE


def _edge_case(seg: int, offsets, seed: int = 0):
    """One row per offset d and a last row of literals only.  Every row's
    first d bytes are literal.  Even rows have literals on both sides of
    each tile edge (TILE - 1, TILE, 2 TILE - 1, 2 TILE), odd rows only
    TILE - 1 and 2 TILE, so that their second tile holds no record at all;
    row 0 has 30% literals in its first tile (more than 256 records), the
    others about one in 500.  Returns (rows, row_d, pos, vals)."""
    rng = np.random.default_rng(seed)
    nrows = len(offsets) + 1
    row_d = np.asarray(list(offsets) + [offsets[0]], np.int32)
    rows = rng.integers(0, 256, (nrows, seg), dtype=np.uint8)
    lit = rng.random((nrows, seg)) < 1 / 500
    lit[0, :TILE] = rng.random(min(seg, TILE)) < 0.3
    lit[1::2, TILE:2 * TILE] = False
    for r, d in enumerate(row_d):
        lit[r, :d] = True
        edges = (TILE - 1, TILE, 2 * TILE - 1, 2 * TILE) if r % 2 == 0 else (TILE - 1, 2 * TILE)
        for e in edges:
            if e < seg:
                lit[r, e] = True
    lit[-1] = True
    for r, d in enumerate(row_d):  # the forward fill, column by column
        m = -(-seg // d)
        grid = np.zeros((m, d), np.uint8)
        grid.reshape(-1)[:seg] = rows[r]
        flags = np.zeros((m, d), bool)
        flags.reshape(-1)[:seg] = lit[r]
        for j in range(1, m):
            grid[j] = np.where(flags[j], grid[j], grid[j - 1])
        rows[r] = grid.reshape(-1)[:seg]
    pos = np.flatnonzero(lit).astype(np.int32)
    return rows, row_d, pos, rows.reshape(-1)[pos]


@pytest.mark.parametrize("width", list(EDGE_OFFSETS))
@pytest.mark.parametrize("seg", [TILE, TILE + 16, 2 * TILE, 3 * TILE + 5])
def test_plain_fill_at_the_tile_edges_equals_the_oracle(seg, width):
    """The cases the kernel's tiles make delicate: records on both sides
    of a tile edge, a tile with no record, a tile with more than 256, a
    row of literals only; rows of one tile, a tile and 16 bytes, two tiles,
    and three tiles and 5 bytes (no multiple of 16).  chip_smoke.py holds
    the kernel to its plain version on the same cases."""
    offsets = EDGE_OFFSETS[width]
    rows, row_d, pos, vals = _edge_case(seg, offsets, seed=seg)
    nseg = len(row_d)
    per_row = np.bincount(pos // seg, minlength=nseg)
    assert per_row[-1] == seg and np.count_nonzero(pos[pos < TILE]) > 256
    if seg >= 2 * TILE:
        second = (pos >= seg + TILE) & (pos < seg + 2 * TILE)  # row 1's second tile
        assert not second.any()
    got = ff.match_fill(pos, vals, row_d, nseg, seg, "cpu")
    assert np.array_equal(got.numpy(), rows)
    for r, d in enumerate(row_d):
        mine = (pos >= r * seg) & (pos < (r + 1) * seg)
        assert np.array_equal(
            tm.reconstruct_match_row(seg, int(d), pos[mine] - r * seg, vals[mine]), rows[r])


@pytest.mark.parametrize("seg,width", [(2 * TILE, "bytes"), (2 * TILE, "words"),
                                       (2 * TILE, "uint4"), (TILE + 16, "uint4")])
def test_plain_fill_at_the_tile_edges_equals_the_xla_program(seg, width):
    ts = 4
    offsets = EDGE_OFFSETS[width]
    while (len(offsets) + 1) % ts:  # whole blocks of ts rows
        offsets += offsets[:1]
    rows, row_d, pos, vals = _edge_case(seg, offsets, seed=seg + 1)
    nseg = len(row_d)
    want = _xla_decode(pos, vals, row_d, nseg, seg, ts, tb.Shuffle.SHUFFLE)
    filled = ff.match_fill(pos, vals, row_d, nseg, seg, "cpu")
    assert np.array_equal(filled.numpy(), rows)
    got = tb.filters.unfilter_blocks(filled.view(-1, seg * ts), ts, tb.Shuffle.SHUFFLE)
    assert np.array_equal(got.numpy().reshape(-1), want)


def test_plain_fill_holds_at_2_to_the_23_steps_a_column():
    """One (1, 2**24) row at d = 1: 2**24 steps down the one column, where
    an int32 (index + 1) << 8 | byte key has long overflowed."""
    seg = 1 << 24
    rng = np.random.default_rng(2)
    pos = np.unique(np.concatenate([[0], rng.choice(seg, 40, replace=False),
                                    [(1 << 23) + 5, seg - 1]])).astype(np.int32)
    vals = rng.integers(0, 256, pos.size, dtype=np.uint8)
    got = ff.match_fill(pos, vals, np.ones(1, np.int32), 1, seg, "cpu").numpy()[0]
    want = np.repeat(vals, np.diff(np.concatenate([pos, [seg]])))
    assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "call",
    [
        lambda: ff.match_fill(np.zeros(1, np.int32), np.zeros(1, np.uint8),
                              np.zeros(2, np.int32), 2, 64, "cpu"),
        lambda: ff.match_fill(np.zeros(1, np.int32), np.zeros(1, np.uint8),
                              np.full(2, 1025, np.int32), 2, 4096, "cpu"),
        lambda: ff.match_fill(np.array([128], np.int32), np.zeros(1, np.uint8),
                              np.ones(2, np.int32), 2, 64, "cpu"),
        lambda: ff.match_fill(np.zeros(2, np.int32), np.zeros(1, np.uint8),
                              np.ones(2, np.int32), 2, 64, "cpu"),
        lambda: ff.match_fill(np.zeros(1, np.int32), np.zeros(1, np.uint8),
                              np.ones(3, np.int32), 2, 64, "cpu"),
        lambda: ff.match_fill(np.zeros(0, np.int32), np.zeros(0, np.uint8),
                              np.ones(2, np.int32), 2, 1 << 30, "cpu"),
    ],
    ids=["d-0", "d-1025", "position-past-the-end", "vals-short", "row_d-long", "2-GiB"],
)
def test_fill_wrapper_refuses_bad_arguments(call):
    with pytest.raises(ValueError):
        call()


def test_fill_kernel_wrapper_takes_cuda_tensors_only():
    pos = torch.zeros(1, dtype=torch.int32)
    first = torch.tensor([0, 1], dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.match_fill(pos, pos.to(torch.uint8), first, torch.ones(1, dtype=torch.int32), 1, 64)
    assert kernels.launches["match_fill"] == 0


def test_fill_constants_equal_the_cuda_source():
    """The wrapper passes each path as the number csrc/fill.cu gives it,
    and takes the offsets its kernel takes: every candidate of the match
    strategy."""
    import os
    import re

    src = open(os.path.join(kernels.CSRC, "fill.cu")).read()
    enum = re.search(r"enum Path \{([^}]*)\}", src).group(1)
    numbers = {k.lower(): int(v) for k, v in re.findall(r"k(\w+) = (\d+)", enum)}
    assert numbers == kernels.FILL_PATHS
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kMaxD"] == kernels.FILL_MAX_D >= max(tm.match_offsets(1 << 20))
    assert const["kTile"] == kernels.FILL_TILE >= const["kMaxD"]
    # whole flag words a tile, whole warps a block, and room for 8 blocks
    # of 64 registers a thread on a multiprocessor's 65,536
    assert const["kTile"] % 32 == 0 and const["kThreads"] % 32 == 0
    assert const["kThreads"] * 64 * 8 <= 65536
    assert kernels.fill_path(const["kTile"], 0) == "vec16"
    assert kernels.fill_path(const["kTile"] + 5, 0) == kernels.fill_path(4096, 4) == "generic"
    assert "nseg <= INT32_MAX / seg" in src and "seg % 16 == 0" in src


def test_tune_fill_builds_its_variants_from_the_source_constants():
    """tune_fill replaces constexpr ints of csrc/fill.cu by name, leaves
    the rest of the source alone and refuses a name the source lacks."""
    import os

    from tpu_blosc_torch import tune_fill

    src = open(os.path.join(kernels.CSRC, "fill.cu")).read()
    assert tune_fill.variant_source(src, "base:") == ("base", src)
    name, got = tune_fill.variant_source(src, "wide:kThreads=256,kAhead=2")
    assert name == "wide" and got != src
    assert "constexpr int kThreads = 256;" in got and "constexpr int kAhead = 2;" in got
    assert len(got.splitlines()) == len(src.splitlines())
    with pytest.raises(SystemExit):
        tune_fill.variant_source(src, "bad:kNoSuchConstant=1")
    assert "extern \"C\" int store_rows" in tune_fill.STORES_SOURCE
    assert tune_fill.main([]) == 1  # no card here


# ---------------------------------------------------------------------------
# the host helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nseg,seg,T,p", [
    (64, 1024, 8, 0.5), (16, 4096, 8, 0.97), (5, 320, 8, 0.9),
    (100, 128, 8, 0.99), (3, 64, 5, 0.3), (2, 192, 12, 0.95),
])
def test_open_mask_bits_equals_the_byte_oracle(nseg, seg, T, p):
    eq = np.random.default_rng(17).random((nseg, seg)) < p
    ref = trec.open_mask_bytes(eq.copy(), T)
    assert np.array_equal(trec.open_mask_bits(eq.copy(), T), ref)
    packed = trec.open_mask_bits(eq.copy(), T, packed=True)
    assert np.array_equal(np.unpackbits(packed, axis=1, bitorder="little").view(bool), ref)
    assert np.array_equal(ref, jdev._open_mask_bytes(eq.copy(), T))


@pytest.mark.parametrize("seg", [512, 1000])
def test_host_literal_mask_equals_tpu_blosc_and_its_scan(seg):
    """The packed mask and the native scan give flatnonzero of the bool
    mask; where seg % 64 != 0 there is no packed form and the byte-domain
    opening serves."""
    rng = np.random.default_rng(23)
    rows2d = rng.integers(0, 4, size=(32, seg)).astype(np.uint8)
    d_all = np.asarray([1, 2, 3, 4, 48, 96, 192, 4] * 4, np.int32)
    lit = trec.host_lit_mask(rows2d, d_all, 8)
    assert np.array_equal(lit, jdev._host_lit_mask(rows2d, d_all, 8))
    assert np.array_equal(trec.lit_eq(rows2d, d_all), jdev._lit_eq(rows2d, d_all))
    packed = trec.host_lit_mask_packed(rows2d, d_all, 8)
    if seg % 64:
        assert packed is None and jdev._host_lit_mask_packed(rows2d, d_all, 8) is None
        return
    n_real = int(np.bitwise_count(packed).sum(dtype=np.int64))
    assert n_real == int(lit.sum())
    assert np.array_equal(tnb.mask_positions(packed.reshape(-1), n_real),
                          np.flatnonzero(lit).astype(np.int32))


def test_offset_choice_equals_tpu_blosc():
    """The offset with the most equal bytes in the first 8192 bytes, the
    first candidate on a tie (a constant row takes d = 1)."""
    rng = np.random.default_rng(5)
    seg = 16384
    offsets = tm.match_offsets(seg)
    assert offsets == jdev._match_offsets(seg)
    rows = np.stack([np.tile(rng.integers(0, 256, d, dtype=np.uint8), seg // d + 1)[:seg]
                     for d in (3, 48, 96, 1024, 7)] + [np.full(seg, 9, np.uint8)])
    rows[0, 9000:] = rng.integers(0, 256, seg - 9000)  # past the sample: not seen
    got = trec.choose_offsets(rows, offsets)
    assert got.dtype == np.int32 and got.tolist()[:4] == [3, 48, 96, 1024] and got[5] == 1


# ---------------------------------------------------------------------------
# the strategy
# ---------------------------------------------------------------------------


def _tiled_pattern(n_elems: int, period: int = 256, noise_pct: int = 100):
    rng = np.random.default_rng(5)
    data = np.tile(rng.random(period).astype(np.float32), n_elems // period)
    hit = rng.choice(data.size, max(data.size // noise_pct, 1), replace=False)
    data[hit] += rng.random(hit.size).astype(np.float32) * 0.01
    return data


def _periodic_planes(n_elems: int, period: int, dtype, seed=9):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    pattern = rng.integers(info.min, info.max, period, dtype)
    data = np.tile(pattern, n_elems // period + 1)[:n_elems].copy()
    starts = rng.choice(n_elems - 8, max(n_elems // 512, 1), replace=False)
    for w in range(4):
        data[starts + w] ^= dtype(rng.integers(1, 127))
    return data


def _six_periods():
    rng = np.random.default_rng(21)
    bs = 256 * KIB
    return np.concatenate([np.tile(rng.random(p).astype(np.float32), bs // 4 // p)
                           for p in (4, 8, 16, 32, 64, 128)])


# name -> (data, options as keyword arguments, the strategy that writes the frame)
FRAMES = {
    "runs-host-frame": (lambda: (np.arange(262_144) // 64).astype(np.float32),
                        dict(type_size=4, block_size=64 * KIB), "host"),
    "runs-int32-host-frame": (lambda: (np.arange(131_072) // 32).astype(np.int32),
                              dict(type_size=4, block_size=32 * KIB), "host"),
    "runs-rle-frame": (lambda: (np.arange(1 << 19) // 64).astype(np.int32),
                       dict(type_size=4, block_size=MIB), "rle"),
    "bitshuffle-int16-host-frame": (lambda: (np.arange(131_072) // 128).astype(np.int16),
                                    dict(type_size=2, block_size=32 * KIB, shuffle="BITSHUFFLE"),
                                    "host"),
    "bitshuffle-int16-match-frame": (
        lambda: np.tile(np.random.default_rng(8).integers(0, 1 << 12, 64, np.int16), MIB // 64),
        dict(type_size=2, block_size=512 * KIB, shuffle="BITSHUFFLE"), "match"),
    "tiled-f32-host-frame": (lambda: _tiled_pattern(MIB), dict(type_size=4, block_size=512 * KIB),
                             "host"),
    "tiled-f32-match-frame": (lambda: _tiled_pattern(MIB), dict(type_size=4, block_size=512 * KIB),
                              "match"),
    "six-offsets-host-frame": (_six_periods, dict(type_size=4, block_size=256 * KIB), "host"),
    "period-3-int32-match-frame": (lambda: _periodic_planes(MIB, 3, np.int32),
                                   dict(type_size=4, block_size=512 * KIB), "match"),
    "pitch-96-uint16-match-frame": (lambda: _periodic_planes(2 * MIB, 48, np.uint16),
                                    dict(type_size=2, block_size=512 * KIB), "match"),
    # seg 10240 = 5 * 2**11: 96 does not divide it
    "period-96-seg-10240-host-frame": (
        lambda: np.tile(np.random.default_rng(4).integers(0, 2**31, 96, dtype=np.int32),
                        8 * 10240 // 96 + 1)[: 8 * 10240],
        dict(type_size=4, block_size=40 * KIB), "host"),
    "lz4hc-host-frame": (lambda: _tiled_pattern(MIB // 2),
                         dict(type_size=4, block_size=256 * KIB, codec="LZ4HC", level=9), "host"),
}


def _opts(kw):
    jkw, tkw = dict(kw), dict(kw)
    if "codec" in kw:
        jkw["codec"] = jb.Codec[kw["codec"]]
        tkw["codec"] = tb.Codec[kw["codec"]]
    if "shuffle" in kw:
        jkw["shuffle"] = jb.Shuffle[kw["shuffle"]]
        tkw["shuffle"] = tb.Shuffle[kw["shuffle"]]
    return JOptions(**jkw), tb.Options(**tkw)


def _frame(name: str):
    make, kw, writer = FRAMES[name]
    data = make()
    _, to = _opts(kw)
    if writer == "host":
        return data, tb.compress_with_options(data.tobytes(), to)
    return data, tb.compress_array(torch.from_numpy(data), to, strategy=writer)


@pytest.fixture
def fills(monkeypatch):
    """The offsets of every fill the records decode runs."""
    seen = []
    real = ff.match_fill

    def spy(pos, vals, row_d, nseg, seg, device):
        seen.append(sorted(set(np.asarray(row_d).tolist())))
        return real(pos, vals, row_d, nseg, seg, device)

    monkeypatch.setattr(ff, "match_fill", spy)
    return seen


@pytest.mark.parametrize("strategy", ["records", "rle"])
@pytest.mark.parametrize("name", list(FRAMES))
def test_records_decode_equals_the_transfer_decode(fills, name, strategy):
    data, frame = _frame(name)
    dtype = TORCH_DTYPES[data.dtype]
    got = tb.decompress_array(frame, dtype, device="cpu", strategy=strategy)
    assert len(fills) == 1, "the records route engaged"
    plain = tb.decompress_array(frame, dtype, device="cpu", strategy="transfer")
    assert got.dtype == dtype and torch.equal(got, plain)
    assert got.numpy().tobytes() == data.tobytes()


@pytest.mark.parametrize("name", ["runs-rle-frame", "tiled-f32-match-frame",
                                  "six-offsets-host-frame", "period-3-int32-match-frame",
                                  "bitshuffle-int16-match-frame"])
def test_records_decode_equals_tpu_blosc(name):
    data, frame = _frame(name)
    theirs = jb.decompress_array(frame, data.dtype, strategy="records")
    mine = tb.decompress_array(frame, TORCH_DTYPES[data.dtype], shape=data.shape,
                               device="cpu", strategy="records")
    assert mine.numpy().tobytes() == np.asarray(theirs).tobytes() == data.tobytes()
    assert jb.decompress(frame) == data.tobytes()


def test_records_decode_fills_six_offsets_in_one_frame(fills):
    data, frame = _frame("six-offsets-host-frame")
    out = tb.decompress_array(frame, torch.float32, device="cpu", strategy="records")
    assert np.array_equal(out.numpy(), data)
    assert len(fills) == 1 and len(fills[0]) >= 5, fills


@pytest.mark.parametrize("name,want", [("period-3-int32-match-frame", 3),
                                       ("pitch-96-uint16-match-frame", 48),
                                       ("period-96-seg-10240-host-frame", 96)])
def test_records_decode_fills_offsets_that_do_not_divide_the_segment(fills, name, want):
    data, frame = _frame(name)
    seg = tb.format.parse_header(frame).block_size // data.dtype.itemsize
    out = tb.decompress_array(frame, TORCH_DTYPES[data.dtype], device="cpu", strategy="records")
    assert out.numpy().tobytes() == data.tobytes()
    assert want in fills[0] and any(seg % d for d in fills[0]), (fills, seg)


def test_records_decode_of_a_16_mib_segment_at_offset_1(fills):
    """seg = 2**23 at d = 1 (tests/test_device_api.py:498-513): the fill
    carries no index that could overflow."""
    n_elems = 8 * MIB
    data = np.full(n_elems, 7, np.uint16)
    data[np.random.default_rng(0).choice(n_elems, 42, replace=False)] = 12345
    frame = tb.compress_array(torch.from_numpy(data),
                              tb.Options(type_size=2, block_size=16 * MIB), strategy="match")
    out = tb.decompress_array(frame, torch.uint16, device="cpu", strategy="records")
    assert fills == [[1]]
    assert np.array_equal(out.numpy(), data)
    plain = tb.decompress_array(frame, torch.uint16, device="cpu", strategy="transfer")
    assert torch.equal(out, plain)


def _small_alphabet() -> np.ndarray:
    """int32 values 0..3: three constant planes and one of random 2-bit
    bytes, a quarter of the stream literal."""
    return np.random.default_rng(6).integers(0, 4, 1 << 18).astype(np.int32)


def _with_a_raw_block() -> np.ndarray:
    data = (np.arange(1 << 18) // 64).astype(np.int32)
    data[: 1 << 14] = np.random.default_rng(7).integers(0, 2**31, 1 << 14)
    return data


# name -> the frame: each fails one gate of the records route
GATES = {
    "container": lambda: tb.container.compress_container(
        (np.arange(1 << 18) // 64).astype(np.int32).tobytes(),
        tb.Options(type_size=4, block_size=64 * KIB), frame_limit=300_000),
    "single-block": lambda: tb.compress_with_options(
        (np.arange(4096) // 64).astype(np.int32).tobytes(), tb.Options(type_size=4)),
    "noshuffle": lambda: tb.compress_with_options(
        (np.arange(1 << 18) // 64).astype(np.int32).tobytes(),
        tb.Options(type_size=4, block_size=64 * KIB, shuffle=tb.Shuffle.NOSHUFFLE)),
    "zstd": lambda: tb.compress_with_options(
        (np.arange(1 << 18) // 64).astype(np.int32).tobytes(),
        tb.Options(type_size=4, block_size=64 * KIB, codec=tb.Codec.ZSTD)),
    "ragged-tail": lambda: tb.compress_with_options(
        (np.arange((1 << 18) + 4) // 64).astype(np.int32).tobytes(),
        tb.Options(type_size=4, block_size=64 * KIB)),
    "a-block-stored-raw": lambda: tb.compress_with_options(
        _with_a_raw_block().tobytes(), tb.Options(type_size=4, block_size=64 * KIB)),
    "seg-under-256": lambda: tb.compress_with_options(
        (np.arange(1 << 14) // 64).astype(np.int32).tobytes(),
        tb.Options(type_size=4, block_size=512)),
    "too-many-literals": lambda: tb.compress_with_options(
        _small_alphabet().tobytes(), tb.Options(type_size=4, block_size=64 * KIB)),
}


@pytest.mark.parametrize("name", list(GATES))
def test_every_gate_gives_the_transfer_result(fills, name):
    frame = GATES[name]()
    n = tb.get_decompressed_size(frame)
    got = tb.decompress_array(frame, torch.int32, device="cpu", strategy="records")
    assert fills == [], "the frame took the transfer route"
    assert trec.decompress_array_records(frame, n, torch.device("cpu")) is None
    assert torch.equal(got, tb.decompress_array(frame, torch.int32, device="cpu",
                                                strategy="transfer"))
    assert got.numpy().tobytes() == tb.decompress(frame)
    if name != "container":  # tpu_blosc's decompress_array takes plain frames only
        theirs = jb.decompress_array(frame, np.int32, strategy="records")
        assert np.asarray(theirs).tobytes() == got.numpy().tobytes()


def test_a_block_stored_raw_is_refused_before_anything_is_decoded(monkeypatch):
    frame = GATES["a-block-stored-raw"]()
    header = tb.format.parse_header(frame)
    entries, _ = tb.chunk.parse_block_table(frame, header)
    assert any(m for _, m in entries)
    monkeypatch.setattr(tb.device._nb, "decompress_blocks",
                        lambda *a, **k: pytest.fail("decoded a frame it must refuse"))
    n = header.nbytes_orig
    assert tb.device._decode_filtered_blocks(frame, header, n, 1, forbid_memcpy=True) is None


def test_unknown_decode_strategy_takes_the_transfer_route(fills):
    data, frame = _frame("runs-host-frame")
    got = tb.decompress_array(frame, torch.float32, device="cpu", strategy="no-such-strategy")
    assert fills == [] and np.array_equal(got.numpy(), data)
    theirs = jb.decompress_array(frame, np.float32, strategy="no-such-strategy")
    assert np.array_equal(np.asarray(theirs), data)
