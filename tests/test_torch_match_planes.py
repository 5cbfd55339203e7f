"""A NumPy model of the count kernel's arithmetic, on the CPU.

``tpbt_match_count`` (tpu_blosc_torch/csrc/match.cu) keeps a tile of a
row as bit planes: a group of 32 positions is 8 words, bit l of word k
being bit k of the group's byte l, so one logic instruction compares 32
positions.  The model below takes the kernel's steps one by one, in
NumPy: the staging of 16-byte chunks at swizzled slots; each group's
planes by the kernel's byte permutes and bit-block swaps; the partner
plane of an offset d = 32q + r as a funnel shift of two planes, across
group edges, from the thread's registers (d < 64) or from shared memory;
the masks that keep positions below d on a row's first tile (whose halo
is never loaded), past the row's end and past a short last tile's end
out of a count; the whole units counted with no mask; the byte-by-byte
path of offsets above the halo.  Its counts must equal direct NumPy
counts, and its first arg-max ``_device_match_core``'s best on the CPU
(as tests/test_torch_match.py does for the plain version).  The model
reads its geometry from the CUDA source.  The plain version in the
package stays ``filters/match.py`` ``count_best_plain``; chip_smoke.py
holds the kernel to it on the card.

These tests check the design, not the kernel: they read only the
``constexpr`` constants of match.cu, so an edit to its plane transpose,
swizzle, masks or window indexing leaves every one of them passing.  The
kernel's correctness rests on chip_smoke.py, which compares its whole
table of counts and its indices with the plain versions on the card.
"""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_match import _count_rows
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

from tpu_blosc import device as jdev
from tpu_blosc_torch import match as tm
from tpu_blosc_torch.filters import kernels

_SRC = open(os.path.join(kernels.CSRC, "match.cu")).read()
_CONST = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", _SRC)}
TILE, HALO, UNIT = _CONST["kTile"], _CONST["kHalo"], _CONST["kUnit"]
THREADS = _CONST["kCountThreads"]
GROUPS = UNIT // 32  # groups of 32 positions a thread owns
U32, U64 = np.uint32, np.uint64
SEGS = (256, 1000, 4096, 18440)


def _offsets(seg: int) -> tuple[int, ...]:
    """Every candidate offset below seg, 3000 (above the halo) and seg - 20."""
    return tuple(sorted({*tm.match_offsets(seg), *(d for d in (3000, seg - 20) if d < seg)}))


# ---------------------------------------------------------------------------
# the kernel's steps
# ---------------------------------------------------------------------------


def swizzle(c):
    """Chunk slot of the 16-byte chunk c of a staged span (match.cu swizzle)."""
    return c ^ ((c >> 3) & 7)


def byte_perm(x, y, s: int):
    """__byte_perm: byte n of the result is byte (s >> 4n) & 7 of y:x."""
    v = (y.astype(U64) << U64(32)) | x.astype(U64)
    out = np.zeros(x.shape, U32)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= ((v >> U64(8 * sel)) & U64(0xFF)).astype(U32) << U32(8 * n)
    return out


def swap_bits(x, y, s: int, mask: int):
    """match.cu swap_bits: the bits of x at mask << s trade with y's at mask."""
    t = ((x >> U32(s)) ^ y) & U32(mask)
    return x ^ (t << U32(s)), y ^ t


def bit_planes(w: np.ndarray) -> np.ndarray:
    """match.cu bit_planes on (8, G) words (word i = bytes 4i..4i+3 of each
    of G groups): the (8, G) planes."""
    v = [None] * 8
    for e in range(2):
        x0 = byte_perm(w[e], w[2 + e], 0x5140)
        x1 = byte_perm(w[e], w[2 + e], 0x7362)
        x2 = byte_perm(w[4 + e], w[6 + e], 0x5140)
        x3 = byte_perm(w[4 + e], w[6 + e], 0x7362)
        v[e], v[2 + e] = byte_perm(x0, x2, 0x5410), byte_perm(x0, x2, 0x7632)
        v[4 + e], v[6 + e] = byte_perm(x1, x3, 0x5410), byte_perm(x1, x3, 0x7632)
    for a in range(4):
        v[2 * a], v[2 * a + 1] = swap_bits(v[2 * a], v[2 * a + 1], 4, 0x0F0F0F0F)
    for i in (0, 1, 4, 5):
        v[i], v[i + 2] = swap_bits(v[i], v[i + 2], 1, 0x55555555)
    for i in range(4):
        v[i], v[i + 4] = swap_bits(v[i], v[i + 4], 2, 0x33333333)
    return np.stack([v[((k & 3) << 1) | (k >> 2)] for k in range(8)])


def direct_planes(span: np.ndarray) -> np.ndarray:
    """The (8, G) planes of bytes, straight from the definition."""
    b = span.reshape(-1, 32)
    bits = ((b[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1).astype(U64)
    return (bits << np.arange(32, dtype=U64)).sum(axis=-1).astype(U32).T


def planes_of(span: np.ndarray) -> np.ndarray:
    """The kernel's planes of a span of whole groups."""
    return bit_planes(span.view("<u4").reshape(-1, 8).T.copy())


def funnelshift_l(lo, hi, r: int):
    """The high word of (hi:lo) << (r & 31)."""
    r &= 31
    return (((hi.astype(U64) << U64(32)) | lo.astype(U64)) << U64(r) >> U64(32)).astype(U32)


def bits_below(b):
    """The lowest b bits of a word, for any b."""
    b = np.asarray(b, np.int64)
    return np.where(b >= 32, 0xFFFFFFFF, (1 << np.clip(b, 0, 31)) - 1).astype(U32)


def popc(x) -> np.ndarray:
    return np.bitwise_count(np.asarray(x, U32)).astype(np.int64)


def stage(row: np.ndarray, p0: int, stale: np.ndarray) -> np.ndarray:
    """The staged span of the tile at p0 as the kernel's units read it back:
    bytes [p0 - HALO, end) written at their swizzled chunk slots over
    ``stale`` (what shared memory held), only those in [0, seg), then
    chunk m of unit u read at slot 8u + (m ^ (u & 7))."""
    seg = row.size
    a, end = p0 - HALO, min(p0 + TILE, seg)
    smem = stale.copy()
    pos = np.arange(max(a, 0), end)
    k = pos - a
    smem[16 * swizzle(k >> 4) + (k & 15)] = row[pos]
    c = np.arange(smem.size // 16)
    return smem.reshape(-1, 16)[8 * (c >> 3) + ((c & 7) ^ ((c >> 3) & 7))].reshape(-1)


def tile_planes(row: np.ndarray, p0: int, stale_bytes, stale_planes) -> np.ndarray:
    """The (8, groups of the span) planes of the tile at p0: its units'
    from the staged bytes, the halo units' from them too except on a row's
    first tile, where they keep what shared memory held."""
    planes = planes_of(stage(row, p0, stale_bytes))
    if p0 == 0:
        planes[:, : HALO // 32] = stale_planes[:, : HALO // 32]
    return planes


def mismatch(planes: np.ndarray, d: int, first: int, n: int) -> np.ndarray:
    """M of the n groups from span group ``first``: OR over the planes of
    each plane XOR its partner, funnelshift_l(group g-q-1, group g-q, r)."""
    q, r = divmod(d, 32)
    g = np.arange(first, first + n)
    hi = planes[:, g - q]
    if r == 0:
        partner = hi
    else:
        assert (g - q - 1 >= 0).all(), "a partner before the staged span"
        partner = funnelshift_l(planes[:, g - q - 1], hi, r)
    if d < 64:  # from registers: the thread's unit and the two groups before it
        unit_first = first + ((g - first) // GROUPS) * GROUPS
        assert (g - q - (r != 0) >= unit_first - 2).all()
    return np.bitwise_or.reduce(planes[:, g] ^ partner, axis=0)


def tile_counts(row, p0, offsets, stale_bytes, stale_planes) -> np.ndarray:
    """What the tile at p0 adds to each offset's count: per thread unit of
    UNIT positions, 128 - popc(M) where the unit lies at or past d and
    before the end, else popc(~M & valid); above the halo, byte by byte."""
    seg = row.size
    end = min(p0 + TILE, seg)
    planes = tile_planes(row, p0, stale_bytes, stale_planes)
    units = -(-(end - p0) // UNIT)  # the threads whose unit starts before end
    assert units <= THREADS
    out = np.zeros(len(offsets), np.int64)
    for i, d in enumerate(offsets):
        if d > HALO:
            p = np.arange(max(p0, d), end)
            out[i] = int((row[p] == row[p - d]).sum())
            continue
        m = mismatch(planes, d, HALO // 32, GROUPS * units).reshape(units, GROUPS)
        pu = p0 + UNIT * np.arange(units)
        clean = (pu >= d) & (pu + UNIT <= end)
        pg = pu[:, None] + 32 * np.arange(GROUPS)
        valid = bits_below(end - pg) & ~bits_below(d - pg)
        out[i] = int((UNIT - popc(m[clean]).sum(axis=1)).sum()
                     + popc(~m[~clean] & valid[~clean]).sum())
    return out


def model_counts(rows: np.ndarray, offsets, seed: int = 0) -> np.ndarray:
    """(nseg, n) counts of the model; shared memory starts as random bytes
    and keeps what each tile left, as a block's does."""
    rng = np.random.default_rng(seed)
    stale_bytes = rng.integers(0, 256, HALO + TILE, dtype=np.uint8)
    stale_planes = rng.integers(0, 2**32, (8, (HALO + TILE) // 32), dtype=U64).astype(U32)
    counts = np.zeros((rows.shape[0], len(offsets)), np.int64)
    for r, row in enumerate(rows):
        for p0 in range(0, row.size, TILE):
            counts[r] += tile_counts(row, p0, offsets, stale_bytes, stale_planes)
    return counts


def direct_counts(rows: np.ndarray, offsets) -> np.ndarray:
    return np.stack([(rows[:, d:] == rows[:, :-d]).sum(axis=1) for d in offsets], axis=1)


def _rows(seg: int, kind: str) -> np.ndarray:
    rng = np.random.default_rng(seg * 7 + len(kind))
    distinct = (np.arange(seg) % 251).astype(np.uint8)
    if kind == "random":
        return np.concatenate([rng.integers(0, 256, (3, seg), dtype=np.uint8),
                               rng.integers(0, 3, (3, seg), dtype=np.uint8)])
    if kind == "periodic":  # a period at each of four offsets, 1% of bytes changed
        rows = []
        for period in (3, 48, 256, 1024):
            pattern = rng.integers(0, 256, period, dtype=np.uint8)
            row = np.tile(pattern, seg // period + 1)[:seg].copy()
            row[rng.random(seg) < 0.01] ^= 0x5A
            rows.append(row)
        return np.stack(rows)
    if kind == "constant":  # and the same with the last byte changed
        rows = np.full((2, seg), 7, np.uint8)
        rows[1, -1] = 9
        return rows
    if kind == "distinct":  # and with the last byte repeating one 1, 24 or 1024 before
        rows = [distinct]
        for d in (1, 24, 1024):
            if d < seg:
                rows.append(distinct.copy())
                rows[-1][-1] = rows[-1][-1 - d]
        return np.stack(rows)
    assert kind == "edge"
    return _count_rows(seg)


# ---------------------------------------------------------------------------
# the steps against their definitions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "ramp", "constant", "one bit", "small alphabet"])
def test_bit_planes_by_permutes_and_swaps_equal_the_planes(kind):
    """Two 4x4 byte transposes and three bit-block swaps give plane k bit l
    = bit k of byte l, for every byte of every group."""
    rng = np.random.default_rng(3)
    n = 32 * 64
    span = {
        "random": rng.integers(0, 256, n, dtype=np.uint8),
        "ramp": (np.arange(n) % 256).astype(np.uint8),
        "constant": np.full(n, 0xA5, np.uint8),
        "one bit": (1 << (np.arange(n) % 8)).astype(np.uint8) * (np.arange(n) % 5 == 0),
        "small alphabet": rng.integers(0, 3, n, dtype=np.uint8),
    }[kind].astype(np.uint8)
    assert np.array_equal(planes_of(span), direct_planes(span))


def test_bit_planes_of_single_bits():
    """Each of the 256 bits of a group, alone, lands on its own plane bit."""
    for byte in range(32):
        for bit in range(8):
            span = np.zeros(32, np.uint8)
            span[byte] = 1 << bit
            want = np.zeros((8, 1), U32)
            want[bit, 0] = 1 << byte
            assert np.array_equal(planes_of(span), want), (byte, bit)


def test_swizzle_keeps_each_unit_and_spreads_its_chunks_over_the_banks():
    """A unit's 8 chunks stay in its 128 bytes, and chunk m of 8
    neighbouring units lies in 8 different 16-byte bank quads."""
    c = np.arange((HALO + TILE) // 16)
    slots = swizzle(c)
    assert np.array_equal(np.sort(slots), c)
    assert np.array_equal(slots >> 3, c >> 3)
    for m in range(8):
        for u0 in range(0, c.size // 8, 8):
            quads = swizzle(8 * np.arange(u0, u0 + 8) + m) % 8
            assert np.unique(quads).size == 8


def test_staging_reads_back_the_row():
    """The staged span, read back as the units read it, holds the row's
    bytes at their positions, whatever shared memory held before."""
    rng = np.random.default_rng(5)
    row = rng.integers(0, 256, 3 * TILE + 1000, dtype=np.uint8)
    for p0 in (TILE, 2 * TILE, 3 * TILE):
        stale = rng.integers(0, 256, HALO + TILE, dtype=np.uint8)
        span = stage(row, p0, stale)
        end = min(p0 + TILE, row.size)
        assert np.array_equal(span[: end - p0 + HALO], row[p0 - HALO: end])


@pytest.mark.parametrize("d", [*tm.match_offsets(1 << 20), 5, 31, 33, 63, 65, 100, 999, 1023])
def test_partner_plane_is_the_planes_of_the_bytes_d_before(d):
    """funnelshift_l(plane of group g-q-1, plane of group g-q, r) is the
    plane of the bytes at p - d, across group edges, for every group whose
    partners lie in the staged span."""
    rng = np.random.default_rng(d)
    span = rng.integers(0, 4, HALO + TILE, dtype=np.uint8)
    planes = planes_of(span)
    first = -(-(d + 32) // 32)  # the first group whose partners are all staged
    n = span.size // 32 - first
    q, r = divmod(d, 32)
    g = np.arange(first, first + n)
    partner = planes[:, g - q] if r == 0 else funnelshift_l(planes[:, g - q - 1], planes[:, g - q], r)
    shifted = span[32 * first - d: 32 * (first + n) - d]
    assert np.array_equal(partner, direct_planes(shifted))
    want = (span[32 * first:] != shifted).reshape(-1, 32)
    got = mismatch(planes, d, first, n)
    assert np.array_equal((got[:, None] >> np.arange(32, dtype=U32)) & 1, want.astype(U32))


@pytest.mark.parametrize("seg", SEGS)
def test_valid_masks_keep_the_positions_a_count_takes(seg):
    """The masks of every unit of every tile, at every offset, select just
    the positions d <= p < min(end of tile, seg)."""
    for p0 in range(0, seg, TILE):
        end = min(p0 + TILE, seg)
        units = -(-(end - p0) // UNIT)
        pg = p0 + UNIT * np.arange(units)[:, None] + 32 * np.arange(GROUPS)
        pos = pg[..., None] + np.arange(32)
        for d in _offsets(seg):
            valid = bits_below(end - pg) & ~bits_below(d - pg)
            bits = (valid[..., None] >> np.arange(32, dtype=U32)) & 1
            assert np.array_equal(bits.astype(bool), (pos >= d) & (pos < end)), (p0, d)


@pytest.mark.parametrize("seg", SEGS)
def test_a_first_tile_never_reads_its_halo(seg):
    """Shared memory's old bytes and planes do not change any count."""
    rows = _rows(seg, "random")
    offs = _offsets(seg)
    assert np.array_equal(model_counts(rows, offs, seed=1), model_counts(rows, offs, seed=2))


# ---------------------------------------------------------------------------
# the model against direct counts and the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "periodic", "constant", "distinct", "edge"])
@pytest.mark.parametrize("seg", SEGS)
def test_model_counts_equal_direct_counts(seg, kind):
    """Per (row, offset): every candidate offset, 3000 (past the halo:
    byte by byte) and seg - 20; 1000 and 18440 are no multiples of 32,
    18440 ends in a short tile."""
    rows = _rows(seg, kind)
    offs = _offsets(seg)
    assert np.array_equal(model_counts(rows, offs), direct_counts(rows, offs))


@pytest.mark.parametrize("seg", SEGS)
def test_model_best_equals_xla_core(seg):
    """The model's first arg-max (0 where every count is 0) is
    _device_match_core's best, on all the row kinds above at once."""
    rows = np.concatenate([_rows(seg, k)
                           for k in ("random", "periodic", "constant", "distinct", "edge")])
    offs = _offsets(seg)
    best = np.asarray(jdev._device_match_core(jnp.asarray(rows), seg, offs)[1])
    assert np.array_equal(np.argmax(model_counts(rows, offs), axis=1), best)
