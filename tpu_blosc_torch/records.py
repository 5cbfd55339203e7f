"""The records strategy of decompress_array: only literal records cross
to the device, which rebuilds the filtered stream and unfilters it.

Counterpart: ``_decompress_array_rle`` (``tpu_blosc/device.py:1713-1819``)
with its host helpers ``_lit_eq``, ``_host_lit_mask``,
``_host_lit_mask_packed``, ``_open_mask_bytes`` and ``_open_mask_bits``
(:1378-1452, NumPy, carried as they are) and the device program
``_device_match_decode`` (:1248-1375: its scatter and fill are
filters/fill.py over csrc/fill.cu, its unfilter filters.unfilter_blocks).

For filtered multi-block LZ4 frames: the host decodes the codec stage,
picks a match offset for each segment from a prefix of it, and builds the
literal mask the match strategy's encoder would; the literals' positions
and bytes go to the device, which fills every other byte from the one d
before it and unfilters the blocks.  The result equals the transfer
decode byte for byte.  Frames that do not qualify, frames of 2 GiB or
more and streams too dense to gain return None: the caller then decodes
on the host and copies once (the transfer route).

The JAX package pads the records to shape buckets with out-of-range
positions that its scatter drops, builds a one-hot select of the offsets
present and fills in row groups; the port needs none of it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import filters
from .chunk import native_pipeline_codec
from .filters import fill as _ffill
from .filters.match import MATCH_T, ROW_TAIL_LITERALS
from .format import Codec, Shuffle, parse_header
from .match import match_offsets
from .native import backend as _nb

# bytes of each row the offset choice looks at
SAMPLE_BYTES = 8192


def lit_eq(rows2d: np.ndarray, d_all: np.ndarray) -> np.ndarray:
    """Per-row equality at each row's own offset, grouped by offset and
    done with plain slices, with the forced-literal tail applied."""
    nseg, seg = rows2d.shape
    eq = np.zeros((nseg, seg), bool)
    for d in np.unique(d_all):
        sel = d_all == d
        sub = rows2d[sel]
        eq[sel, int(d):] = sub[:, int(d):] == sub[:, : seg - int(d)]
    eq[:, seg - ROW_TAIL_LITERALS:] = False
    return eq


def open_mask_bytes(eq: np.ndarray, T: int) -> np.ndarray:
    """The literal mask of ``eq``: its opening (erode by T, dilate by T)
    in the byte domain, inverted.  The oracle form."""
    nseg, seg = eq.shape
    er = eq[:, : seg - T + 1].copy()
    for s in range(1, T):
        er &= eq[:, s : seg - T + 1 + s]
    match = np.zeros_like(eq)
    for s in range(T):
        match[:, s : seg - T + 1 + s] |= er
    return ~match


def open_mask_bits(eq: np.ndarray, T: int, packed: bool = False) -> np.ndarray:
    """The same mask in the bit domain: rows packed to little-endian
    64-bit words, shift-and and shift-or ladders with carries between a
    row's words (never between rows); seg % 64 == 0 and T <= 63.
    ``packed`` returns the (nseg, seg/8) bytes, bit i of byte j = byte
    8j+i is literal."""
    nseg, seg = eq.shape
    w = np.packbits(eq, axis=1, bitorder="little").view(np.uint64)
    nxt = np.zeros_like(w)
    nxt[:, :-1] = w[:, 1:]
    er = w.copy()
    for s in range(1, T):
        er &= (w >> np.uint64(s)) | (nxt << np.uint64(64 - s))
    prv = np.zeros_like(er)
    prv[:, 1:] = er[:, :-1]
    match = er.copy()
    for s in range(1, T):
        match |= (er << np.uint64(s)) | (prv >> np.uint64(64 - s))
    lit_packed = (~match).view(np.uint8).reshape(nseg, seg // 8)
    if packed:
        return lit_packed
    return np.unpackbits(lit_packed, axis=1, bitorder="little").view(bool)


def host_lit_mask(rows2d: np.ndarray, d_all: np.ndarray, T: int) -> np.ndarray:
    """The match encoder's literal mask on the host: per-row offsets, the
    same opening and forced literals, as a bool array."""
    eq = lit_eq(rows2d, d_all)
    if rows2d.shape[1] % 64 == 0 and T <= 63:
        return open_mask_bits(eq, T)
    return open_mask_bytes(eq, T)


def host_lit_mask_packed(rows2d: np.ndarray, d_all: np.ndarray, T: int) -> np.ndarray | None:
    """The same mask packed ((nseg, seg/8) uint8, little-endian bits), so
    the native scanner can list its positions; None when the row geometry
    does not fit the bit-domain opening."""
    if rows2d.shape[1] % 64 or T > 63:
        return None
    return open_mask_bits(lit_eq(rows2d, d_all), T, packed=True)


def choose_offsets(rows2d: np.ndarray, offsets: tuple[int, ...]) -> np.ndarray:
    """Each row's offset (int32): the candidate with the most equal bytes
    in the row's first SAMPLE_BYTES bytes, the first of those on a tie."""
    samp = rows2d[:, : min(rows2d.shape[1], SAMPLE_BYTES)]
    counts = np.stack([(samp[:, d:] == samp[:, :-d]).sum(axis=1) for d in offsets], axis=1)
    return np.asarray(offsets, np.int32)[counts.argmax(axis=1)]


def decompress_array_records(data, n: int, device: torch.device):
    """The "rle"/"records" strategy's body: the frame's ``n`` bytes as a
    uint8 tensor on ``device``, or None for the transfer route."""
    from .device import _decode_filtered_blocks  # device.py imports this module

    raw = bytes(data)
    if len(raw) < 4 or raw[:4] == b"TPB2":
        return None
    header = parse_header(raw)
    bs, ts = header.block_size, header.type_size
    quantum = 8 * ts if header.shuffle_mode == Shuffle.BITSHUFFLE else ts
    if (
        not header.is_split
        or header.shuffle_mode == Shuffle.NOSHUFFLE
        or ts <= 1
        or header.codec not in (Codec.LZ4, Codec.LZ4HC)
        or n % bs  # a ragged tail: the host path keeps it simple
        or bs % quantum
    ):
        return None
    native = native_pipeline_codec(header.codec, 1)
    if native is None:
        return None
    # blocks stored raw hold the tensor's bytes, not filtered ones
    decoded = _decode_filtered_blocks(raw, header, n, native[0], forbid_memcpy=True)
    if decoded is None:
        return None
    stream = decoded[0].numpy()
    seg = bs // ts
    # literal positions are int32 flat indices
    if seg < 256 or n % seg or n >= 2**31:
        return None
    offsets = match_offsets(seg)
    nseg = n // seg
    rows2d = stream.reshape(nseg, seg)
    d_all = choose_offsets(rows2d, offsets)
    packed = host_lit_mask_packed(rows2d, d_all, MATCH_T)
    if packed is not None:
        n_lit = int(np.bitwise_count(packed).sum(dtype=np.int64))
    else:
        lit = host_lit_mask(rows2d, d_all, MATCH_T)
        n_lit = int(lit.sum())
    if n_lit > max(n // 8, 4096):
        return None  # dense: the records would ship more than the bytes
    if packed is not None:
        pos = _nb.mask_positions(packed.reshape(-1), n_lit)
        if pos is None or pos.size != n_lit:
            return None  # the mask and its scan disagree: the host path decides
    else:
        pos = np.flatnonzero(lit).astype(np.int32)
    filled = _ffill.match_fill(pos, stream[pos], d_all, nseg, seg, device)
    return filters.unfilter_blocks(filled.view(-1, bs), ts, header.shuffle_mode).view(-1)
