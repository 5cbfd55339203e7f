"""The plain reference: a Blosc frame read back in NumPy, as any decoder would.

It knows the format and nothing of the program: it imports no part of
tpu_blosc_torch and takes only the frame to judge.  The frame's header
must state what the configuration states (format version 2, the codec,
the filter and the type size) and its own sizes must add up; each block's
payload is decoded by the codec module the configuration names
(``decompress(payload, n) -> bytes``) and unfiltered here.

The format (16-byte little-endian header, then the payload):

    byte  0      version, 2
    byte  1      codec ID
    byte  2      flags: 0x1 byte shuffle, 0x2 stored raw, 0x4 bit shuffle,
                 0x8 multi-block frame with a block table
    byte  3      type size
    bytes 4-7    bytes of the original data
    bytes 8-11   block size
    bytes 12-15  bytes of the whole frame, header included

``make(config)`` is what the benchmark calls: it reads the codec
module and the codec ID from the configuration's ``reference``, and the
filter and the type size from its ``options``.

A frame without flag 0x8 holds one payload: the whole buffer, filtered
and compressed, or raw under flag 0x2.  With flag 0x8 a uint32 block
count follows, then a uint32 a block (bits 0-30 its payload's size, bit
31 set where the block is stored raw, unfiltered), then the payloads in
block order.  The last block may be short.

Byte shuffle of m bytes at type size ts: byte j of element i goes to
position j * (m // ts) + i; the bytes past the last whole element stay.
Bit shuffle: in each group of 8 whole elements, the 8 bytes at byte
position j (one from each element) are transposed as an 8x8 bit matrix,
most significant bit first, into the group's bytes 8j..8j+7; the bytes
past the last whole group stay.  At type size 1 neither filter moves a
byte.
"""

from __future__ import annotations

import importlib.util
import os
import struct

import numpy as np

HEADER = struct.Struct("<BBBBIII")
FLAG_SHUFFLE, FLAG_RAW, FLAG_BITSHUFFLE, FLAG_BLOCKS = 0x1, 0x2, 0x4, 0x8
MODE_FLAGS = {"SHUFFLE": FLAG_SHUFFLE, "BITSHUFFLE": FLAG_BITSHUFFLE, "NOSHUFFLE": 0}
ENTRY_RAW = 0x80000000


class FrameError(ValueError):
    """The frame is not one that the configuration's options describe."""


def unshuffle(filtered: np.ndarray, ts: int) -> np.ndarray:
    """Inverse of the byte shuffle of one block."""
    ne = filtered.size // ts
    out = filtered.copy()
    out[: ne * ts] = filtered[: ne * ts].reshape(ts, ne).T.reshape(-1)
    return out


def bitunshuffle(filtered: np.ndarray, ts: int) -> np.ndarray:
    """Inverse of the bit shuffle of one block."""
    ng = filtered.size // (8 * ts)
    out = filtered.copy()
    body = filtered[: ng * 8 * ts].reshape(ng, ts, 8)
    bits = np.unpackbits(body, axis=-1).reshape(ng, ts, 8, 8)
    planes = np.packbits(bits.transpose(0, 1, 3, 2), axis=-1).reshape(ng, ts, 8)
    out[: ng * 8 * ts] = planes.transpose(0, 2, 1).reshape(-1)
    return out


def _unfilter(filtered: np.ndarray, ts: int, flags: int) -> np.ndarray:
    if ts < 2:
        return filtered
    if flags & FLAG_BITSHUFFLE:
        return bitunshuffle(filtered, ts)
    if flags & FLAG_SHUFFLE:
        return unshuffle(filtered, ts)
    return filtered


def _payload(decompress, payload: bytes, n: int) -> np.ndarray:
    try:
        out = decompress(payload, n)
    except (ValueError, IndexError) as err:
        raise FrameError(f"a payload does not decode: {err}") from None
    if len(out) != n:
        raise FrameError(f"a payload decodes to {len(out)} bytes, not {n}")
    return np.frombuffer(out, np.uint8)


def decode(frame: bytes, codec_id: int, shuffle: str, type_size: int,
           decompress) -> np.ndarray:
    """The bytes that ``frame`` holds, as a uint8 array; FrameError when
    its header does not state ``codec_id``, ``shuffle`` ("SHUFFLE",
    "BITSHUFFLE" or "NOSHUFFLE") and ``type_size``, or its layout does not
    add up."""
    frame = bytes(frame)
    if len(frame) < HEADER.size:
        raise FrameError(f"{len(frame)} bytes, shorter than a header")
    version, codec, flags, ts, n, bs, total = HEADER.unpack_from(frame)
    stated = flags & (FLAG_SHUFFLE | FLAG_BITSHUFFLE)
    if version != 2 or codec != codec_id or ts != min(type_size, 255) or total != len(frame):
        raise FrameError(f"header (version {version}, codec {codec}, type size {ts}, "
                         f"{total} bytes) of a {len(frame)}-byte frame")
    if not flags & FLAG_BLOCKS:
        body = frame[HEADER.size:]
        if flags & FLAG_RAW:
            if len(body) != n:
                raise FrameError(f"a raw frame of {len(body)} bytes for {n}")
            return np.frombuffer(body, np.uint8).copy()
        if stated != MODE_FLAGS[shuffle]:
            raise FrameError(f"flags {flags:#x} for filter {shuffle}")
        return _unfilter(_payload(decompress, body, n), ts, flags)
    if stated != MODE_FLAGS[shuffle]:
        raise FrameError(f"flags {flags:#x} for filter {shuffle}")
    if bs == 0 or len(frame) < HEADER.size + 4:
        raise FrameError("no block table")
    (nb,) = struct.unpack_from("<I", frame, HEADER.size)
    if nb != -(-n // bs):
        raise FrameError(f"{nb} blocks of {bs} bytes for {n} bytes")
    pos = HEADER.size + 4 + 4 * nb
    if pos > len(frame):
        raise FrameError("a block table longer than the frame")
    entries = struct.unpack_from(f"<{nb}I", frame, HEADER.size + 4)
    out = np.empty(n, np.uint8)
    for i, entry in enumerate(entries):
        size, lo = entry & ~ENTRY_RAW, i * bs
        m = min(bs, n - lo)
        payload = frame[pos : pos + size]
        if len(payload) != size:
            raise FrameError(f"block {i}'s payload runs past the frame")
        pos += size
        if entry & ENTRY_RAW:
            if size != m:
                raise FrameError(f"raw block {i} of {size} bytes for {m}")
            out[lo : lo + m] = np.frombuffer(payload, np.uint8)
        else:
            out[lo : lo + m] = _unfilter(_payload(decompress, payload, m), ts, flags)
    if pos != len(frame):
        raise FrameError(f"{len(frame) - pos} bytes after the last payload")
    return out


def _codec(name: str):
    """The codec module ``<name>.py`` beside this file."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make(config: dict):
    """The reference of a configuration whose outputs are Blosc frames:
    frame -> the bytes it holds (``decode`` with the configuration's codec,
    codec ID, filter and type size)."""
    ref, opts = config["reference"], config["options"]
    decompress = _codec(ref["codec"]).decompress
    return lambda frame: decode(frame, ref["codec_id"], opts["shuffle"], opts["type_size"],
                                decompress)
