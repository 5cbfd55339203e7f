"""Pure-Python BloscLZ block codec — oracle for codec ID 0.

Counterpart: ``tpu_blosc/codecs/blosclz_ref.py``, the same code: the port's
route without a native build (``TPU_BLOSC_NO_NATIVE=1``) runs it, and
its blocks equal the JAX package's byte for byte.

The reference declares ``BloscLZ = 0`` but never implements it ("internal,
not implemented" — reference blosc.go:58; its codec map has no entry, so
compressing with it returns ErrInvalidCodec, codec.go:41-44).  This library
fills the slot with a from-scratch LZ77 codec in the FastLZ/BloscLZ family:
byte-oriented control tokens, short two-byte matches, overlap (RLE) support
and a long-distance escape.  Frames using codec 0 are therefore this
library's extension (like FLAG_SPLIT multi-block frames): the reference
decoder rejects them with ErrInvalidCodec rather than misreading them.

Format (one token = control byte + operands), decoded until the input is
exhausted; the output must then equal ``expected_size`` exactly:

    ctrl < 0x20      literal run: ctrl + 1 raw bytes follow (1..32)
    ctrl >= 0x20     match:
        mcode = ctrl >> 5                      (1..7)
        length = mcode + 2                     (3..8)     if mcode < 7
               = 9 + ext                                  if mcode == 7,
                 where ext = sum of extension bytes read until one != 0xFF
                 (each 0xFF adds 255; the terminating byte adds its value)
        raw = (ctrl & 0x1F) << 8 | next byte
        raw < 0x1FFF     distance = raw + 1               (1..8191)
        raw == 0x1FFF    distance = 8192 + next 3 bytes LE (8192..16785407)
        Overlap is legal (distance < length copies byte-at-a-time — RLE);
        distance must be >= 1 and <= bytes already produced.

Unlike LZ4 there are NO end-of-stream constraints: a match may be the last
token and literal runs are legal anywhere, so independently-encoded
segments concatenate into one valid stream — the property the native
parallel frame paths rely on (native/tpublosc.cpp blosclz_* kernels).

Level mapping: the level is ignored, like the reference treats LZ4
(codec.go:63-75) — BloscLZ is the speed-class codec of the family.

This module favors clarity; the C++ backend is the fast path and both
encoders are tested for cross-decodability (tests/test_blosclz.py).
"""

from __future__ import annotations

from ..errors import DecompressionFailedError

MIN_MATCH = 3  # near matches cost 2 bytes; 3 literals cost 4 -> always wins
MIN_FAR_MATCH = 6  # escape matches cost 5 bytes
MAX_NEAR_DIST = 8191
MAX_DIST = 8191 + (1 << 24)  # 16 785 407
_ESCAPE_RAW = 0x1FFF
_HASH_MULT = 2654435761
_HASH_LOG = 14


def compress_bound(n: int) -> int:
    """Worst case: pure literal runs of 32 bytes, 1 control byte each."""
    return n + n // 32 + 16


def _hash4(seq: int) -> int:
    return ((seq * _HASH_MULT) & 0xFFFFFFFF) >> (32 - _HASH_LOG)


def _emit_literals(out: bytearray, data, start: int, end: int) -> None:
    pos = start
    while pos < end:
        run = min(32, end - pos)
        out.append(run - 1)
        out += data[pos : pos + run]
        pos += run


def compress(data: bytes, level: int = 1) -> bytes:
    """Greedy single-probe hash match encoder (level ignored, see module doc)."""
    data = bytes(data)
    n = len(data)
    out = bytearray()
    if n == 0:
        return b""
    if n < 4:
        _emit_literals(out, data, 0, n)
        return bytes(out)

    head: dict[int, int] = {}
    anchor = 0
    i = 0
    limit = n - 4
    search_count = 0

    def emit_match(length: int, dist: int) -> None:
        if dist <= MAX_NEAR_DIST:
            raw = dist - 1
        else:
            raw = _ESCAPE_RAW
        if length <= 8:
            out.append(((length - 2) << 5) | (raw >> 8))
        else:
            out.append((7 << 5) | (raw >> 8))
            rem = length - 9
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out.append(raw & 0xFF)
        if raw == _ESCAPE_RAW:
            x = dist - 8192
            out.append(x & 0xFF)
            out.append((x >> 8) & 0xFF)
            out.append((x >> 16) & 0xFF)

    while i <= limit:
        seq = int.from_bytes(data[i : i + 4], "little")
        h = _hash4(seq)
        cand = head.get(h, -1)
        head[h] = i
        mlen = 0
        if cand >= 0 and i - cand <= MAX_DIST and data[cand : cand + 3] == data[i : i + 3]:
            mlen = 3
            while i + mlen < n and data[cand + mlen] == data[i + mlen]:
                mlen += 1
        dist = i - cand
        if mlen >= (MIN_MATCH if dist <= MAX_NEAR_DIST else MIN_FAR_MATCH):
            _emit_literals(out, data, anchor, i)
            emit_match(mlen, dist)
            i += mlen
            anchor = i
            search_count = 0
        else:
            search_count += 1
            i += 1 + (search_count >> 6)

    _emit_literals(out, data, anchor, n)
    return bytes(out)


def decompress(data: bytes, expected_size: int) -> bytes:
    """Decode a BloscLZ token stream; exact-size contract like lz4_ref."""
    src = bytes(data)
    n = len(src)
    out = bytearray()
    i = 0
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 0x20:
            run = ctrl + 1
            if i + run > n:
                raise DecompressionFailedError(
                    "blosclz: literal run overruns input"
                )
            out += src[i : i + run]
            i += run
        else:
            mcode = ctrl >> 5
            if mcode < 7:
                length = mcode + 2
            else:
                length = 9
                while True:
                    if i >= n:
                        raise DecompressionFailedError(
                            "blosclz: truncated match length"
                        )
                    b = src[i]
                    i += 1
                    length += b
                    if b != 0xFF:
                        break
            if i >= n:
                raise DecompressionFailedError("blosclz: truncated match")
            raw = ((ctrl & 0x1F) << 8) | src[i]
            i += 1
            if raw == _ESCAPE_RAW:
                if i + 3 > n:
                    raise DecompressionFailedError(
                        "blosclz: truncated far distance"
                    )
                dist = 8192 + (
                    src[i] | (src[i + 1] << 8) | (src[i + 2] << 16)
                )
                i += 3
            else:
                dist = raw + 1
            pos = len(out)
            if dist > pos:
                raise DecompressionFailedError(
                    "blosclz: match distance reaches before stream start"
                )
            if pos + length > expected_size:
                raise DecompressionFailedError(
                    "blosclz: output overruns expected size"
                )
            if dist >= length:
                out += out[pos - dist : pos - dist + length]
            else:
                for k in range(length):  # overlap: byte-at-a-time (RLE)
                    out.append(out[pos - dist + k])
        if len(out) > expected_size:
            raise DecompressionFailedError(
                "blosclz: output overruns expected size"
            )
    if len(out) != expected_size:
        raise DecompressionFailedError(
            f"blosclz: decompressed size mismatch: got {len(out)}, "
            f"expected {expected_size}"
        )
    return bytes(out)
