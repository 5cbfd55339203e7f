"""LZ4 block decoding in plain Python: the reference's codec for LZ4 and LZ4HC.

The block format: sequences of a token (high nibble: literal length,
low nibble: match length less 4; 15 means that bytes of 255 and a last
byte below 255 follow and add up), the literals, a 2-byte little-endian
offset back into the output (1 or more), then the match, which may
overlap the bytes it copies.  The last sequence ends with its literals.
"""

from __future__ import annotations


def _length(src: bytes, i: int, n: int) -> tuple[int, int]:
    if n == 15:
        while True:
            b = src[i]
            i += 1
            n += b
            if b != 255:
                break
    return n, i


def decompress(src: bytes, n: int) -> bytes:
    """The ``n`` bytes an LZ4 block decodes to; ValueError when it is
    malformed or decodes to another size."""
    out = bytearray()
    i, end = 0, len(src)
    try:
        while True:
            token = src[i]
            lit, i = _length(src, i + 1, token >> 4)
            if i + lit > end:
                raise ValueError("literals run past the block")
            out += src[i : i + lit]
            i += lit
            if i == end:
                break
            off = src[i] | src[i + 1] << 8
            ml, i = _length(src, i + 2, token & 15)
            ml += 4
            if off == 0 or off > len(out):
                raise ValueError(f"offset {off} at output {len(out)}")
            if len(out) + ml > n:
                raise ValueError("a match runs past the block's size")
            start = len(out) - off
            if ml <= off:
                out += out[start : start + ml]
            else:
                out += (out[start:] * (ml // off + 1))[:ml]
    except IndexError:
        raise ValueError("the block ends inside a sequence") from None
    if len(out) != n:
        raise ValueError(f"{len(out)} bytes decoded for {n}")
    return bytes(out)
