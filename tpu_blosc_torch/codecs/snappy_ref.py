"""Pure-Python Snappy codec — raw (non-framed) Snappy format, from scratch.

Counterpart: ``tpu_blosc/codecs/snappy_ref.py``, the same code: the port's
route without a native build (``TPU_BLOSC_NO_NATIVE=1``) runs it, and
its blocks equal the JAX package's byte for byte.

The reference wraps ``klauspost/compress/snappy``'s ``Encode``/``Decode``
(reference: codec.go:228-244), i.e. the raw Snappy block format:

  preamble : uvarint uncompressed length
  elements : tag byte, low 2 bits select the element type
     00 literal : length = (tag>>2)+1; lengths ≥ 61 use 1-4 extra LE bytes
                  (tag>>2 == 60+k ⇒ k extra bytes hold length-1)
     01 copy-1  : length = ((tag>>2)&0x7)+4 (4..11),
                  offset = ((tag>>5)<<8) | next byte (1..2047)
     10 copy-2  : length = (tag>>2)+1 (1..64), offset = 2-byte LE
     11 copy-4  : length = (tag>>2)+1, offset = 4-byte LE (we never emit)

Snappy has no compression levels (codec.go:232-235).
"""

from __future__ import annotations

from ..errors import DecompressionFailedError

_TAG_LITERAL = 0x00
_TAG_COPY1 = 0x01
_TAG_COPY2 = 0x02
_TAG_COPY4 = 0x03

_HASH_MULT = 0x1E35A7BD


def _uvarint_encode(x: int) -> bytes:
    out = bytearray()
    while x >= 0x80:
        out.append((x & 0x7F) | 0x80)
        x >>= 7
    out.append(x)
    return bytes(out)


def _uvarint_decode(data: bytes, pos: int) -> tuple[int, int]:
    x = 0
    shift = 0
    while True:
        if pos >= len(data) or shift > 63:
            raise DecompressionFailedError("snappy: bad uvarint preamble")
        b = data[pos]
        pos += 1
        x |= (b & 0x7F) << shift
        if b < 0x80:
            return x, pos
        shift += 7


def _emit_literal(out: bytearray, lit) -> None:
    n = len(lit) - 1
    if n < 60:
        out.append((n << 2) | _TAG_LITERAL)
    elif n < (1 << 8):
        out.append((60 << 2) | _TAG_LITERAL)
        out.append(n)
    elif n < (1 << 16):
        out.append((61 << 2) | _TAG_LITERAL)
        out += n.to_bytes(2, "little")
    elif n < (1 << 24):
        out.append((62 << 2) | _TAG_LITERAL)
        out += n.to_bytes(3, "little")
    else:
        out.append((63 << 2) | _TAG_LITERAL)
        out += n.to_bytes(4, "little")
    out += lit


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    # split long matches into ≤64-byte copy elements
    while length > 0:
        if length > 64:
            chunk = 60 if length < 68 else 64  # never leave a tail < 4
        else:
            chunk = length
        if chunk >= 4 and chunk <= 11 and offset < 2048:
            out.append(
                ((offset >> 8) << 5) | ((chunk - 4) << 2) | _TAG_COPY1
            )
            out.append(offset & 0xFF)
        else:
            out.append(((chunk - 1) << 2) | _TAG_COPY2)
            out += offset.to_bytes(2, "little")
        length -= chunk


def compress(data: bytes) -> bytes:
    """Raw-Snappy encode (≙ snappy.Encode)."""
    data = bytes(data)
    n = len(data)
    out = bytearray(_uvarint_encode(n))
    if n == 0:
        return bytes(out)
    if n < 16:
        _emit_literal(out, data)
        return bytes(out)

    table: dict[int, int] = {}
    anchor = 0
    i = 0
    limit = n - 4
    skip = 32  # snappy-style acceleration: step = skip>>5
    while i <= limit:
        seq = int.from_bytes(data[i : i + 4], "little")
        h = ((seq * _HASH_MULT) & 0xFFFFFFFF) >> 18
        cand = table.get(h, -1)
        table[h] = i
        if (
            cand >= 0
            and i - cand <= 0xFFFF
            and data[cand : cand + 4] == data[i : i + 4]
        ):
            mlen = 4
            while i + mlen < n and data[cand + mlen] == data[i + mlen]:
                mlen += 1
            if i > anchor:
                _emit_literal(out, data[anchor:i])
            _emit_copy(out, i - cand, mlen)
            i += mlen
            anchor = i
            skip = 32
        else:
            i += skip >> 5
            skip += 1
    if anchor < n:
        _emit_literal(out, data[anchor:])
    return bytes(out)


def decompress(data: bytes, expected_size: int | None = None) -> bytes:
    """Raw-Snappy decode (≙ snappy.Decode).

    ``expected_size`` is advisory (the frame header's NBytesOrig); the
    authoritative length is the stream preamble.  A disagreement surfaces as
    SizeMismatchError at the pipeline layer, matching the reference's final
    length check (blosc.go:429-431).
    """
    src = bytes(data)
    total, pos = _uvarint_decode(src, 0)
    dst = bytearray(total)
    di = 0
    n = len(src)
    while pos < n:
        tag = src[pos]
        pos += 1
        kind = tag & 0x03
        if kind == _TAG_LITERAL:
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                if pos + extra > n:
                    raise DecompressionFailedError("snappy: truncated literal length")
                ln = int.from_bytes(src[pos : pos + extra], "little")
                pos += extra
            ln += 1
            if pos + ln > n or di + ln > total:
                raise DecompressionFailedError("snappy: literal overrun")
            dst[di : di + ln] = src[pos : pos + ln]
            pos += ln
            di += ln
            continue
        if kind == _TAG_COPY1:
            if pos >= n:
                raise DecompressionFailedError("snappy: truncated copy-1")
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | src[pos]
            pos += 1
        elif kind == _TAG_COPY2:
            if pos + 2 > n:
                raise DecompressionFailedError("snappy: truncated copy-2")
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[pos : pos + 2], "little")
            pos += 2
        else:
            if pos + 4 > n:
                raise DecompressionFailedError("snappy: truncated copy-4")
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > di or di + length > total:
            raise DecompressionFailedError("snappy: invalid copy")
        if offset >= length:
            dst[di : di + length] = dst[di - offset : di - offset + length]
            di += length
        else:
            start = di - offset
            for k in range(length):
                dst[di + k] = dst[start + k]
            di += length
    if di != total:
        raise DecompressionFailedError(
            f"snappy: decoded {di} bytes, preamble says {total}"
        )
    return bytes(dst)
