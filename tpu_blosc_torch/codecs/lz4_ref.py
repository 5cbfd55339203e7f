"""Pure-Python LZ4 *block* format codec — the reference oracle.

Counterpart: ``tpu_blosc/codecs/lz4_ref.py``, the same code: the port's
route without a native build (``TPU_BLOSC_NO_NATIVE=1``) runs it, and
its blocks equal the JAX package's byte for byte.

Implements the LZ4 block format (https://lz4.org block spec) from scratch:
the reference wraps ``pierrec/lz4``'s ``CompressBlock`` / ``CompressBlockHC``
/ ``UncompressBlock`` (reference: codec.go:63-128) — raw block streams, no
frame.  Our encoder must produce *valid* LZ4 block streams whose size is
≤ the reference library's output at the same level; our decoder must decode
any valid LZ4 block stream exactly.

Format recap (one "sequence" = literals then a match):
  token byte   : high nibble = literal length (15 ⇒ +255-extension bytes),
                 low nibble  = match length - 4 (15 ⇒ +255-extension bytes)
  literals     : raw bytes
  match offset : 2-byte little-endian, 1..65535 (0 is invalid)
  end-of-block : the final sequence is literals only (no offset/matchlen);
                 compliant encoders keep the last 5 bytes as literals and
                 never start a match within the last 12 bytes.

This module favors clarity over speed; the C++ backend
(native/tpublosc.cpp) and the device path are the fast implementations and
are tested byte-for-byte against the *decoder* here, and for
roundtrip-validity against both encoders.
"""

from __future__ import annotations

from ..errors import DecompressionFailedError

MIN_MATCH = 4
MF_LIMIT = 12  # no match may start within the last 12 bytes
LAST_LITERALS = 5  # the last 5 bytes are always literals
MAX_OFFSET = 65535
_HASH_MULT = 2654435761
_HASH_LOG = 16


def compress_bound(n: int) -> int:
    """Worst-case compressed size for an n-byte input (LZ4_compressBound)."""
    return n + n // 255 + 16


def _hash4(seq: int) -> int:
    return ((seq * _HASH_MULT) & 0xFFFFFFFF) >> (32 - _HASH_LOG)


def _emit_sequence(out: bytearray, literals, offset: int, match_len: int) -> None:
    lit_len = len(literals)
    ml = match_len - MIN_MATCH
    token = (min(lit_len, 15) << 4) | min(ml, 15)
    out.append(token)
    if lit_len >= 15:
        rem = lit_len - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += literals
    out.append(offset & 0xFF)
    out.append((offset >> 8) & 0xFF)
    if ml >= 15:
        rem = ml - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)


def _emit_last_literals(out: bytearray, literals) -> None:
    lit_len = len(literals)
    out.append(min(lit_len, 15) << 4)
    if lit_len >= 15:
        rem = lit_len - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += literals


def compress_block(data: bytes, max_search_depth: int = 1) -> bytes:
    """Greedy LZ4 block encoder.

    ``max_search_depth`` 1 = fast/greedy (≙ lz4.CompressBlock, level
    ignored, codec.go:63-75); >1 = hash-chain search used for the HC levels
    (≙ lz4.CompressBlockHC, codec.go:94-118).

    Always returns a valid stream; callers decide whether it beat the input
    size (the memcpy fallback lives in the pipeline, reference
    blosc.go:341-345).
    """
    data = bytes(data)
    n = len(data)
    out = bytearray()
    if n == 0:
        return b""
    if n < MF_LIMIT + 1:
        _emit_last_literals(out, data)
        return bytes(out)

    # hash table: newest position for each 4-byte window hash; HC mode keeps
    # a chain of previous positions per hash.
    head = {}
    chain = {} if max_search_depth > 1 else None

    limit = n - MF_LIMIT
    match_limit = n - LAST_LITERALS
    anchor = 0
    i = 0
    # acceleration: skip faster through incompressible regions (same idea as
    # LZ4's searchMatchNb; affects speed/ratio, never validity)
    search_count = 0

    while i <= limit:
        seq = int.from_bytes(data[i : i + 4], "little")
        h = _hash4(seq)
        best_ref = -1
        best_len = 0

        cand = head.get(h, -1)
        depth = max_search_depth
        while cand >= 0 and depth > 0:
            if i - cand <= MAX_OFFSET and data[cand : cand + 4] == data[i : i + 4]:
                # extend forward
                mlen = MIN_MATCH
                while i + mlen < match_limit and data[cand + mlen] == data[i + mlen]:
                    mlen += 1
                if mlen > best_len:
                    best_len = mlen
                    best_ref = cand
                    if chain is None:
                        break
            if chain is None:
                break
            depth -= 1
            cand = chain.get(cand, -1)
            if cand >= 0 and i - cand > MAX_OFFSET:
                break

        if chain is not None:
            chain[i] = head.get(h, -1)
        head[h] = i

        if best_len >= MIN_MATCH:
            ref = best_ref
            # extend backward into pending literals
            while i > anchor and ref > 0 and data[i - 1] == data[ref - 1]:
                i -= 1
                ref -= 1
                best_len += 1
            _emit_sequence(out, data[anchor:i], i - ref, best_len)
            i += best_len
            anchor = i
            search_count = 0
        else:
            search_count += 1
            i += 1 + (search_count >> 6 if max_search_depth == 1 else 0)

    _emit_last_literals(out, data[anchor:])
    return bytes(out)


def decompress_block(data: bytes, expected_size: int) -> bytes:
    """LZ4 block decoder (≙ lz4.UncompressBlock).

    Decodes into a buffer of ``expected_size``; returns exactly the bytes
    written.  Raises DecompressionFailedError on any malformed stream
    (truncation, zero/out-of-range offset, output overflow).
    """
    src = bytes(data)
    n = len(src)
    dst = bytearray(expected_size)
    si = 0
    di = 0
    try:
        while si < n:
            token = src[si]
            si += 1
            lit = token >> 4
            if lit == 15:
                while True:
                    if si >= n:
                        raise DecompressionFailedError("lz4: truncated literal length")
                    b = src[si]
                    si += 1
                    lit += b
                    if b != 255:
                        break
            if si + lit > n:
                raise DecompressionFailedError("lz4: literal overruns input")
            if di + lit > expected_size:
                raise DecompressionFailedError("lz4: output overflow (literals)")
            dst[di : di + lit] = src[si : si + lit]
            si += lit
            di += lit
            if si >= n:
                break  # last sequence: literals only
            if si + 2 > n:
                raise DecompressionFailedError("lz4: truncated match offset")
            offset = src[si] | (src[si + 1] << 8)
            si += 2
            if offset == 0 or offset > di:
                raise DecompressionFailedError("lz4: invalid match offset")
            mlen = (token & 0xF) + MIN_MATCH
            if (token & 0xF) == 15:
                while True:
                    if si >= n:
                        raise DecompressionFailedError("lz4: truncated match length")
                    b = src[si]
                    si += 1
                    mlen += b
                    if b != 255:
                        break
            if di + mlen > expected_size:
                raise DecompressionFailedError("lz4: output overflow (match)")
            if offset >= mlen:
                dst[di : di + mlen] = dst[di - offset : di - offset + mlen]
                di += mlen
            else:
                # overlapping match: byte-by-byte semantics
                start = di - offset
                for k in range(mlen):
                    dst[di + k] = dst[start + k]
                di += mlen
    except IndexError as exc:  # defensive: any slip is a malformed stream
        raise DecompressionFailedError(f"lz4: malformed stream: {exc}") from exc
    return bytes(dst[:di])


def hc_depth_for_level(level: int) -> int:
    """Map Blosc levels 1-9 to HC search depth.

    The reference maps 1-3→Level1, 4-5→Level5, 6-7→Level7, 8-9→Level9
    (codec.go:96-106); we mirror the monotone effort curve with chain depth.
    """
    if level <= 3:
        return 2
    if level <= 5:
        return 16
    if level <= 7:
        return 64
    return 256
