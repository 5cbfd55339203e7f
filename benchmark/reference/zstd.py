"""Zstandard frames decoded by the system's libzstd: the reference's codec for ZSTD.

libzstd is the format's reference implementation (RFC 8878).  It is loaded
by its soname through ctypes, not through anything of the program, which
links the same library to compress.  A decoder in plain Python would run
the format's entropy stages symbol by symbol, tens of millions of steps
for one 64 MB frame; the Blosc layers around each payload (header, block
table, raw blocks, the filter, the tail) are read in NumPy alone
(``blosc_frame.py``).
"""

from __future__ import annotations

import ctypes

_lib = None


def _zstd() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL("libzstd.so.1")
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_char_p, ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        _lib = lib
    return _lib


def decompress(src: bytes, n: int) -> bytes:
    """The ``n`` bytes a Zstandard frame decodes to; ValueError when it
    does not decode or decodes to another size."""
    lib = _zstd()
    out = ctypes.create_string_buffer(max(n, 1))
    got = lib.ZSTD_decompress(out, n, src, len(src))
    if lib.ZSTD_isError(got) or got != n:
        raise ValueError(f"a zstd frame decodes to {'an error' if lib.ZSTD_isError(got) else got}"
                         f" for {n} bytes")
    return out.raw[:n]
