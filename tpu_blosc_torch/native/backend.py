"""ctypes binding of the native C++ host codec, and its fastcall module.

Counterpart: ``tpu_blosc/native/backend.py``.  The library is compiled
from the port's own copy of the JAX package's source, ``tpublosc.cpp``
beside this file (byte-identical to ``tpu_blosc/native/tpublosc.cpp``, a
test holds the two together), so both packages run one codec and write
the same bytes.  It is built with g++ at first use into
``tpu_blosc_torch/_build/`` with the flag ladder of
``tpu_blosc/native/backend.py:65-81``.  ``include/zstd.h`` declares the
zstd functions the source calls, and the library links the runtime
``libzstd.so.1``, so a host without zstd's development files builds it
too.  A failed build raises: there is no silent fallback.

``fastmod.c`` (a copy of ``tpu_blosc/native/fastmod.c``) is built beside
the library and loaded as ``tpu_blosc_torch.native._tpbfast``: METH_FASTCALL
entry points to the single-block frame calls and the batch calls, which
skip the ctypes marshalling (≙ tpu_blosc/native/backend.py:182-222).
``fastcall_status()`` says whether it serves.  Where Python's headers are
missing the ctypes route serves and nothing is built.

Environment (read at import):

- ``TPU_BLOSC_NO_NATIVE``: the route without a native build.  Nothing is
  built or loaded, ``available()`` is False, and the codecs run their
  pure-Python versions (``codecs/*_ref.py``); ``lib()`` raises.
- ``TPU_BLOSC_NO_FAST``: the ctypes route, without the fastcall module.

Every pointer crosses as ``ctypes.c_void_p`` (a plain int would be cut
to 32 bits).
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import struct
import sysconfig
import threading

import numpy as np

from .. import buildlib
from ..errors import DecompressionFailedError, SizeMismatchError

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "tpublosc.cpp")
FAST_SOURCE = os.path.join(_HERE, "fastmod.c")
_INCLUDE = os.path.join(_HERE, "include")
NO_NATIVE = bool(os.environ.get("TPU_BLOSC_NO_NATIVE"))
NO_FAST = bool(os.environ.get("TPU_BLOSC_NO_FAST"))
LIB_PATH = os.path.join(buildlib.BUILD_DIR, "libtpublosc.so")
FAST_PATH = os.path.join(buildlib.BUILD_DIR, "_tpbfast.so")

_BASE = ["-O3", "-funroll-loops", "-shared", "-fPIC", "-std=c++17"]
_LADDER = (["-march=native", "-fopenmp"], ["-fopenmp"], ["-march=native"], [])

# codec IDs of the native pipeline (not the frame's codec byte; chunk.py maps)
NATIVE_BLOSCLZ = 0
NATIVE_LZ4 = 1
NATIVE_LZ4HC = 2
NATIVE_SNAPPY = 3
NATIVE_ZLIB = 4
NATIVE_ZSTD = 5

_i64 = ctypes.c_int64
_int = ctypes.c_int
_p = ctypes.c_void_p

_SIGNATURES = {
    "tpb_compress_bound": (_i64, [_i64, _int]),
    "tpb_compress_blocks": (_i64, [
        _p, _i64, _i64,          # src, n, block_size
        _int, _int, _int, _int,  # ts, shuffle_mode, codec, depth
        _p, _i64,                # out, slot_stride
        _p, _p,                  # out_sizes, out_memcpy
        _int,                    # num_threads (0 = all cores)
    ]),
    "tpb_gather": (_i64, [_p, _p, _i64, _i64, _p]),
    "tpb_compress_frame": (_i64, [
        _p, _i64,                # src, n
        _int, _int,              # ts, shuffle_mode
        _int, _int, _int,        # header_codec, codec, depth
        _p,                      # dst (16 + bound)
    ]),
    "tpb_decompress_blocks": (_i64, [
        _p, _p, _p, _p,          # payloads, offsets, psizes, is_memcpy
        _i64, _i64, _i64,        # nb, block_size, total_n
        _int, _int, _int,        # ts, shuffle_mode, codec
        _p,                      # out
        _int,                    # num_threads
    ]),
    "tpb_decompress_block_into": (_i64, [
        _p, _i64, _i64,          # frame, payload_off, psize
        _p, _i64,                # out, n
        _int, _int, _int,        # ts, shuffle_mode, codec
    ]),
    "tpb_lz4_compress": (_i64, [_p, _i64, _p, _i64, _int]),
    "tpb_lz4_decompress": (_i64, [_p, _i64, _p, _i64]),
    "tpb_blosclz_compress": (_i64, [_p, _i64, _p, _i64]),
    "tpb_blosclz_decompress": (_i64, [_p, _i64, _p, _i64]),
    "tpb_snappy_compress": (_i64, [_p, _i64, _p, _i64]),
    "tpb_snappy_decompress": (_i64, [_p, _i64, _p, _i64]),
    "tpb_lz4_emit_runs": (_i64, [_p, _p, _i64, _i64, _p, _i64]),
    "tpb_lz4_emit_mixed": (_i64, [
        _p, _p, _i64,            # lit_pos, lit_bytes, nlit
        _p, _i64, _i64,          # row_d, seg, n
        _p, _i64,                # dst, cap
    ]),
    "tpb_mask_positions": (_i64, [_p, _i64, _p, _i64]),
    "tpb_shuffle": (None, [_p, _p, _i64, _int]),
    "tpb_unshuffle": (None, [_p, _p, _i64, _int]),
    "tpb_bitshuffle": (None, [_p, _p, _i64, _int]),
    "tpb_bitunshuffle": (None, [_p, _p, _i64, _int]),
    "tpb_compress_batch": (None, [
        _p, _p, _i64,            # srcs, ns, nf
        _int, _int,              # ts, shuffle_mode
        _int, _int, _int,        # header_codec, codec, depth
        _p, _p, _p,              # dsts, results, idx scratch
    ]),
    "tpb_decompress_batch": (None, [
        _p, _p, _p,              # frames, psizes, ns
        _p, _p, _p,              # tss, modes, codecs (int32 each)
        _i64,                    # nf
        _p, _p, _p,              # outs, results, idx scratch
    ]),
}

_lib = None
_fast = None  # the fastcall module, once lib() loaded it (None: ctypes route)
_fast_status = "fastcall: not loaded yet"
_load_lock = threading.Lock()
# seconds the first load of this process spent compiling (0.0: up to date)
build_seconds: float | None = None
fast_build_seconds: float | None = None


def available() -> bool:
    """False on the route without a native build (TPU_BLOSC_NO_NATIVE)."""
    return not NO_NATIVE


def _commands() -> list[list[str]]:
    return [
        ["g++", *_BASE, *flags, "-I", _INCLUDE, SOURCE, "-o", buildlib.OUT,
         "-lz", "-l:libzstd.so.1"]
        for flags in _LADDER
    ]


def lib() -> ctypes.CDLL:
    """The loaded library, built first if the source changed, with the
    fastcall module loaded beside it."""
    global _lib, _fast, build_seconds
    if _lib is None:
        with _load_lock:
            if _lib is None:
                if NO_NATIVE:
                    raise RuntimeError(
                        "the native host codec is off (TPU_BLOSC_NO_NATIVE is set)")
                build_seconds = buildlib.ensure_built(
                    LIB_PATH, [SOURCE, os.path.join(_INCLUDE, "zstd.h")],
                    _commands(),
                )
                handle = ctypes.CDLL(LIB_PATH)
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _fast = _load_fast()
                _lib = handle
    return _lib


def _load_fast():
    """Build (at first use) and import the fastcall module, or None where
    it is switched off or Python's headers are missing.  A failed build
    or import raises."""
    global _fast_status, fast_build_seconds
    if NO_FAST:
        _fast_status = "fastcall: off (TPU_BLOSC_NO_FAST)"
        return None
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        _fast_status = "fastcall: unavailable (no Python.h)"
        return None
    fast_build_seconds = buildlib.ensure_built(FAST_PATH, [FAST_SOURCE, LIB_PATH], [[
        "gcc", "-O2", "-shared", "-fPIC", "-I", include, FAST_SOURCE,
        "-o", buildlib.OUT, "-L", buildlib.BUILD_DIR, "-ltpublosc",
        "-Wl,-rpath,$ORIGIN",
    ]])
    spec = importlib.util.spec_from_file_location(
        "tpu_blosc_torch.native._tpbfast", FAST_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _fast_status = "fastcall: loaded"
    return mod


def fastmod():
    """The fastcall module, or None where the ctypes route serves."""
    if _lib is None:
        lib()
    return _fast


def fastcall_status() -> str:
    """Which binding serves the frame calls: "fastcall: loaded", "fastcall:
    off (TPU_BLOSC_NO_FAST)", or "fastcall: unavailable
    (no Python.h)"; "fastcall: off (no native build)" on the route without
    one."""
    if NO_NATIVE:
        return "fastcall: off (no native build)"
    fastmod()
    return _fast_status


# Uninitialised bytes via the CPython C API: the codec writes straight into
# the result object's buffer, which is exclusively owned until returned.
_pybytes_new = ctypes.pythonapi.PyBytes_FromStringAndSize
_pybytes_new.restype = ctypes.py_object
_pybytes_new.argtypes = [ctypes.c_char_p, ctypes.c_ssize_t]
_pybytes_addr = ctypes.pythonapi.PyBytes_AsString
_pybytes_addr.restype = _p
_pybytes_addr.argtypes = [ctypes.py_object]


def alloc_bytes(n: int) -> tuple[bytes, int]:
    """Return (uninitialised bytes object of length n, writable address)."""
    b = _pybytes_new(None, n)
    return b, _pybytes_addr(b)


def as_u8(data) -> np.ndarray:
    """Flat contiguous uint8 view of a bytes-like object or ndarray."""
    if isinstance(data, np.ndarray):
        a = data.reshape(-1).view(np.uint8)
        return a if a.flags.c_contiguous else np.ascontiguousarray(a)
    return np.frombuffer(data, dtype=np.uint8)


def _addr(a: np.ndarray) -> int:
    return a.ctypes.data


def _shuffle_call(name: str, data, type_size: int) -> np.ndarray:
    a = as_u8(data)
    out = np.empty(a.size, dtype=np.uint8)
    getattr(lib(), name)(_addr(a), _addr(out), a.size, type_size)
    return out


def shuffle(data, type_size: int) -> np.ndarray:
    """Whole-buffer byte shuffle; bytes past the last element stay put."""
    return _shuffle_call("tpb_shuffle", data, type_size)


def unshuffle(data, type_size: int) -> np.ndarray:
    return _shuffle_call("tpb_unshuffle", data, type_size)


def bitshuffle(data, type_size: int) -> np.ndarray:
    """Whole-buffer bit shuffle in local groups of 8 elements; the bytes
    past the last whole group are copied verbatim."""
    return _shuffle_call("tpb_bitshuffle", data, type_size)


def bitunshuffle(data, type_size: int) -> np.ndarray:
    return _shuffle_call("tpb_bitunshuffle", data, type_size)


def lz4_compress(data, depth: int = 1) -> bytes:
    """One LZ4 block; ``depth`` > 1 is the LZ4HC chain depth
    (≙ tpu_blosc/native/backend.py:281-290)."""
    a = as_u8(data)
    cap = a.size + a.size // 255 + 16
    out = np.empty(cap, dtype=np.uint8)
    written = lib().tpb_lz4_compress(_addr(a), a.size, _addr(out), cap, depth)
    if written < 0:
        raise RuntimeError(f"native lz4 compress failed ({written})")
    return out[:written].tobytes()


def _encode(name: str, what: str, data, cap_of) -> bytes:
    """One block through the export ``name``, into ``cap_of(n)`` bytes."""
    a = as_u8(data)
    cap = cap_of(a.size)
    out = np.empty(cap, dtype=np.uint8)
    written = getattr(lib(), name)(_addr(a), a.size, _addr(out), cap)
    if written < 0:
        raise RuntimeError(f"native {what} compress failed ({written})")
    return out[:written].tobytes()


def _decode(name: str, what: str, data, expected_size: int) -> bytes:
    """One block through the export ``name``, at most ``expected_size``
    bytes out; a malformed stream raises DecompressionFailedError."""
    a = as_u8(data)
    out, addr = alloc_bytes(expected_size)
    written = getattr(lib(), name)(_addr(a), a.size, addr, expected_size)
    if written < 0:
        raise DecompressionFailedError(f"{what}: malformed stream (code {written})")
    return out if written == expected_size else out[:written]


def lz4_decompress(data, expected_size: int) -> bytes:
    """One LZ4 block (≙ tpu_blosc/native/backend.py:293-302)."""
    return _decode("tpb_lz4_decompress", "lz4", data, expected_size)


def blosclz_compress(data) -> bytes:
    """One BloscLZ block (≙ tpu_blosc/native/backend.py:305-314)."""
    return _encode("tpb_blosclz_compress", "blosclz", data, lambda n: n + n // 32 + 16)


def blosclz_decompress(data, expected_size: int) -> bytes:
    return _decode("tpb_blosclz_decompress", "blosclz", data, expected_size)


def snappy_compress(data) -> bytes:
    """One raw Snappy block (≙ tpu_blosc/native/backend.py:331-340)."""
    return _encode("tpb_snappy_compress", "snappy", data, lambda n: 32 + n + n // 6)


def snappy_decompress(data, expected_size: int) -> bytes:
    return _decode("tpb_snappy_decompress", "snappy", data, expected_size)


def lz4_emit_runs(vals: np.ndarray, lens: np.ndarray, n: int) -> bytes:
    """A standard LZ4 block of ``n`` bytes from (value, length) run
    records, in time proportional to the runs
    (≙ tpu_blosc/native/backend.py:357-372)."""
    vals = np.ascontiguousarray(vals, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    cap = n + n // 255 + 16
    out = np.empty(cap, dtype=np.uint8)
    written = lib().tpb_lz4_emit_runs(_addr(vals), _addr(lens), vals.size, n,
                                      _addr(out), cap)
    if written < 0:
        raise RuntimeError(f"lz4_emit_runs failed ({written})")
    return out[:written].tobytes()


def lz4_emit_mixed(lit_pos: np.ndarray, lit_bytes: np.ndarray,
                   row_d: np.ndarray, seg: int, n: int,
                   cap: int | None = None) -> bytes | None:
    """A standard LZ4 block from fixed-offset match records
    (≙ tpu_blosc/native/backend.py:375-406).

    ``lit_pos``/``lit_bytes`` are the block's literal positions (sorted)
    and values; every other byte of row r (``seg`` bytes each) is a match
    at offset ``row_d[r]``.  None when the stream would exceed ``cap``.
    """
    lit_pos = np.ascontiguousarray(lit_pos, dtype=np.int64)
    lit_bytes = np.ascontiguousarray(lit_bytes, dtype=np.uint8)
    row_d = np.ascontiguousarray(row_d, dtype=np.int32)
    if cap is None:
        cap = n + n // 255 + 16
    out = np.empty(cap, dtype=np.uint8)
    written = lib().tpb_lz4_emit_mixed(
        _addr(lit_pos), _addr(lit_bytes), lit_pos.size,
        _addr(row_d), seg, n, _addr(out), cap,
    )
    if written == -1:
        return None
    if written < 0:
        raise RuntimeError(f"lz4_emit_mixed failed ({written})")
    return out[:written].tobytes()


def mask_positions(mask: np.ndarray, nset: int) -> np.ndarray | None:
    """Set-bit positions (sorted, int32) of a little-endian packed mask,
    or None when it holds more than ``nset`` set bits
    (≙ tpu_blosc/native/backend.py:409-425)."""
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    out = np.empty(nset, dtype=np.int32)
    k = lib().tpb_mask_positions(_addr(mask), mask.size, _addr(out), nset)
    if k < 0:
        return None
    return out[:k]


def compress_slots(data, block_size: int, type_size: int, shuffle_mode: int,
                   native_codec: int, depth: int, num_threads: int = 0):
    """Filter and compress every block in one parallel native call
    (≙ tpu_blosc/native/backend.py:471-505).

    Returns (slots, slot_stride, sizes, memcpy_flags): block i's payload
    is ``slots[i*slot_stride : i*slot_stride + sizes[i]]``; a memcpy block
    holds the block's input bytes.  Bit 3 of ``shuffle_mode`` says the
    data arrives already filtered (the device route), which keeps zlib's
    output byte-identical to the host route's.
    """
    a = as_u8(data)
    nb = -(-a.size // block_size)
    slot = int(lib().tpb_compress_bound(block_size, native_codec))
    out = np.empty(nb * slot, dtype=np.uint8)
    sizes = np.empty(nb, dtype=np.int64)
    memcpy_flags = np.empty(nb, dtype=np.uint8)
    rc = lib().tpb_compress_blocks(
        _addr(a), a.size, block_size,
        type_size, shuffle_mode, native_codec, depth,
        _addr(out), slot, _addr(sizes), _addr(memcpy_flags),
        num_threads,
    )
    if rc != 0:
        raise RuntimeError(f"native compress_blocks failed ({rc})")
    return out, slot, sizes, memcpy_flags


def gather_frame(prefix: bytes, slots: np.ndarray, slot: int,
                 sizes: np.ndarray) -> bytes:
    """``prefix`` (header and block table) followed by every payload, in
    one allocation and one native copy of the payloads."""
    frame, addr = alloc_bytes(len(prefix) + int(sizes.sum()))
    ctypes.memmove(addr, prefix, len(prefix))
    rc = lib().tpb_gather(_addr(slots), _addr(sizes), sizes.size, slot,
                          addr + len(prefix))
    if rc != 0:
        raise MemoryError("native frame gather failed: offsets allocation")
    return frame


def decompress_blocks(payloads: np.ndarray, offsets: np.ndarray,
                      psizes: np.ndarray, is_memcpy: np.ndarray,
                      block_size: int, total_n: int, type_size: int,
                      shuffle_mode: int, native_codec: int,
                      out_addr: int | None = None, num_threads: int = 0):
    """Decompress and unfilter every block in one parallel native call.

    Returns the decoded bytes, or with ``out_addr`` writes there and
    returns the byte count (≙ tpu_blosc/native/backend.py:550-588).
    """
    if out_addr is None:
        out, addr = alloc_bytes(total_n)
    else:
        out, addr = None, out_addr
    got = lib().tpb_decompress_blocks(
        _addr(payloads), _addr(offsets), _addr(psizes), _addr(is_memcpy),
        offsets.size, block_size, total_n,
        type_size, shuffle_mode, native_codec,
        addr, num_threads,
    )
    if got != total_n:
        raise DecompressionFailedError(
            f"native decompress_blocks failed (code {got})"
        )
    return out if out_addr is None else total_n


def _universal_bound(n: int) -> int:
    # a superset of every native codec's bound (lz4 n/255, snappy n/6,
    # zlib n/4096, zstd n/128, all plus small constants)
    return 16 + n + (n >> 2) + 1024


def compress_frame(data, type_size: int, shuffle_mode: int, header_codec: int,
                   native_codec: int, depth: int) -> bytes:
    """One C call making a whole single-block frame, header included
    (≙ tpu_blosc/native/backend.py:612-644); through the fastcall module
    where it serves."""
    fast = fastmod()
    if fast is not None:
        return fast.compress_frame(data, type_size, shuffle_mode, header_codec,
                                   native_codec, depth)
    a = as_u8(data)
    dst = np.empty(_universal_bound(a.size), dtype=np.uint8)
    total = lib().tpb_compress_frame(
        _addr(a), a.size, type_size, shuffle_mode, header_codec,
        native_codec, depth, _addr(dst),
    )
    if total < 0:
        raise RuntimeError(f"native compress_frame failed ({total})")
    return dst[:total].tobytes()


def compress_frames(items, type_size: int, shuffle_mode: int,
                    header_codec: int, native_codec: int, depth: int) -> list[bytes]:
    """compress_frame of every item in one native call, which schedules
    small frames across the core pool; the frames are those per-item
    compress_frame writes (≙ tpu_blosc/native/backend.py:647-671, whose
    fastcall module calls the same tpb_compress_batch).  Items must be
    non-empty."""
    fast = fastmod()
    if fast is not None:
        return fast.compress_batch(items, type_size, shuffle_mode, header_codec,
                                   native_codec, depth)
    srcs = [as_u8(d) for d in items]  # referenced until the call returns
    nf = len(srcs)
    if nf == 0:
        return []
    dsts = [np.empty(_universal_bound(a.size), dtype=np.uint8) for a in srcs]
    src_ptrs = np.array([_addr(a) for a in srcs], dtype=np.uintp)
    dst_ptrs = np.array([_addr(d) for d in dsts], dtype=np.uintp)
    ns = np.array([a.size for a in srcs], dtype=np.int64)
    results = np.empty(nf, dtype=np.int64)
    scratch = np.empty(nf, dtype=np.int64)
    lib().tpb_compress_batch(
        _addr(src_ptrs), _addr(ns), nf, type_size, shuffle_mode,
        header_codec, native_codec, depth,
        _addr(dst_ptrs), _addr(results), _addr(scratch),
    )
    failed = np.flatnonzero(results < 0)
    if failed.size:
        i = int(failed[0])
        raise RuntimeError(
            f"native compress_frame failed ({int(results[i])}) at batch index {i}"
        )
    return [d[:r].tobytes() for d, r in zip(dsts, results)]


def _batch_frame(raw: bytes, native_map: bytes, ts_override: int):
    """(payload size, n, ts, shuffle mode, native codec) of a plain
    single-block frame the native batch decoder takes, else None (≙
    parse_batch_frame, tpu_blosc/native/fastmod.c:255-272)."""
    if len(raw) <= 16 or raw[0] != 2:
        return None
    codec_id, flags, ts_hdr = raw[1], raw[2], raw[3]
    if flags & 0xA or codec_id >= 6 or native_map[codec_id] == 0xFF:
        return None  # FLAG_SPLIT | FLAG_MEMCPY, or no native codec
    n_orig, _, n_comp = struct.unpack_from("<III", raw, 4)
    if n_comp <= 16 or n_comp > len(raw) or n_orig == 0:
        return None
    mode = 2 if flags & 0x4 else 1 if flags & 0x1 else 0
    ts = ts_override if ts_override > 0 else ts_hdr
    return n_comp - 16, n_orig, ts, mode, native_map[codec_id]


def _decompress_batch(frames: list, params: list, outs: list) -> np.ndarray:
    """Run tpb_decompress_batch over ``frames`` with their _batch_frame
    ``params`` into the u8 arrays ``outs``; the per-frame results (n on
    success)."""
    nf = len(frames)
    arrays = [np.frombuffer(f, dtype=np.uint8) for f in frames]
    frame_ptrs = np.array([_addr(a) for a in arrays], dtype=np.uintp)
    out_ptrs = np.array([_addr(o) for o in outs], dtype=np.uintp)
    psizes, ns, tss, modes, codecs = (np.array(col, dtype=dt) for col, dt in zip(
        zip(*params), (np.int64, np.int64, np.int32, np.int32, np.int32)))
    results = np.empty(nf, dtype=np.int64)
    scratch = np.empty(nf, dtype=np.int64)
    lib().tpb_decompress_batch(
        _addr(frame_ptrs), _addr(psizes), _addr(ns), _addr(tss), _addr(modes),
        _addr(codecs), nf, _addr(out_ptrs), _addr(results), _addr(scratch),
    )
    return results


def decompress_frames(items: list, type_size: int, native_map: bytes) -> list:
    """Batch single-block frame decode; None entries mean "not handled"
    (not a plain single-block frame of a native codec, or a payload that
    failed): the caller re-runs those through the scalar path, which owns
    every typed error (≙ tpu_blosc/native/backend.py:674-685).
    ``native_map[codec_id]`` is the native codec of a header codec id,
    0xFF for none."""
    fast = fastmod()
    if fast is not None:
        return fast.decompress_batch(items, type_size, native_map)
    out: list = [None] * len(items)
    picked = [(i, p) for i, p in ((i, _batch_frame(f, native_map, type_size))
                                  for i, f in enumerate(items)) if p is not None]
    if not picked:
        return out
    idx = [i for i, _ in picked]
    params = [p for _, p in picked]
    bufs = [alloc_bytes(p[1]) for p in params]
    views = [np.ctypeslib.as_array(ctypes.cast(addr, ctypes.POINTER(ctypes.c_ubyte)),
                                   shape=(p[1],))
             for (_, addr), p in zip(bufs, params)]
    results = _decompress_batch([items[i] for i in idx], params, views)
    for i, (buf, _), p, r in zip(idx, bufs, params, results):
        if r == p[1]:
            out[i] = buf
    return out


def decompress_frames_into(items: list, outs: list, native_map: bytes) -> list:
    """Batch decode straight into caller buffers: ``outs[i]`` is a
    writable flat u8 array or None; entries are byte counts, or None where
    the item punts to the scalar path, as in decompress_frames, or its
    buffer is missing or too small (≙ tpu_blosc/native/backend.py:688-697)."""
    fast = fastmod()
    if fast is not None:
        return fast.decompress_batch_into(items, outs, 0, native_map)
    res: list = [None] * len(items)
    picked = []
    for i, (frame, view) in enumerate(zip(items, outs)):
        p = _batch_frame(frame, native_map, 0)
        if p is not None and view is not None and view.size >= p[1]:
            picked.append((i, p))
    if not picked:
        return res
    idx = [i for i, _ in picked]
    params = [p for _, p in picked]
    results = _decompress_batch([items[i] for i in idx], params, [outs[i] for i in idx])
    for i, p, r in zip(idx, params, results):
        if r == p[1]:
            res[i] = int(r)
    return res


def decompress_frame(data: bytes, payload_off: int, payload_size: int,
                     nbytes_orig: int, type_size: int, shuffle_mode: int,
                     native_codec: int) -> bytes:
    """One C call decoding and unfiltering a single-block frame body
    (≙ tpu_blosc/native/backend.py:700-742)."""
    fast = fastmod()
    if fast is not None:
        got = fast.decompress_frame(data, payload_off, payload_size, nbytes_orig,
                                    type_size, shuffle_mode, native_codec)
        if isinstance(got, bytes):
            return got
    else:
        a = as_u8(data)
        out, addr = alloc_bytes(nbytes_orig)
        got = lib().tpb_decompress_block_into(
            _addr(a), payload_off, payload_size, addr, nbytes_orig,
            type_size, shuffle_mode, native_codec,
        )
        if got == nbytes_orig:
            return out
    if got < 0:
        raise DecompressionFailedError(
            f"blosc: decompression failed: malformed payload (code {got})"
        )
    raise SizeMismatchError(
        f"blosc: decompressed size mismatch: got {got}, "
        f"expected {nbytes_orig}"
    )
