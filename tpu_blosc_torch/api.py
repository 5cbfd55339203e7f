"""Bytes API on the native host codec: compress and decompress frames.

Counterpart: ``tpu_blosc/api.py``: ``AUTO_BLOCK_THRESHOLD`` (:62),
``compress_with_options`` -> ``_compress_frame_sized`` -> the single-block
native path (:175-223), ``decompress`` / ``decompress_with_size`` (:412-507),
``decompress_into`` (:702-766), the advisors ``suggest_codec`` and
``suggest_options`` with ``_probe_sample`` and ``_run_fraction``
(:769-878), and ``get_decompressed_size`` (:895-902).

The frames are byte-identical to the JAX package's: both run the same
native codec.  When the memcpy fallback stores raw bytes in a single-block
frame, the shuffle flags are cleared (the JAX package's documented
divergence from the reference, tpu_blosc/api.py:8-13).  Inputs past the
uint32 frame, which the JAX package wraps in its TPB2 container, raise
NotImplementedError here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import chunk as _chunk
from . import filters
from .errors import (
    DataTooLargeError,
    InvalidCodecError,
    InvalidDataError,
    InvalidHeaderError,
    SizeMismatchError,
)
from .filters import probe as _probe
from .format import HEADER_SIZE, MAX_UINT32, Codec, Shuffle, parse_header
from .native import backend as _nb
from .options import Options

# Inputs above this go to multi-block frames (tpu_blosc/api.py:62)
AUTO_BLOCK_THRESHOLD = 4 * 1024 * 1024

# Inputs above this need the 64-bit TPB2 container (tpu_blosc/api.py:148)
FRAME_SAFE_LIMIT = MAX_UINT32 - (64 << 20)

_CONTAINER_TODO = (
    "TPB2 containers (frames past 4 GiB) are not ported yet; "
    "see ROADMAP.md, Queue 1, 'Arrays, streams, checkpoints'"
)


def _coerce_bytes(data) -> bytes:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data)
    if isinstance(data, np.ndarray):
        return data.tobytes()
    raise TypeError(f"expected bytes-like or ndarray, got {type(data)!r}")


def _coerce_flat(data):
    """Flat byte view of the input, without a copy where possible."""
    if isinstance(data, (bytes, bytearray)):
        return data
    if isinstance(data, memoryview):
        return data.cast("B") if data.contiguous else bytes(data)
    if isinstance(data, np.ndarray):
        try:
            return memoryview(data).cast("B")
        except (TypeError, BufferError, ValueError):
            # non-contiguous, or a dtype the buffer protocol refuses
            return data.tobytes()
    raise TypeError(f"expected bytes-like or ndarray, got {type(data)!r}")


def compress_with_options(data, opts: Options) -> bytes:
    """Reject empty input, clamp the options, compress (≙ tpu_blosc/api.py:175-190)."""
    raw = _coerce_flat(data)
    if len(raw) == 0:
        raise InvalidDataError("blosc: invalid compressed data: empty input")
    opts = opts.clamped()
    if len(raw) + HEADER_SIZE > FRAME_SAFE_LIMIT:
        raise NotImplementedError(_CONTAINER_TODO)
    return _compress_frame_sized(raw, opts)


def _compress_frame_sized(raw, opts: Options) -> bytes:
    """Compress data known to fit one uint32-framed chunk."""
    if len(raw) + HEADER_SIZE > MAX_UINT32:
        raise DataTooLargeError(
            f"blosc: data too large: {len(raw)} bytes exceeds uint32 frame limit"
        )
    if opts.block_size > 0 or len(raw) > AUTO_BLOCK_THRESHOLD:
        return _chunk.compress_chunked(raw, opts)
    native = _chunk.native_pipeline_codec(opts.codec, opts.level)
    if native is None:
        raise InvalidCodecError(f"blosc: unsupported codec: {opts.codec}")
    # filter, codec, memcpy fallback and header in one C call
    return _nb.compress_frame(
        raw, opts.type_size, int(opts.shuffle), int(opts.codec),
        native[0], native[1],
    )


def decompress(data) -> bytes:
    """Decompress a Blosc frame (≙ tpu_blosc/api.py:412-414)."""
    return decompress_with_size(data, 0)


def _is_container(raw: bytes) -> bool:
    return len(raw) >= 4 and raw[:4] == b"TPB2"


def _checked_header(raw: bytes):
    """Parse the header and check NBytesComp against the buffer."""
    if len(raw) < HEADER_SIZE:
        raise InvalidHeaderError(
            f"blosc: invalid header: need {HEADER_SIZE} bytes, got {len(raw)}"
        )
    header = parse_header(raw)
    if header.nbytes_comp > len(raw):
        raise InvalidDataError(
            "blosc: invalid compressed data: header claims "
            f"{header.nbytes_comp} bytes, only {len(raw)} present"
        )
    if header.nbytes_comp < HEADER_SIZE:
        raise InvalidDataError(
            "blosc: invalid compressed data: NBytesComp below header size"
        )
    return header


def _shuffle_mode(header) -> int:
    return 2 if header.has_bitshuffle else 1 if header.has_shuffle else 0


def decompress_with_size(data, type_size: int) -> bytes:
    """Decompress; ``type_size`` > 0 overrides the header's element size
    (≙ tpu_blosc/api.py:417-507)."""
    raw = _coerce_bytes(data)
    if _is_container(raw):
        raise NotImplementedError(_CONTAINER_TODO)
    header = _checked_header(raw)
    if header.is_split:
        return _chunk.decompress_chunked(raw, header, type_size)
    ts = type_size if type_size > 0 else header.type_size

    if not header.is_memcpy:
        native = _chunk.native_pipeline_codec(header.codec, 1)
        if native is None:
            raise InvalidCodecError(
                "blosc: unsupported codec: "
                f"{Codec(header.codec) if header.codec < 6 else header.codec}"
            )
        # codec decode and unfilter straight into the result in one C call
        return _nb.decompress_frame(
            raw, HEADER_SIZE, header.nbytes_comp - HEADER_SIZE,
            header.nbytes_orig, ts, _shuffle_mode(header), native[0],
        )

    decompressed = raw[HEADER_SIZE : header.nbytes_comp]
    # the reference unshuffles even memcpy frames (blosc.go:398-426)
    if header.has_bitshuffle and ts > 1:
        decompressed = _nb.bitunshuffle(decompressed, ts).tobytes()
    elif header.has_shuffle and ts > 1:
        decompressed = _nb.unshuffle(decompressed, ts).tobytes()
    if len(decompressed) != header.nbytes_orig:
        raise SizeMismatchError(
            f"blosc: decompressed size mismatch: got {len(decompressed)}, "
            f"expected {header.nbytes_orig}"
        )
    return decompressed


def _writable_u8_view(out) -> np.ndarray:
    """A writable flat uint8 view over a caller buffer (no copy)."""
    if isinstance(out, np.ndarray):
        if not out.flags.writeable or not out.flags.c_contiguous:
            raise TypeError("out array must be writable and contiguous")
        return out.reshape(-1).view(np.uint8)
    view = np.frombuffer(out, dtype=np.uint8)  # bytearray/writable memoryview
    if not view.flags.writeable:
        raise TypeError("out buffer must be writable")
    return view


def decompress_into(data, out) -> int:
    """Decompress into a caller buffer; returns the bytes written.

    ``out`` is a bytearray, writable memoryview or contiguous ndarray.
    Multi-block frames decode straight into it (≙ tpu_blosc/api.py:702-766).
    """
    raw = _coerce_bytes(data)
    n = get_decompressed_size(raw)
    view = _writable_u8_view(out)
    if view.size < n:
        raise InvalidDataError(
            f"blosc: output buffer too small: need {n}, have {view.size}"
        )
    header = _checked_header(raw)
    if header.is_split:
        native = _chunk.native_pipeline_codec(header.codec, 1)
        if native is not None:
            entries, offset = _chunk.parse_block_table(raw, header)
            return _chunk.decompress_chunked_native(
                raw, header, entries, offset, header.type_size, native[0],
                out_addr=int(view.ctypes.data),
            )
    view[:n] = np.frombuffer(decompress_with_size(raw, 0), dtype=np.uint8)
    return n


def _probe_sample(raw: bytes, sample_bytes: int, type_size: int) -> bytes:
    """Eight evenly spaced windows spanning the input, each a whole
    number of elements, when it is longer than ``sample_bytes``."""
    if len(raw) <= sample_bytes:
        return raw
    ts = max(type_size, 1)
    k = 8
    win = max(sample_bytes // k // ts * ts, ts)
    stride = max((len(raw) - win) // (k - 1) // ts * ts, win)
    parts = [raw[i * stride : i * stride + win] for i in range(k)]
    return b"".join(p for p in parts if p)


def _run_fraction(sample: np.ndarray) -> float:
    pairs = max(sample.size - 1, 1)
    return float(np.count_nonzero(sample[1:] == sample[:-1])) / pairs


def _codec_for(run_fraction: float) -> Codec:
    if run_fraction >= 0.30:
        return Codec.LZ4  # run-dominated: match copies at memory speed
    if run_fraction >= 0.02:
        return Codec.ZSTD  # structured but not run-heavy: entropy coding
    return Codec.LZ4  # near-random: fastest attempt, memcpy fallback


def suggest_codec(data, type_size: int = 4, sample_bytes: int = 1 << 22) -> Codec:
    """Recommend a codec from a one-pass probe of a byte-shuffled sample
    spanning the input (≙ tpu_blosc/api.py:788-828).

    With a CUDA device the probe runs there (filters/probe.py, 3 of every
    4 adjacent byte pairs, as tpu_blosc's TPU probe); without one, NumPy
    counts all pairs, as tpu_blosc does off the TPU.  A failed probe
    raises.
    """
    raw = _probe_sample(_coerce_bytes(data), sample_bytes, type_size)
    if len(raw) == 0:
        raise InvalidDataError("blosc: invalid compressed data: empty input")
    if type_size > 1 and len(raw) >= type_size:
        raw = filters.shuffle_bytes(raw, type_size).tobytes()
    if torch.cuda.is_available():
        rf = _probe.stream_probe(raw)["run_fraction"]
    else:
        rf = _run_fraction(np.frombuffer(raw, dtype=np.uint8))
    return _codec_for(rf)


def suggest_options(data, type_size: int = 4,
                    sample_bytes: int = 1 << 22) -> Options:
    """Recommend the filter and the codec (≙ tpu_blosc/api.py:836-878):
    the filter whose output of the sample has the most adjacent equal
    bytes (byte shuffle wins ties, then none, then bit shuffle), and the
    codec for that stream as in suggest_codec."""
    raw = _probe_sample(_coerce_bytes(data), sample_bytes, type_size)
    if len(raw) == 0:
        raise InvalidDataError("blosc: invalid compressed data: empty input")
    type_size = type_size if type_size > 0 else 1
    candidates = [(_run_fraction(np.frombuffer(raw, dtype=np.uint8)), Shuffle.NOSHUFFLE)]
    if type_size > 1 and len(raw) >= 8 * type_size:
        candidates.append((_run_fraction(filters.shuffle_bytes(raw, type_size)),
                           Shuffle.SHUFFLE))
        candidates.append((_run_fraction(filters.bit_shuffle(raw, type_size)),
                           Shuffle.BITSHUFFLE))
    order = {Shuffle.SHUFFLE: 0, Shuffle.NOSHUFFLE: 1, Shuffle.BITSHUFFLE: 2}
    rf, mode = max(candidates, key=lambda c: (c[0], -order[c[1]]))
    return Options(codec=_codec_for(rf), shuffle=mode, type_size=type_size)


def get_decompressed_size(data) -> int:
    """NBytesOrig of a frame (≙ tpu_blosc/api.py:895-902)."""
    raw = _coerce_bytes(data)
    if _is_container(raw):
        raise NotImplementedError(_CONTAINER_TODO)
    return parse_header(raw).nbytes_orig
