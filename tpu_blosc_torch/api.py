"""Bytes API on the native host codec: compress and decompress frames.

Counterpart: ``tpu_blosc/api.py``: ``AUTO_BLOCK_THRESHOLD`` (:62),
``compress`` and ``compress_batch`` (:117-139, :260-283; without the
fast-lane cache of the former, :95-114, which gained no more than the
run-to-run spread on the card's host), ``compress_with_options`` ->
``_compress_frame_sized`` -> the single-block native path (:175-223), the
batch calls ``compress_batch_with_options``,
``decompress_batch`` and ``decompress_batch_into`` (:308-409),
``decompress`` / ``decompress_with_size`` (:412-507), the range calls
``decompress_range`` and ``decompress_range_into`` (:510-687),
``decompress_into`` (:702-766), the advisors ``suggest_codec`` and
``suggest_options`` with ``_probe_sample`` and ``_run_fraction``
(:769-878), ``get_info`` and ``get_decompressed_size`` (:881-902).

The frames are byte-identical to the JAX package's: both run the same
native codec, and a codec registered with ``register_codec`` (a new ID, or
one in place of a builtin) is called block by block as there
(chunk.py).  On the route without a native build
(``TPU_BLOSC_NO_NATIVE=1``) every codec takes that route, the builtin
ones in pure Python, as in the JAX package without its library.  When
the memcpy fallback stores raw bytes in a single-block frame, the shuffle
flags are cleared (the JAX package's documented divergence from the
reference, tpu_blosc/api.py:8-13).  Inputs past the uint32 frame go into
a TPB2 container (container.py), as there.
"""

from __future__ import annotations

import numpy as np
import torch

from . import chunk as _chunk
from . import container as _container
from . import filters
from .errors import (
    DataTooLargeError,
    InvalidDataError,
    InvalidHeaderError,
    SizeMismatchError,
)
from .filters import probe as _probe
from .format import (
    FLAG_BITSHUFFLE,
    FLAG_MEMCPY,
    FLAG_SHUFFLE,
    FORMAT_VERSION,
    HEADER_SIZE,
    MAX_UINT32,
    Codec,
    Header,
    Shuffle,
    parse_header,
)
from .native import backend as _nb
from .options import Options

# Inputs above this go to multi-block frames (tpu_blosc/api.py:62)
AUTO_BLOCK_THRESHOLD = 4 * 1024 * 1024

# Inputs above this need the 64-bit TPB2 container (tpu_blosc/api.py:148)
FRAME_SAFE_LIMIT = MAX_UINT32 - (64 << 20)


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


def compress(data, codec: Codec = Codec.LZ4, level: int = 5,
             shuffle: Shuffle = Shuffle.SHUFFLE, type_size: int = 4) -> bytes:
    """Compress data into a Blosc frame (≙ tpu_blosc/api.py:117-139)."""
    return compress_with_options(data, Options(codec, level, shuffle, type_size))


def compress_batch(items, codec: Codec = Codec.LZ4, level: int = 5,
                   shuffle: Shuffle = Shuffle.SHUFFLE, type_size: int = 4) -> list[bytes]:
    """``[compress(x, ...) for x in items]``, the same frames byte for
    byte, through compress_batch_with_options (≙ tpu_blosc/api.py:260-283)."""
    return compress_batch_with_options(items, Options(codec, level, shuffle, type_size))


def compress_with_options(data, opts: Options) -> bytes:
    """Reject empty input, clamp the options, compress (≙ tpu_blosc/api.py:175-190)."""
    raw = _coerce_flat(data)
    if len(raw) == 0:
        raise InvalidDataError("blosc: invalid compressed data: empty input")
    opts = opts.clamped()
    if len(raw) + HEADER_SIZE > FRAME_SAFE_LIMIT:
        return _container.compress_container(raw, opts)
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
    if native is not None:
        # filter, codec, memcpy fallback and header in one C call
        return _nb.compress_frame(
            raw, opts.type_size, int(opts.shuffle), int(opts.codec),
            native[0], native[1],
        )
    return _compress_single_block_registry(raw, opts)


def _compress_single_block_registry(raw, opts: Options) -> bytes:
    """A single-block frame from the registered codec of ``opts.codec``
    (≙ tpu_blosc/api.py:206-257): the input stored raw, with the filter
    flags cleared, when the codec does not shrink it."""
    compressor = _chunk.registered_codec(opts.codec)
    compressed = compressor.compress(
        _chunk.filter_block(raw, opts.type_size, opts.shuffle), opts.level)
    if len(compressed) >= len(raw):
        compressed, flags = raw, FLAG_MEMCPY
    else:
        flags = {Shuffle.SHUFFLE: FLAG_SHUFFLE,
                 Shuffle.BITSHUFFLE: FLAG_BITSHUFFLE}.get(opts.shuffle, 0)
    header = Header(
        version=FORMAT_VERSION, version_lz=int(opts.codec), flags=flags,
        type_size=min(opts.type_size, 255), nbytes_orig=len(raw),
        block_size=len(raw), nbytes_comp=HEADER_SIZE + len(compressed),
    )
    return header.to_bytes() + bytes(compressed)


def _coerce_buffer(item):
    """A C-contiguous buffer of a batch item, without a copy where
    possible (≙ tpu_blosc/api.py:284-301)."""
    if isinstance(item, (bytes, bytearray)):
        return item
    if isinstance(item, memoryview):
        return item if item.contiguous else bytes(item)
    if isinstance(item, np.ndarray):
        if item.dtype == object:
            raise TypeError("object arrays cannot be compressed")
        return item if item.flags.c_contiguous else np.ascontiguousarray(item)
    raise TypeError(f"expected bytes-like or ndarray, got {type(item)!r}")


def _buffer_nbytes(buf) -> int:
    return buf.nbytes if isinstance(buf, (np.ndarray, memoryview)) else len(buf)


def compress_batch_with_options(items, opts: Options) -> list[bytes]:
    """``[compress_with_options(x, opts) for x in items]``, the same frames
    byte for byte, with the single-block items in one native call that
    schedules them across the host's cores (≙ tpu_blosc/api.py:308-340)."""
    raws = []
    for i, item in enumerate(items):
        raw = _coerce_buffer(item)
        if _buffer_nbytes(raw) == 0:
            raise InvalidDataError(
                f"blosc: invalid compressed data: empty input (batch item {i})"
            )
        raws.append(raw)
    opts = opts.clamped()
    native = _chunk.native_pipeline_codec(opts.codec, opts.level)
    if native is None or opts.block_size > 0:
        return [compress_with_options(r, opts) for r in raws]
    small = [i for i, r in enumerate(raws) if _buffer_nbytes(r) <= AUTO_BLOCK_THRESHOLD]
    out: list = [None] * len(raws)
    frames = _nb.compress_frames(
        [raws[i] for i in small], opts.type_size, int(opts.shuffle),
        int(opts.codec), native[0], native[1],
    )
    for i, frame in zip(small, frames):
        out[i] = frame
    return [f if f is not None else compress_with_options(r, opts)
            for f, r in zip(out, raws)]


def _decode_native_map() -> bytes:
    """Header codec id -> native codec id, for the batch decoders; 0xFF
    for an id the registry route decodes (≙ tpu_blosc/api.py:366-377)."""
    return bytes((_chunk.native_pipeline_codec(cid, 1) or (0xFF,))[0] for cid in range(6))


def decompress_batch(items, type_size: int = 0) -> list[bytes]:
    """``[decompress_with_size(x, type_size) for x in items]``: plain
    single-block frames in one native call, every other item (and every
    error) through the scalar path (≙ tpu_blosc/api.py:343-363)."""
    raws = [_coerce_bytes(x) for x in items]
    out = (_nb.decompress_frames(raws, type_size, _decode_native_map())
           if _nb.available() else [None] * len(raws))
    return [r if r is not None else decompress_with_size(raw, type_size)
            for r, raw in zip(out, raws)]


def _writable_view_or_none(out) -> np.ndarray | None:
    try:
        return _writable_u8_view(out)
    except (TypeError, ValueError):
        return None


def decompress_batch_into(items, outs) -> list[int]:
    """Decode frame ``items[i]`` into ``outs[i]``; returns the byte counts.
    Plain single-block frames decode in one native call straight into the
    buffers; the rest, and every error, go through decompress_into.  When
    an item raises, later buffers may already hold their data
    (≙ tpu_blosc/api.py:380-409)."""
    raws = [_coerce_bytes(x) for x in items]
    outs = list(outs)
    if len(raws) != len(outs):
        raise ValueError(f"outs length {len(outs)} must match items length {len(raws)}")
    views = [_writable_view_or_none(o) for o in outs]
    res = (_nb.decompress_frames_into(raws, views, _decode_native_map())
           if _nb.available() else [None] * len(raws))
    return [r if r is not None else decompress_into(raw, o)
            for r, raw, o in zip(res, raws, outs)]


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


def decompress_with_size(data, type_size: int) -> bytes:
    """Decompress; ``type_size`` > 0 overrides the header's element size
    (≙ tpu_blosc/api.py:417-507)."""
    raw = _coerce_bytes(data)
    if _is_container(raw):
        return _container.decompress_container(raw, type_size)
    header = _checked_header(raw)
    if header.is_split:
        return _chunk.decompress_chunked(raw, header, type_size)
    ts = type_size if type_size > 0 else header.type_size

    decompressed = raw[HEADER_SIZE : header.nbytes_comp]
    if not header.is_memcpy:
        native = _chunk.native_pipeline_codec(header.codec, 1)
        if native is not None:
            # codec decode and unfilter straight into the result in one C call
            return _nb.decompress_frame(
                raw, HEADER_SIZE, header.nbytes_comp - HEADER_SIZE,
                header.nbytes_orig, ts, int(header.shuffle_mode), native[0],
            )
        codec = _chunk.registered_codec(
            header.codec, Codec(header.codec) if header.codec < 6 else header.codec)
        decompressed = codec.decompress(decompressed, header.nbytes_orig)
    # the reference unshuffles even memcpy frames (blosc.go:398-426)
    decompressed = _chunk.unfilter_block(decompressed, ts, header.shuffle_mode)
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
    Multi-block frames, and single-block frames of a native codec, decode
    straight into it (≙ tpu_blosc/api.py:702-766); when such a decode
    fails, its first ``n`` bytes may hold part of the data.
    """
    raw = _coerce_bytes(data)
    n = get_decompressed_size(raw)
    view = _writable_u8_view(out)
    if view.size < n:
        raise InvalidDataError(
            f"blosc: output buffer too small: need {n}, have {view.size}"
        )
    if _is_container(raw):
        _, _, _, _, _, sizes, fpos = _container.parse_container(raw)
        pos = 0
        for fs in sizes:
            pos += decompress_into(raw[fpos : fpos + fs], view[pos:])
            fpos += fs
        return pos
    header = _checked_header(raw)
    if header.is_split:
        native = _chunk.native_pipeline_codec(header.codec, 1)
        if native is not None:
            entries, offset = _chunk.parse_block_table(raw, header)
            return _chunk.decompress_chunked_native(
                raw, header, entries, offset, header.type_size, native[0],
                out_addr=int(view.ctypes.data),
            )
    elif _nb.available():
        # a plain single-block frame of a native codec decodes straight into
        # the buffer; the rest, and every error, take decompress_with_size
        got = _nb.decompress_frames_into([raw], [view[:n]], _decode_native_map())[0]
        if got is not None:
            return got
    view[:n] = np.frombuffer(decompress_with_size(raw, 0), dtype=np.uint8)
    return n


def _checked_range(header, start: int, size: int) -> None:
    if start + size > header.nbytes_orig:
        raise SizeMismatchError(
            f"blosc: decompressed size mismatch: range [{start}, {start + size}) "
            f"outside {header.nbytes_orig} bytes"
        )


def _range_header(raw: bytes):
    """The header of a frame a range decode reads, with NBytesComp
    checked against the buffer."""
    if len(raw) < HEADER_SIZE:
        raise InvalidHeaderError(
            f"blosc: invalid header: need {HEADER_SIZE} bytes, got {len(raw)}"
        )
    header = parse_header(raw)
    if header.nbytes_comp > len(raw) or header.nbytes_comp < HEADER_SIZE:
        raise InvalidDataError("blosc: invalid compressed data: bad NBytesComp")
    return header


def _block_table(raw: bytes, header):
    entries, offset = _chunk.parse_block_table(raw, header)
    _chunk.validate_block_layout(header.nbytes_orig, header.block_size, len(entries))
    return entries, offset


def decompress_range(data, start: int, size: int, type_size: int = 0) -> bytes:
    """Bytes ``[start, start + size)`` of a frame's decoded data.  A
    multi-block frame decodes only the blocks that cover the range, a
    container only the sub-frames that do; a single-block frame decodes
    whole.  ``type_size`` > 0 overrides the header's element size
    (≙ tpu_blosc/api.py:510-595)."""
    raw = _coerce_bytes(data)
    if start < 0 or size < 0:
        raise InvalidDataError("blosc: invalid compressed data: negative range")
    if _is_container(raw):
        _, _, _, _, total, sizes, off = _container.parse_container(raw)
        spans = _container.frame_spans(memoryview(raw), total, sizes, off)
        if start + size > total:
            raise SizeMismatchError(
                f"blosc: decompressed size mismatch: range [{start}, {start + size}) "
                f"outside {total} bytes"
            )
        parts = []
        pos = 0
        for fpos, fs, n_sub in spans:
            lo, hi = max(start, pos), min(start + size, pos + n_sub)
            if lo < hi:
                parts.append(decompress_range(raw[fpos : fpos + fs], lo - pos, hi - lo,
                                              type_size))
            pos += n_sub
        return b"".join(parts)
    header = _range_header(raw)
    _checked_range(header, start, size)
    if size == 0:
        return b""
    ts = type_size if type_size > 0 else header.type_size
    if not header.is_split:
        return decompress_with_size(raw, type_size)[start : start + size]
    entries, offset = _block_table(raw, header)
    bs = header.block_size
    lo_b, hi_b = start // bs, (start + size - 1) // bs
    blob = _chunk.decompress_block_run(raw, header, entries, offset, lo_b, hi_b, ts)
    rel = start - lo_b * bs
    return blob if rel == 0 and size == len(blob) else blob[rel : rel + size]


def decompress_range_into(data, start: int, size: int, out, type_size: int = 0) -> int:
    """decompress_range into a caller buffer; returns ``size``.  On a
    multi-block frame a run of 4 or more covered whole blocks decodes
    straight into ``out``, and only the partial blocks at its edges pass
    through bytes (≙ tpu_blosc/api.py:598-676)."""
    raw = _coerce_bytes(data)
    view = _writable_u8_view(out)
    if size > view.size:
        raise InvalidDataError(
            f"blosc: output buffer too small: need {size}, have {view.size}"
        )
    if len(raw) >= HEADER_SIZE and not _is_container(raw) and parse_header(raw).is_split:
        header = _range_header(raw)
        if start < 0 or size < 0:
            raise InvalidDataError("blosc: invalid compressed data: negative range")
        _checked_range(header, start, size)
        if size == 0:
            return 0
        n, bs = header.nbytes_orig, header.block_size
        entries, offset = _block_table(raw, header)
        ts = type_size if type_size > 0 else header.type_size
        lo_b, hi_b = start // bs, (start + size - 1) // bs
        in_lo = lo_b + (1 if start % bs else 0)
        in_hi = hi_b - (1 if (start + size) % bs and start + size < n else 0)
        native = _chunk.native_pipeline_codec(header.codec, 1)
        if native is not None and in_hi - in_lo + 1 >= 4:
            _chunk.decompress_chunked_native(
                raw, header, entries, offset, ts, native[0],
                out_addr=int(view.ctypes.data) + in_lo * bs - start,
                lo_b=in_lo, hi_b=in_hi,
            )
            if in_lo > lo_b:  # the leading partial block
                poff = offset + sum(s for s, _ in entries[:lo_b])
                blob = _chunk.decompress_single_block(raw, header, entries, poff, lo_b, ts)
                rel = start - lo_b * bs
                view[: len(blob) - rel] = np.frombuffer(blob, dtype=np.uint8)[rel:]
            if in_hi < hi_b:  # the trailing partial block
                poff = offset + sum(s for s, _ in entries[:hi_b])
                blob = _chunk.decompress_single_block(raw, header, entries, poff, hi_b, ts)
                take = start + size - hi_b * bs
                view[size - take : size] = np.frombuffer(blob, dtype=np.uint8)[:take]
            return size
    blob = decompress_range(raw, start, size, type_size)
    view[:size] = np.frombuffer(blob, dtype=np.uint8)
    return size


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


def get_info(data):
    """The frame's Header, parsed without decoding, or a container's
    ContainerInfo (≙ tpu_blosc/api.py:881-892)."""
    raw = _coerce_bytes(data)
    if _is_container(raw):
        return _container.get_container_info(raw)
    return parse_header(raw)


def get_decompressed_size(data) -> int:
    """NBytesOrig of a frame, or a container's total
    (≙ tpu_blosc/api.py:895-902)."""
    raw = _coerce_bytes(data)
    if _is_container(raw):
        return _container.parse_container(raw)[4]
    return parse_header(raw).nbytes_orig
