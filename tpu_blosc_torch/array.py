"""Self-describing compressed tensor envelopes (pack_array / unpack_array).

Counterpart: ``tpu_blosc/array.py:34-271``; the envelopes are
byte-identical to the JAX package's for the same elements:

    TPBA | ver:u8 | flags:u8 | dlen:u8 | dtype-str | ndim:u8 | shape:u64*ndim | frame

``flags`` bit 0: no payload (zero elements, no frame follows); bit 1: the
payload is the Fortran-ordered byte stream of a NumPy array (restored on
unpack as a tensor with the transposed strides).  The dtype string is
NumPy's ``.str`` (dtypes.py).

A CUDA tensor packs through compress_array, with its filter stage on the
device; a CPU tensor or a NumPy array takes the host codec.  Tensors pack
in their logical C order, as the JAX package packs its device arrays.
Unpacking gives a CPU tensor, or with ``device`` decodes through
decompress_array onto that device.

A DTensor packs as its full tensor, gathered first (a collective every rank
of its mesh enters); ``unpack_array(data, sharding=(mesh, placements))``
returns a DTensor of this rank's span (≙ tpu_blosc/array.py:171-195).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import dtypes
from .api import (
    compress_with_options,
    decompress_into,
    decompress_range_into,
    get_decompressed_size,
)
from .device import compress_array, decompress_array, tensor_bytes
from .errors import InvalidDataError, InvalidHeaderError
from .filters import load_target
from .options import Options

_MAGIC = b"TPBA"
_VERSION = 1
_FLAG_EMPTY = 0x1
_FLAG_FORTRAN = 0x2


def _envelope_head(dstr: str, shape: tuple, flags: int) -> bytes:
    if len(shape) > 255:
        raise TypeError("arrays beyond 255 dimensions cannot be packed")
    d = dstr.encode("ascii")
    return (_MAGIC + bytes([_VERSION, flags, len(d)]) + d + bytes([len(shape)])
            + b"".join(struct.pack("<Q", dim) for dim in shape))


def _default_opts(itemsize: int) -> Options:
    return Options(type_size=min(itemsize, 255))


def pack_array(arr, opts: Options | None = None) -> bytes:
    """Compress a tensor or a NumPy array into a self-describing envelope.

    ``type_size`` defaults to the element size (at most 255, the frame
    header's limit); ``opts`` overrides every option.  An element type
    torch lacks raises TypeError.  A DTensor packs as its full tensor: its
    gather is a collective that every rank of its mesh must enter.
    """
    from .dist import _sharded

    # a DTensor packs as a sharded jax.Array does: through compress_array
    sharded = _sharded.is_dtensor(arr)
    if sharded:
        arr = _sharded.gather_full(arr)
    if isinstance(arr, torch.Tensor):
        dstr = dtypes.envelope_str(arr.dtype)
        shape = tuple(arr.shape)
        if arr.numel() == 0:
            return _envelope_head(dstr, shape, _FLAG_EMPTY)
        head = _envelope_head(dstr, shape, 0)
        opts = opts if opts is not None else _default_opts(arr.element_size())
        if sharded or arr.device.type == "cuda":
            return head + compress_array(arr, opts)
        return head + compress_with_options(tensor_bytes(arr).numpy(), opts)

    arr = np.asarray(arr)
    if arr.dtype.kind == "O":
        raise TypeError("object dtypes cannot be packed")
    if arr.dtype.names is not None:
        raise TypeError("structured dtypes cannot be packed")
    # the port packs only what it can unpack into a tensor
    dstr = dtypes.envelope_str(dtypes.from_numpy(arr.dtype))
    fortran = arr.ndim > 1 and arr.flags.f_contiguous and not arr.flags.c_contiguous
    body = np.ascontiguousarray(arr.T if fortran else arr)
    flags = _FLAG_FORTRAN if fortran else 0
    if body.nbytes == 0:
        return _envelope_head(dstr, arr.shape, flags | _FLAG_EMPTY)
    opts = opts if opts is not None else _default_opts(arr.dtype.itemsize)
    return _envelope_head(dstr, arr.shape, flags) + compress_with_options(body, opts)


def _parse_envelope(buf: bytes) -> tuple[torch.dtype, tuple, int, int]:
    """Validate a TPBA envelope; (dtype, shape, flags, payload offset)."""
    if len(buf) < 8 or buf[:4] != _MAGIC:
        raise InvalidHeaderError("blosc: invalid header: not a TPBA envelope")
    if buf[4] != _VERSION:
        raise InvalidHeaderError(f"blosc: invalid header: unsupported TPBA version {buf[4]}")
    flags, dlen = buf[5], buf[6]
    pos = 7
    if len(buf) < pos + dlen + 1:
        raise InvalidDataError("blosc: invalid compressed data: truncated envelope")
    dstr = buf[pos : pos + dlen].decode("ascii", errors="replace")
    dtype = dtypes.from_string(dstr)
    if dtype is None:
        raise InvalidDataError(f"blosc: invalid compressed data: bad dtype ({dstr!r})")
    pos += dlen
    ndim = buf[pos]
    pos += 1
    if len(buf) < pos + 8 * ndim:
        raise InvalidDataError("blosc: invalid compressed data: truncated shape")
    shape = struct.unpack_from(f"<{ndim}Q", buf, pos)
    return dtype, shape, flags, pos + 8 * ndim


def _nbytes(dtype: torch.dtype, shape) -> int:
    return dtype.itemsize * int(np.prod(shape, dtype=object))


def unpack_array(data, device=False, sharding=None) -> torch.Tensor:
    """The tensor of a pack_array envelope, on the CPU; ``device=True``
    (the current CUDA device) or a device decodes through
    decompress_array (a Fortran-ordered envelope decodes on the host
    first).  ``sharding=(mesh, placements)`` implies the device route and
    returns a DTensor of this rank's span on the mesh's device (no
    collective; a ``device`` named beside it must be of the mesh's type)."""
    buf = bytes(data)
    dtype, shape, flags, pos = _parse_envelope(buf)
    if sharding is not None:
        from .dist import _sharded

        target = _sharded.sharding_device(sharding, device)
        if flags & _FLAG_EMPTY:
            return _sharded.place(torch.empty(shape, dtype=dtype), sharding, target)
        if not flags & _FLAG_FORTRAN:
            return decompress_array(buf[pos:], dtype, shape=shape, device=target,
                                    sharding=sharding)
        return _sharded.place(unpack_array(buf), sharding, target)
    target = load_target(device, "unpack_array")
    if target is not None:
        if flags & _FLAG_EMPTY:
            return torch.empty(shape, dtype=dtype, device=target)
        if not flags & _FLAG_FORTRAN:
            return decompress_array(buf[pos:], dtype, shape=shape, device=target)
        return unpack_array(buf).to(target)
    if flags & _FLAG_EMPTY:
        return torch.empty(shape, dtype=dtype)
    payload = buf[pos:]
    nbytes = _nbytes(dtype, shape)
    if nbytes != get_decompressed_size(payload):
        raise InvalidDataError("blosc: invalid compressed data: payload size does not match shape")
    raw = torch.empty(nbytes, dtype=torch.uint8)
    decompress_into(payload, raw.numpy())
    if flags & _FLAG_FORTRAN:
        # the payload is the C-order bytes of the transposed array
        return raw.view(dtype).reshape(shape[::-1]).permute(*reversed(range(len(shape))))
    return raw.view(dtype).reshape(shape)


def unpack_array_rows(data, start: int, stop: int) -> torch.Tensor:
    """Rows [start, stop) along axis 0 of a packed array, as a CPU
    tensor, decoding only the frame blocks that cover them (a
    Fortran-ordered envelope unpacks whole)."""
    buf = bytes(data)
    dtype, shape, flags, pos = _parse_envelope(buf)
    if len(shape) == 0:
        raise InvalidDataError("blosc: invalid compressed data: 0-d array has no rows")
    start, stop = int(start), int(stop)
    if not 0 <= start <= stop <= shape[0]:
        raise InvalidDataError(
            f"blosc: invalid compressed data: rows [{start}, {stop}) outside [0, {shape[0]})"
        )
    out_shape = (stop - start, *shape[1:])
    if flags & _FLAG_EMPTY or stop == start:
        return torch.empty(out_shape, dtype=dtype)
    if flags & _FLAG_FORTRAN:
        return unpack_array(buf)[start:stop].clone()
    row = _nbytes(dtype, shape[1:])
    raw = torch.empty((stop - start) * row, dtype=torch.uint8)
    decompress_range_into(buf[pos:], start * row, raw.numel(), raw.numpy())
    return raw.view(dtype).reshape(out_shape)
