"""Element types between torch and the files the JAX package writes.

The JAX package names an element type by NumPy's dtype: ``.str`` in a
pack_array envelope (``'<f4'``, ``'|b1'``, ``'<c8'``; the registered name
``'bfloat16'`` where ``.str`` would degrade to a void type,
tpu_blosc/array.py:34-47) and ``str(dtype)`` in a checkpoint manifest
(``"float32"``, ``"bfloat16"``, tpu_blosc/checkpoint.py:50-62).  The port
writes the same strings for the same element types and reads them back
into torch dtypes with the table below, so it never needs a NumPy
bfloat16 (which exists only where ``ml_dtypes`` is installed).
"""

from __future__ import annotations

import numpy as np
import torch

# torch dtype, envelope string (NumPy .str), manifest name (str(np.dtype))
_TABLE = [
    (torch.bool, "|b1", "bool"),
    (torch.uint8, "|u1", "uint8"),
    (torch.int8, "|i1", "int8"),
    (torch.int16, "<i2", "int16"),
    (torch.int32, "<i4", "int32"),
    (torch.int64, "<i8", "int64"),
    (torch.float16, "<f2", "float16"),
    (torch.bfloat16, "bfloat16", "bfloat16"),
    (torch.float32, "<f4", "float32"),
    (torch.float64, "<f8", "float64"),
    (torch.complex64, "<c8", "complex64"),
    (torch.complex128, "<c16", "complex128"),
]
# element types that only newer torch releases have
for _name, _str in (("uint16", "<u2"), ("uint32", "<u4"), ("uint64", "<u8"),
                    ("float8_e4m3fn", "float8_e4m3fn"), ("float8_e5m2", "float8_e5m2")):
    if hasattr(torch, _name):
        _TABLE.append((getattr(torch, _name), _str, _name))

_ENVELOPE = {t: s for t, s, _ in _TABLE}
_MANIFEST = {t: n for t, _, n in _TABLE}
_BY_STRING = {**{s: t for t, s, _ in _TABLE}, **{n: t for t, _, n in _TABLE}}


def _known(dtype: torch.dtype) -> None:
    if dtype not in _ENVELOPE:
        raise TypeError(f"no NumPy counterpart for the element type {dtype}")


def envelope_str(dtype: torch.dtype) -> str:
    """The envelope's dtype string of ``dtype`` (NumPy's ``.str``)."""
    _known(dtype)
    return _ENVELOPE[dtype]


def manifest_name(dtype: torch.dtype) -> str:
    """The checkpoint manifest's name of ``dtype`` (``str(np.dtype)``)."""
    _known(dtype)
    return _MANIFEST[dtype]


def from_string(s: str) -> torch.dtype | None:
    """The torch dtype an envelope string or manifest name stands for, or
    None for one the port has no torch type for."""
    return _BY_STRING.get(s)


def from_numpy(dtype: np.dtype) -> torch.dtype:
    """The torch dtype of a NumPy dtype (NumPy's own types by ``.str``,
    extension types such as ml_dtypes' bfloat16 by name); TypeError for
    one torch lacks, such as datetimes, strings or big-endian types."""
    got = _BY_STRING.get(dtype.str) or (
        _BY_STRING.get(dtype.name) if dtype.kind == "V" and dtype.names is None else None
    )
    if got is None:
        raise TypeError(f"no torch counterpart for the NumPy dtype {dtype}")
    return got
