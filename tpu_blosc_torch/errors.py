"""Error taxonomy of the PyTorch port.

Counterpart: ``tpu_blosc/errors.py:11-50``.  The class names, the
hierarchy and the messages raised with them are the same, so code that
catches one package's errors reads the other's the same way.  The classes
are distinct objects: ``tpu_blosc_torch`` never imports ``tpu_blosc``.
"""

from __future__ import annotations


class BloscError(Exception):
    """Base class for every tpu_blosc_torch error."""


class InvalidDataError(BloscError):
    """The compressed data is malformed or corrupted (≙ ErrInvalidData)."""


class InvalidHeaderError(BloscError):
    """The Blosc header is missing or malformed (≙ ErrInvalidHeader)."""


class InvalidVersionError(BloscError):
    """Unsupported Blosc format version (≙ ErrInvalidVersion)."""


class InvalidCodecError(BloscError):
    """The codec specified is not supported (≙ ErrInvalidCodec)."""


class SizeMismatchError(BloscError):
    """Decompressed size does not match the expected size (≙ ErrSizeMismatch)."""


class DataTooLargeError(BloscError):
    """Input data exceeds the maximum supported size (≙ ErrDataTooLarge).

    Raised for any input whose frame could not be represented in the
    uint32 header fields, instead of producing a corrupt frame.
    """


class CompressionFailedError(BloscError):
    """The compression operation failed (≙ ErrCompressionFailed)."""


class DecompressionFailedError(BloscError):
    """The decompression operation failed (≙ ErrDecompressionFailed)."""
