"""Codec protocol and the open registry.

Counterpart: ``tpu_blosc/codecs/registry.py:1-66``.  The registry is a
dict keyed by codec ID; ``register_codec`` installs a codec under a new ID
or in place of a builtin one, and every entry point of the package then
calls it.  Writes take a lock; reads are dict lookups.
"""

from __future__ import annotations

import threading
from typing import Protocol, runtime_checkable

from ..format import Codec


@runtime_checkable
class CodecProtocol(Protocol):
    """What a registered codec provides."""

    def compress(self, data: bytes, level: int) -> bytes:
        """Compress data with the given level (1-9)."""
        ...

    def decompress(self, data: bytes, expected_size: int) -> bytes:
        """Decompress data to the expected size."""
        ...

    def name(self) -> str:
        """Return the codec name."""
        ...


_codecs: dict[int, CodecProtocol] = {}
_lock = threading.Lock()
_version = 0  # bumped on every registration: memoized dispatch keys on it


def register_codec(codec_id: int, impl: CodecProtocol) -> None:
    """Install ``impl`` under ``codec_id``."""
    global _version
    with _lock:
        _codecs[int(codec_id)] = impl
        _version += 1


def registry_version() -> int:
    """A counter of registry changes (for memoized dispatch)."""
    return _version


def get_codec(codec_id: int) -> CodecProtocol | None:
    """The codec registered under ``codec_id``, or None."""
    return _codecs.get(int(codec_id))


def list_codecs() -> list[Codec | int]:
    """The registered IDs, as Codec members where they are one."""
    out = []
    for cid in _codecs:
        try:
            out.append(Codec(cid))
        except ValueError:
            out.append(cid)
    return out
