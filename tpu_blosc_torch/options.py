"""Compression options with the reference's defaults and clamping rules.

Counterpart: ``tpu_blosc/options.py:15-47``.  ``type_size <= 0`` becomes
1 and ``level`` is clamped to [1, 9].
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .format import Codec, Shuffle


@dataclass(frozen=True)
class Options:
    """Configures compression behaviour (≙ tpu_blosc/options.py:15-42).

    ``block_size`` 0 means automatic: single-block frames for small
    inputs, multi-block chunking above ``api.AUTO_BLOCK_THRESHOLD``.
    ``num_threads`` 0 means all host cores; otherwise it caps the OpenMP
    team of the native block pipelines.
    """

    codec: Codec = Codec.LZ4
    level: int = 5
    shuffle: Shuffle = Shuffle.SHUFFLE
    type_size: int = 4
    block_size: int = 0
    num_threads: int = 0

    def clamped(self) -> "Options":
        """Apply the reference's option clamping."""
        type_size = self.type_size if self.type_size > 0 else 1
        level = min(max(self.level, 1), 9)
        if type_size == self.type_size and level == self.level:
            return self
        return replace(self, type_size=type_size, level=level)


def default_options() -> Options:
    """LZ4, level 5, byte shuffle, type size 4 (≙ tpu_blosc/options.py:45-47)."""
    return Options()
