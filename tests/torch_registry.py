"""Codecs registered in both packages at once, for the port's registry tests.

The registry is process-global in each package and test files share
workers, so ``both_registries`` puts back both registries (and both
builtin tables) as they were, builtins it overrode included, and bumps
the registry versions so memoized dispatch sees the change.
"""

from __future__ import annotations

import contextlib
import zlib

from tpu_blosc.codecs import registry as jreg
from tpu_blosc.codecs import standard as jstd
from tpu_blosc_torch.codecs import registry as treg
from tpu_blosc_torch.codecs import standard as tstd


class Identity:
    """Stores every block as it is (≙ tests/test_codecs.py:139-149): the
    memcpy fallback takes every block."""

    def name(self):
        return "identity"

    def compress(self, data, level):
        return bytes(data)

    def decompress(self, data, expected_size):
        return bytes(data)


class Zlib1:
    """zlib at level 1 whatever the level asked for."""

    def name(self):
        return "zlib1"

    def compress(self, data, level):
        return zlib.compress(bytes(data), 1)

    def decompress(self, data, expected_size):
        return zlib.decompress(bytes(data))


class Counting:
    """A registered codec that counts its calls and forwards them."""

    def __init__(self, inner):
        self.inner = inner
        self.compressed = self.decompressed = 0

    def name(self):
        return "counting-" + self.inner.name()

    def compress(self, data, level):
        self.compressed += 1
        return self.inner.compress(data, level)

    def decompress(self, data, expected_size):
        self.decompressed += 1
        return self.inner.decompress(data, expected_size)


def make_codec(kind: str):
    return {"identity": Identity, "zlib1": Zlib1,
            "counting-lz4": lambda: Counting(tstd.Lz4Codec())}[kind]()


_MODULES = ((jreg, jstd), (treg, tstd))


@contextlib.contextmanager
def both_registries():
    """Yield ``register(codec_id, impl)``, which installs ``impl`` in both
    packages; both registries are restored on the way out."""
    saved = [(dict(reg._codecs), dict(std._BUILTIN_INSTANCES)) for reg, std in _MODULES]

    def register(codec_id, impl):
        jreg.register_codec(codec_id, impl)
        treg.register_codec(codec_id, impl)
        return impl

    try:
        yield register
    finally:
        for (reg, std), (codecs, builtins) in zip(_MODULES, saved):
            with reg._lock:
                reg._codecs.clear()
                reg._codecs.update(codecs)
                std._BUILTIN_INSTANCES.clear()
                std._BUILTIN_INSTANCES.update(builtins)
                reg._version += 1
