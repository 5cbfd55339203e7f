"""Shuffle filters of the port: host buffers and device blocks.

Counterpart: ``tpu_blosc/filters/__init__.py:35-176``.  The JAX package
probes its platform once at import and falls back from device to native
to NumPy.  The port needs no probe: a host buffer (bytes or ndarray) goes
through the native C++ shuffle, and a block tensor through
``batched.shuffle_blocks`` or ``batched.bit_shuffle_blocks``, whose route
follows the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..format import Shuffle
from ..native import backend as _native
from .batched import (
    bit_shuffle_blocks,
    bit_unshuffle_blocks,
    shuffle_blocks,
    unshuffle_blocks,
)

__all__ = [
    "backend_name",
    "bit_shuffle",
    "bit_shuffle_blocks",
    "bit_unshuffle",
    "bit_unshuffle_blocks",
    "filter_blocks",
    "filter_bytes",
    "load_target",
    "shuffle_blocks",
    "shuffle_buffer",
    "shuffle_bytes",
    "target_device",
    "unfilter_blocks",
    "unfilter_bytes",
    "unshuffle_blocks",
    "unshuffle_buffer",
    "unshuffle_bytes",
]


def backend_name() -> str:
    """'cuda' when a CUDA device is present (block tensors there run the
    CUDA kernels), else 'torch-cpu'."""
    return "cuda" if torch.cuda.is_available() else "torch-cpu"


def shuffle_bytes(src, type_size: int) -> np.ndarray:
    """Whole-buffer byte shuffle on the host (native); the bytes past the
    last whole element are copied verbatim."""
    return _native.shuffle(src, type_size)


def unshuffle_bytes(src, type_size: int) -> np.ndarray:
    """Inverse of shuffle_bytes."""
    return _native.unshuffle(src, type_size)


def bit_shuffle(src, type_size: int) -> np.ndarray:
    """Whole-buffer bit shuffle on the host (native), in the reference's
    local groups of 8 elements; bytes past the last whole group are
    copied verbatim."""
    return _native.bitshuffle(src, type_size)


def bit_unshuffle(src, type_size: int) -> np.ndarray:
    """Inverse of bit_shuffle."""
    return _native.bitunshuffle(src, type_size)


def filter_bytes(src, type_size: int, mode: int) -> np.ndarray:
    """Whole-buffer host filter of ``mode`` (Shuffle.SHUFFLE or
    Shuffle.BITSHUFFLE), as tpu_blosc/device.py:885-890 applies it to
    ragged tails."""
    return (bit_shuffle if mode == Shuffle.BITSHUFFLE else shuffle_bytes)(src, type_size)


def unfilter_bytes(src, type_size: int, mode: int) -> np.ndarray:
    """Inverse of filter_bytes (≙ tpu_blosc/device.py:879-882)."""
    return (bit_unshuffle if mode == Shuffle.BITSHUFFLE else unshuffle_bytes)(src, type_size)


def shuffle_buffer(data: bytearray | np.ndarray, type_size: int, mode: Shuffle) -> None:
    """Filter a bytearray or a uint8 array in place; a mode other than
    Shuffle.SHUFFLE or Shuffle.BITSHUFFLE leaves it as it is
    (≙ tpu_blosc/filters/__init__.py:203-208)."""
    if mode not in (Shuffle.SHUFFLE, Shuffle.BITSHUFFLE):
        return
    result = filter_bytes(bytes(data), type_size, mode)
    data[:] = result.tobytes() if isinstance(data, bytearray) else result


def unshuffle_buffer(data: bytearray | np.ndarray, type_size: int, mode: Shuffle) -> None:
    """Inverse of shuffle_buffer (≙ tpu_blosc/filters/__init__.py:211-216)."""
    if mode not in (Shuffle.SHUFFLE, Shuffle.BITSHUFFLE):
        return
    result = unfilter_bytes(bytes(data), type_size, mode)
    data[:] = result.tobytes() if isinstance(data, bytearray) else result


def filter_blocks(blocks: torch.Tensor, type_size: int, mode: int,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """The block pair's filter of ``mode`` (Shuffle.SHUFFLE or
    Shuffle.BITSHUFFLE) over each row of (nb, bs) ``blocks``."""
    fn = bit_shuffle_blocks if mode == Shuffle.BITSHUFFLE else shuffle_blocks
    return fn(blocks, type_size, out=out)


def unfilter_blocks(blocks: torch.Tensor, type_size: int, mode: int,
                    keep_raw: torch.Tensor | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of filter_blocks; ``keep_raw`` rows are copied verbatim."""
    fn = bit_unshuffle_blocks if mode == Shuffle.BITSHUFFLE else unshuffle_blocks
    return fn(blocks, type_size, keep_raw=keep_raw, out=out)


def target_device(device, caller: str) -> torch.device:
    """``device`` as a torch.device; None means the current CUDA device,
    and raises RuntimeError when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller}: no CUDA device is available; pass device='cpu' "
            "to run on the host"
        )
    return torch.device("cuda", torch.cuda.current_device())


def load_target(device, caller: str) -> torch.device | None:
    """The ``device=`` argument of the loaders: False or None for a CPU
    result (None returned), True for the current CUDA device, else the
    device it names."""
    if device is False or device is None:
        return None
    return target_device(None if device is True else device, caller)
