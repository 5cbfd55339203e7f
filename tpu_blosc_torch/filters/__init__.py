"""Shuffle filters of the port: host buffers and device blocks.

Counterpart: ``tpu_blosc/filters/__init__.py:35-176``.  The JAX package
probes its platform once at import and falls back from device to native
to NumPy.  The port needs no probe: a host buffer (bytes or ndarray) goes
through the native C++ shuffle, and a block tensor through
``batched.shuffle_blocks``, whose route follows the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..native import backend as _native
from .batched import shuffle_blocks, unshuffle_blocks

__all__ = [
    "backend_name",
    "bit_shuffle",
    "shuffle_blocks",
    "shuffle_bytes",
    "target_device",
    "unshuffle_blocks",
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
