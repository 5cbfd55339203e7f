"""Plain whole-buffer byte shuffle on tensors: the oracle of the tests.

Counterpart: ``tpu_blosc/filters/reference.py:40-66``.  Byte shuffle is
the column transpose ``dst[j*num_elements + i] = src[i*type_size + j]``;
the ``n % type_size`` bytes past the last whole element are copied
verbatim, and buffers shorter than one element (or ``type_size <= 1``)
come back unchanged.  The tests hold the batched filters and the native
host shuffle to these functions.
"""

from __future__ import annotations

import torch


def _flat_u8(src: torch.Tensor) -> torch.Tensor:
    if src.dtype != torch.uint8:
        raise TypeError(f"expected a uint8 tensor, got {src.dtype}")
    return src.reshape(-1)


def shuffle_bytes(src: torch.Tensor, type_size: int) -> torch.Tensor:
    """Byte shuffle of a whole buffer (≙ shuffleBytes, shuffle.go:16-73)."""
    a = _flat_u8(src)
    n = a.numel()
    if type_size <= 1 or n < type_size:
        return a.clone()
    body = n // type_size * type_size
    head = a[:body].view(-1, type_size).t().reshape(-1)
    return torch.cat([head, a[body:]])


def unshuffle_bytes(src: torch.Tensor, type_size: int) -> torch.Tensor:
    """Inverse byte shuffle (≙ unshuffleBytes, shuffle.go:76-133)."""
    a = _flat_u8(src)
    n = a.numel()
    if type_size <= 1 or n < type_size:
        return a.clone()
    body = n // type_size * type_size
    head = a[:body].view(type_size, -1).t().reshape(-1)
    return torch.cat([head, a[body:]])
