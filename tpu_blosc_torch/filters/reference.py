"""Plain whole-buffer byte and bit shuffle on tensors.

Counterpart: ``tpu_blosc/filters/reference.py:40-66``.  Byte shuffle is
the column transpose ``dst[j*num_elements + i] = src[i*type_size + j]``;
the ``n % type_size`` bytes past the last whole element are copied
verbatim, and buffers shorter than one element (or ``type_size <= 1``)
come back unchanged.  Bit shuffle transposes the bits of each group of 8
elements (``batched.bit_shuffle_blocks_plain``); the bytes past the last
whole group are copied verbatim.  The tests hold the batched filters and
the native host shuffle to these functions, and the route without a
native build filters host buffers with them.
"""

from __future__ import annotations

import torch

from .batched import bit_shuffle_blocks_plain, bit_unshuffle_blocks_plain


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


def _bit_body(src: torch.Tensor, type_size: int, plain) -> torch.Tensor:
    a = _flat_u8(src)
    body = a.numel() // (8 * type_size) * (8 * type_size) if type_size > 1 else 0
    if body == 0:
        return a.clone()
    return torch.cat([plain(a[:body].view(1, body), type_size).view(-1), a[body:]])


def bit_shuffle(src: torch.Tensor, type_size: int) -> torch.Tensor:
    """Bit shuffle of a whole buffer in groups of 8 elements."""
    return _bit_body(src, type_size, bit_shuffle_blocks_plain)


def bit_unshuffle(src: torch.Tensor, type_size: int) -> torch.Tensor:
    """Inverse of bit_shuffle."""
    return _bit_body(src, type_size, bit_unshuffle_blocks_plain)
