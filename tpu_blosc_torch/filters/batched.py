"""Byte and bit shuffle of whole blocks: (nb, bs) uint8 tensors.

Counterpart: ``tpu_blosc/filters/batched.py:492-550`` (``shuffle_batch``
/ ``unshuffle_batch``, ``bit_shuffle_batch`` / ``bit_unshuffle_batch``),
which on the TPU picks among the Pallas byte-plane kernels (ts 2 and 4),
the XLA SWAR word kernels and the u8 bodies.  Here one CUDA kernel pair
(filters/kernels.py) serves every ``type_size >= 2`` with ``bs %
type_size == 0`` for the byte shuffle, and another every ``type_size >=
2`` with ``bs % (8 * type_size) == 0`` for the bit shuffle.

The route follows the tensor: a CPU tensor takes the plain PyTorch
version below, a CUDA tensor launches the kernel or raises.  Nothing
sends a CUDA tensor to the plain version.
"""

from __future__ import annotations

import torch

from . import kernels


def shuffle_blocks_plain(blocks: torch.Tensor, type_size: int) -> torch.Tensor:
    """Plain version of the shuffle kernel: row i of each block's
    (bs/ts, ts) byte matrix becomes column i."""
    nb, bs = blocks.shape
    return blocks.view(nb, bs // type_size, type_size).transpose(1, 2).contiguous().view(nb, bs)


def unshuffle_blocks_plain(blocks: torch.Tensor, type_size: int,
                           keep_raw: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the unshuffle kernel; ``keep_raw`` rows pass
    through untouched."""
    nb, bs = blocks.shape
    out = blocks.view(nb, type_size, bs // type_size).transpose(1, 2).contiguous().view(nb, bs)
    if keep_raw is not None:
        out = torch.where(keep_raw[:, None], blocks, out)
    return out


def _bit_transpose8(planes: torch.Tensor) -> torch.Tensor:
    """MSB-first 8x8 bit transpose over the last axis of a (..., 8) uint8
    tensor (≙ tpu_blosc/filters/jaxops.py:54-99): out[..., o] bit 7-i is
    in[..., i] bit 7-o.  The butterfly runs on int64 words that hold 32
    bits, masked at every step: torch has no full uint32 arithmetic."""
    p = planes.to(torch.int64)
    x = (p[..., 0] << 24) | (p[..., 1] << 16) | (p[..., 2] << 8) | p[..., 3]
    y = (p[..., 4] << 24) | (p[..., 5] << 16) | (p[..., 6] << 8) | p[..., 7]
    t = (x ^ (x >> 7)) & 0x00AA00AA
    x = x ^ t ^ (t << 7)
    t = (y ^ (y >> 7)) & 0x00AA00AA
    y = y ^ t ^ (t << 7)
    t = (x ^ (x >> 14)) & 0x0000CCCC
    x = x ^ t ^ (t << 14)
    t = (y ^ (y >> 14)) & 0x0000CCCC
    y = y ^ t ^ (t << 14)
    t = (x & 0xF0F0F0F0) | ((y >> 4) & 0x0F0F0F0F)
    y = ((x << 4) & 0xF0F0F0F0) | (y & 0x0F0F0F0F)
    x = t
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=planes.device)
    out = torch.cat([x[..., None] >> shifts, y[..., None] >> shifts], dim=-1)
    return (out & 0xFF).to(torch.uint8)


def bit_shuffle_blocks_plain(blocks: torch.Tensor, type_size: int) -> torch.Tensor:
    """Plain version of the bit-shuffle kernel: per group of 8 elements,
    byte position j's 8 bytes bit-transposed to bytes 8j..8j+7
    (≙ _bit_shuffle_batch_dev)."""
    nb, bs = blocks.shape
    groups = blocks.view(nb, bs // (8 * type_size), 8, type_size)
    return _bit_transpose8(groups.transpose(2, 3)).reshape(nb, bs)


def bit_unshuffle_blocks_plain(blocks: torch.Tensor, type_size: int,
                               keep_raw: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the bit-unshuffle kernel; ``keep_raw`` rows pass
    through untouched (≙ _bit_unshuffle_batch_dev)."""
    nb, bs = blocks.shape
    planes = blocks.view(nb, bs // (8 * type_size), type_size, 8)
    out = _bit_transpose8(planes).transpose(2, 3).reshape(nb, bs)
    if keep_raw is not None:
        out = torch.where(keep_raw[:, None], blocks, out)
    return out


def _route(blocks: torch.Tensor) -> str:
    if blocks.device.type in ("cpu", "cuda"):
        return blocks.device.type
    raise ValueError(f"no byte-shuffle route for device {blocks.device}")


def _into(result: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    if out is None:
        return result
    out.copy_(result)
    return out


def shuffle_blocks(blocks: torch.Tensor, type_size: int,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Byte-shuffle each row of ``blocks`` (≙ shuffle_batch); the result
    goes to ``out`` when given."""
    kernels.check_blocks(blocks, type_size)
    if _route(blocks) == "cuda":
        return kernels.shuffle_blocks(blocks, type_size, out=out)
    return _into(shuffle_blocks_plain(blocks, type_size), out)


def unshuffle_blocks(blocks: torch.Tensor, type_size: int,
                     keep_raw: torch.Tensor | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of shuffle_blocks (≙ unshuffle_batch).  Rows where the
    (nb,) bool tensor ``keep_raw`` is True are copied verbatim: those
    blocks were stored raw in the frame."""
    kernels.check_blocks(blocks, type_size)
    if _route(blocks) == "cuda":
        return kernels.unshuffle_blocks(blocks, type_size, keep_raw=keep_raw, out=out)
    return _into(unshuffle_blocks_plain(blocks, type_size, keep_raw), out)


def bit_shuffle_blocks(blocks: torch.Tensor, type_size: int,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Bit-shuffle each row of ``blocks`` (≙ bit_shuffle_batch); ``bs``
    must be a multiple of ``8 * type_size``.  The result goes to ``out``
    when given."""
    kernels.check_bit_blocks(blocks, type_size)
    if _route(blocks) == "cuda":
        return kernels.bit_shuffle_blocks(blocks, type_size, out=out)
    return _into(bit_shuffle_blocks_plain(blocks, type_size), out)


def bit_unshuffle_blocks(blocks: torch.Tensor, type_size: int,
                         keep_raw: torch.Tensor | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of bit_shuffle_blocks (≙ bit_unshuffle_batch); rows where
    the (nb,) bool tensor ``keep_raw`` is True are copied verbatim."""
    kernels.check_bit_blocks(blocks, type_size)
    if _route(blocks) == "cuda":
        return kernels.bit_unshuffle_blocks(blocks, type_size, keep_raw=keep_raw, out=out)
    return _into(bit_unshuffle_blocks_plain(blocks, type_size, keep_raw), out)
