"""Byte shuffle of whole blocks: (nb, bs) uint8 tensors, any type size.

Counterpart: ``tpu_blosc/filters/batched.py:492-527`` (``shuffle_batch`` /
``unshuffle_batch``), which on the TPU picks among the Pallas byte-plane
kernels (ts 2 and 4), the XLA SWAR word kernels (ts 8 and 16) and the u8
bodies.  Here one CUDA kernel pair (filters/kernels.py) serves every
``type_size >= 2`` with ``bs % type_size == 0``.

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
