"""The ramp of the go-blosc README's quick-start, its blocks permuted by the seed.

The published ramp is ``0, 1, 2, ...`` in the configuration's dtype.  The
seed picks where it starts: element i holds ``(i + offset) % n``, a
rotation of the same n values by a whole number of ``block_bytes``
blocks.  The codec compresses blocks one by one, so every seed gives it
the same work in another order; a tensor of one block is the same for
every seed.  A rotation by part of a block would move where a block's
values cross from one float exponent to the next, which changes the
frame's size and the codec's time.
"""

from __future__ import annotations

import torch


def make(nbytes: int, dtype: torch.dtype, seed: int, device: torch.device,
         params: dict) -> torch.Tensor:
    n = nbytes // dtype.itemsize
    block = params["block_bytes"] // dtype.itemsize
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    offset = int(torch.randint(0, max(1, n // block), (1,), generator=g, device=device)) * block
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx.add_(offset).remainder_(n).to(dtype)
