"""A scientific float signal with one block of random bytes, from the seed.

``amplitude * sin(t)`` over ``cycles`` periods, plus normal noise of
standard deviation ``noise_sd``, as ``chip_smoke.py`` make_cases builds
path B (:503-507), but made on the card.  One whole block of
``block_bytes`` (which the seed picks) is overwritten with random bytes,
which no codec shrinks: the frame stores it raw.  Every seed gives the same
sizes and one such block.
"""

from __future__ import annotations

import math

import torch


def make(nbytes: int, dtype: torch.dtype, seed: int, device: torch.device,
         params: dict) -> torch.Tensor:
    n = nbytes // dtype.itemsize
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    t = torch.linspace(0.0, 2 * math.pi * params["cycles"], n, dtype=dtype, device=device)
    x = t.sin_().mul_(params["amplitude"])
    x.add_(torch.randn(n, dtype=dtype, device=device, generator=g), alpha=params["noise_sd"])
    block = params["block_bytes"]
    full = nbytes // block
    if full:
        at = int(torch.randint(0, full, (1,), generator=g, device=device)) * block
        x.view(torch.uint8)[at : at + block] = torch.randint(
            0, 256, (block,), dtype=torch.uint8, generator=g, device=device)
    return x
