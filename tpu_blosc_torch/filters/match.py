"""The literal mask of the match strategy: one nibble per 4 bytes.

Counterpart: ``tpu_blosc/filters/pallas_kernels.py:463-497``
(``match_select_open_nibble``), the fused Pallas form of the select,
opening and bit-pack steps of ``tpu_blosc/device.py:417-432``
(``_device_match_core``, with ``_open_mask`` :660-687).

For each row r of ``segs`` (nseg, seg) with offset d = ``row_d[r]``:
eq[p] = x[p] == x[p-d] for d <= p < seg - tail; an opening by T keeps
only equality runs of at least T bytes (erosion, then dilation); every
other byte is a literal.  Byte j of the (nseg, seg/4) result holds the
literal bits of bytes 4j..4j+3, bit t for byte 4j+t.  A row with d < 1
is all literal.

The route follows the tensor: a CPU tensor takes the plain PyTorch
version below, a CUDA tensor launches ``csrc/match.cu`` or raises.
"""

from __future__ import annotations

import torch

from . import kernels

# the JAX package's constants (tpu_blosc/device.py:223, :227)
MATCH_T = 8
ROW_TAIL_LITERALS = 16


def match_nibble_plain(segs: torch.Tensor, row_d: torch.Tensor,
                       tail: int = ROW_TAIL_LITERALS, T: int = MATCH_T) -> torch.Tensor:
    """Plain version of the kernel: the select of each row's eq, the
    opening of ``_open_mask`` and the nibble pack, as torch ops."""
    nseg, seg = segs.shape
    col = torch.arange(seg, device=segs.device)
    d = row_d.to(torch.int64)[:, None]
    src = (col - d).clamp(min=0)
    eq = (segs == torch.gather(segs, 1, src)) & (col >= d) & (d >= 1)
    eq &= col < seg - tail
    # erosion: er[p] = AND eq[p .. p+T-1], for p <= seg - T
    er = eq[:, : seg - T + 1].clone()
    for s in range(1, T):
        er &= eq[:, s : seg - T + 1 + s]
    # dilation: match[q] = OR er[q-T+1 .. q]
    match = torch.zeros_like(eq)
    for s in range(T):
        match[:, s : s + seg - T + 1] |= er
    lit = (~match).view(nseg, seg // 4, 4).to(torch.uint8)
    return lit[..., 0] | (lit[..., 1] << 1) | (lit[..., 2] << 2) | (lit[..., 3] << 3)


def match_nibble(segs: torch.Tensor, row_d: torch.Tensor,
                 tail: int = ROW_TAIL_LITERALS, T: int = MATCH_T) -> torch.Tensor:
    """The literal-mask nibbles of ``segs`` at offsets ``row_d``
    (≙ match_select_open_nibble, with d given per row)."""
    if segs.device.type == "cuda":
        return kernels.match_nibble(segs, row_d, tail, T)
    kernels.check_match_args(segs, row_d, tail, T)
    if segs.device.type != "cpu":
        raise ValueError(f"no match-mask route for device {segs.device}")
    return match_nibble_plain(segs, row_d, tail, T)
