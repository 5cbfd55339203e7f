"""The device half of the match strategy: each row's best offset (the
count phase), and its literal mask, one nibble per 4 bytes.

Counterparts: the count phase of ``tpu_blosc/device.py:303-335`` and
:403-415 (the XLA ``fori_loop`` of ``_device_match_core_fused`` and
``_device_match_core``), and ``tpu_blosc/filters/pallas_kernels.py:463-497``
(``match_select_open_nibble``), the fused Pallas form of the select,
opening and bit-pack steps of ``device.py:417-432`` (with ``_open_mask``
:660-687).

Count: for each row r of ``segs`` (nseg, seg) and each candidate offset
d, c = the number of p >= d with x[p] == x[p-d]; the row's best is the
index of the first largest c, 0 where every c is 0.

Mask: for each row r with offset d = ``row_d[r]``: eq[p] = x[p] ==
x[p-d] for d <= p < seg - tail; an opening by T keeps only equality runs
of at least T bytes (erosion, then dilation); every other byte is a
literal.  Byte j of the (nseg, seg/4) result holds the literal bits of
bytes 4j..4j+3, bit t for byte 4j+t.  A row with d < 1 is all literal.
``literal_mask`` gives the same mask as the strategy ships it: the
literal bits packed 8 to a byte, and each row's literal count (the XLA
popcount and nibble-pair pack of ``device.py:341-348``); on the card it is
the same kernel with those two outputs in place of the nibbles.

The route follows the tensor: a CPU tensor takes the plain PyTorch
versions below, a CUDA tensor launches the two kernels of
``csrc/match.cu`` or raises.
"""

from __future__ import annotations

import torch

from . import kernels

# the JAX package's constants (tpu_blosc/device.py:223, :227)
MATCH_T = 8
ROW_TAIL_LITERALS = 16


def count_best_plain(segs: torch.Tensor, offsets: tuple[int, ...]) -> torch.Tensor:
    """Plain version of the count kernel: one compare-and-sum pass over
    ``segs`` per offset, as the XLA loop does."""
    nseg = segs.shape[0]
    best_c = torch.zeros(nseg, dtype=torch.int32, device=segs.device)
    best_i = torch.zeros(nseg, dtype=torch.int64, device=segs.device)
    for i, d in enumerate(offsets):
        c = (segs[:, d:] == segs[:, :-d]).sum(dim=1, dtype=torch.int32)
        better = c > best_c
        best_c = torch.where(better, c, best_c)
        best_i = torch.where(better, i, best_i)
    return best_i


def count_best(segs: torch.Tensor, offsets: tuple[int, ...]) -> torch.Tensor:
    """Per row of ``segs`` (nseg, seg), the index into ``offsets`` of the
    offset d with the most p >= d where x[p] == x[p-d], as an int64
    tensor.  Ties go to the lowest index; a row with no equal bytes gets
    index 0."""
    if segs.device.type == "cuda":
        return kernels.match_count(segs, offsets)
    kernels.check_count_args(segs, offsets)
    if segs.device.type != "cpu":
        raise ValueError(f"no match-count route for device {segs.device}")
    return count_best_plain(segs, offsets)


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


def literal_mask_plain(segs: torch.Tensor, row_d: torch.Tensor,
                       tail: int = ROW_TAIL_LITERALS, T: int = MATCH_T):
    """Plain version of the kernel's packed form: the popcount and the
    nibble-pair pack of the plain nibbles, as torch ops."""
    nib = match_nibble_plain(segs, row_d, tail, T)
    ones = (nib & 1) + ((nib >> 1) & 1) + ((nib >> 2) & 1) + ((nib >> 3) & 1)
    return ones.sum(dim=1, dtype=torch.int32), nib[:, 0::2] | (nib[:, 1::2] << 4)


def literal_mask(segs: torch.Tensor, row_d: torch.Tensor,
                 tail: int = ROW_TAIL_LITERALS, T: int = MATCH_T):
    """(lit_counts, packed) of ``segs`` (seg % 8 == 0) at offsets
    ``row_d``: each row's literal count (int32), and (nseg, seg/8) bytes
    whose byte j holds bit i = byte 8j+i is literal."""
    if segs.device.type == "cuda":
        return kernels.match_mask(segs, row_d, tail, T)
    kernels.check_match_args(segs, row_d, tail, T)
    if segs.device.type != "cpu":
        raise ValueError(f"no match-mask route for device {segs.device}")
    return literal_mask_plain(segs, row_d, tail, T)
