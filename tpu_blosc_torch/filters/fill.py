"""The device half of the records decode: the filtered stream rebuilt
from literal records.

Counterpart: the scatter and the forward fill of ``_device_match_decode``
(``tpu_blosc/device.py:1280-1357``), an XLA device program; the unfilter
that ends that program is ``filters.unfilter_blocks``.

Rows are nseg segments of seg bytes.  Row r has one match offset d =
``row_d[r]`` and literal records: sorted, unique flat positions ``pos``
with their bytes ``vals``.  out[r, i] is the literal at i where there is
one, else out[r, i - d]; positions below d are literal in every stream an
encoder writes (one that is not reads 0, as from the JAX program's zeroed
grid).

The JAX program fills a two-byte grid once per offset present, with a
cummax of ``(index + 1) << 8 | byte`` keys, pads rows that d does not
divide, selects each row's fill, and pads the records with out-of-range
positions that its scatter drops.  Here a row takes its own offset only,
nothing is padded (torch's ``index_put_`` drops nothing), and neither
version carries keys: no index overflows however long the row.

The route follows the device: "cpu" takes the plain PyTorch version
below, a CUDA device launches the kernel of ``csrc/fill.cu`` or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels


def match_fill_plain(pos: torch.Tensor, vals: torch.Tensor, row_d: torch.Tensor,
                     nseg: int, seg: int) -> torch.Tensor:
    """Plain version of the fill kernel: scatter the bytes and each
    literal's position in its row; per offset present, a cummax of those
    positions (-1 where there is no literal) down the columns of the
    (ceil(seg / d), d) view gives every byte the position of the last
    literal at or before it in its column; gather."""
    flat = pos.to(torch.int64)
    grid = torch.zeros(nseg * seg, dtype=torch.uint8, device=pos.device)
    grid[flat] = vals
    src = torch.full((nseg * seg,), -1, dtype=torch.int32, device=pos.device)
    src[flat] = (flat % seg).to(torch.int32)
    grid, src = grid.view(nseg, seg), src.view(nseg, seg)
    out = torch.zeros_like(grid)
    for d in torch.unique(row_d).tolist():
        if d < 1:
            raise ValueError(f"offsets must be >= 1, got {d}")
        sel = torch.nonzero(row_d == d).view(-1)
        m = -(-seg // d)
        s = torch.nn.functional.pad(src[sel], (0, m * d - seg), value=-1)
        last = s.view(-1, m, d).cummax(dim=1).values.view(-1, m * d)[:, :seg]
        filled = torch.gather(grid[sel], 1, last.clamp(min=0).to(torch.int64))
        out[sel] = torch.where(last >= 0, filled, 0)
    return out


def match_fill(pos: np.ndarray, vals: np.ndarray, row_d: np.ndarray, nseg: int,
               seg: int, device) -> torch.Tensor:
    """The (nseg, seg) uint8 filtered stream on ``device`` from literal
    records on the host: ``pos`` sorted, unique, flat int32 positions,
    ``vals`` their bytes, ``row_d`` each row's offset (1 to
    kernels.FILL_MAX_D)."""
    device = torch.device(device)
    pos = np.ascontiguousarray(pos, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.uint8)
    row_d = np.ascontiguousarray(row_d, dtype=np.int32)
    if row_d.size and not (1 <= row_d.min() and row_d.max() <= kernels.FILL_MAX_D):
        raise ValueError(f"offsets must lie in 1..{kernels.FILL_MAX_D}")
    if pos.size and not (0 <= pos[0] and pos[-1] < nseg * seg):
        raise ValueError(f"positions must lie in 0..{nseg * seg - 1}")
    # row r's records are pos[row_first[r] : row_first[r + 1]]
    row_first = np.searchsorted(pos, np.arange(nseg + 1, dtype=np.int64) * seg).astype(np.int64)
    on_device = [torch.from_numpy(a).to(device) for a in (pos, vals, row_first, row_d)]
    if device.type == "cuda":
        return kernels.match_fill(*on_device, nseg, seg)
    kernels.check_fill_args(*on_device, nseg, seg)
    if device.type != "cpu":
        raise ValueError(f"no fill route for device {device}")
    pos_t, vals_t, _, row_d_t = on_device
    return match_fill_plain(pos_t, vals_t, row_d_t, nseg, seg)
