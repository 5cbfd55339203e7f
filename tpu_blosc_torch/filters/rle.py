"""The device half of the rle strategy: each filtered segment's run
count, and the run records of chosen segments.

Counterparts: the count of ``_device_filter_seg_counts``
(``tpu_blosc/device.py:165-181``; the filter before it is
``filters.filter_blocks``) and ``_device_rows_rle`` (:184-207), two XLA
device programs.

A byte starts a run when it is a row's first byte or differs from the
byte before it in its row, so runs never join across a row edge.

Counts: for each row of ``segs`` (nseg, seg), 1 + the number of p >= 1
with x[p] != x[p-1].

Records: for the chosen rows, in the order given, every run's byte and
length.  The JAX program pads the row list to a power of two and the
records to a compile-time cap, and its caller slices the pad off by the
known counts; here nothing is padded: ``torch.nonzero`` returns the real
count, and the kernel gets each row's record base from the counts.

The route follows the tensor: a CPU tensor takes the plain PyTorch
versions below, a CUDA tensor launches the two kernels of ``csrc/rle.cu``
or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels


def seg_run_counts_plain(segs: torch.Tensor) -> torch.Tensor:
    """Plain version of the count kernel: one compare-and-sum pass."""
    return (segs[:, 1:] != segs[:, :-1]).sum(dim=1, dtype=torch.int32) + 1


def seg_run_counts(segs: torch.Tensor) -> torch.Tensor:
    """Per row of ``segs`` (nseg, seg), its number of runs, as an int32
    tensor."""
    if segs.device.type == "cuda":
        return kernels.seg_run_counts(segs)
    kernels.check_rle_segs(segs)
    if segs.device.type != "cpu":
        raise ValueError(f"no run-count route for device {segs.device}")
    return seg_run_counts_plain(segs)


def rows_rle_plain(segs: torch.Tensor, rows: torch.Tensor):
    """Plain version of the rows kernel: gather the rows, mark the
    starts, compact their indices; a run's length is the gap to the next
    start, the last one's to the end of the rows."""
    sub = segs.index_select(0, rows)
    k, seg = sub.shape
    starts = torch.ones((k, seg), dtype=torch.bool, device=segs.device)
    starts[:, 1:] = sub[:, 1:] != sub[:, :-1]
    idx = torch.nonzero(starts.view(-1)).view(-1)
    ends = torch.cat([idx[1:], idx.new_tensor([k * seg])])
    return sub.view(-1)[idx], (ends - idx).to(torch.int32)


def rows_rle(segs: torch.Tensor, rows: np.ndarray, counts: np.ndarray):
    """(vals, lens) of the rows ``rows`` of ``segs``, on segs' device:
    every run's byte (uint8) and length (int32), row after row in the
    order given.  ``counts[j]`` is the run count of row ``rows[j]``, as
    seg_run_counts gave it; records that disagree with the counts raise."""
    kernels.check_rle_segs(segs)
    rows = np.asarray(rows, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    if rows.ndim != 1 or counts.shape != rows.shape:
        raise ValueError("rows and counts must be 1-D and of one length")
    if rows.size and not (0 <= rows.min() and rows.max() < segs.shape[0]):
        raise ValueError(f"rows must lie in 0..{segs.shape[0] - 1}")
    n_runs = int(counts.sum())
    if segs.device.type == "cuda":
        # one upload: the rows, then each row's first record
        index = np.zeros(2 * rows.size + 1, dtype=np.int64)
        index[: rows.size] = rows
        np.cumsum(counts, out=index[rows.size + 1:])
        index = torch.from_numpy(index).to(segs.device)
        vals, lens, bad = kernels.rows_rle(segs, index[: rows.size], index[rows.size:], n_runs)
        agree = not int(bad)
    elif segs.device.type == "cpu":
        vals, lens = rows_rle_plain(segs, torch.from_numpy(rows))
        agree = vals.numel() == n_runs
    else:
        raise ValueError(f"no run-record route for device {segs.device}")
    if not agree:
        raise RuntimeError(f"the rows' runs disagree with their counts ({n_runs} in all)")
    return vals, lens
