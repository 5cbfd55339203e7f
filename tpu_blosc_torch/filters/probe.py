"""Compressibility probe: run fraction and mean byte over 1 MiB tiles.

Counterpart: ``tpu_blosc/filters/pallas_kernels.py``: the kernels
``_runs_kernel`` and ``_bytesum_kernel`` behind ``_probe_runs`` and
``_probe_bytesum`` (:80-126), ``probe_ready`` (:129-158) and
``stream_probe`` (:161-195).  It powers ``api.suggest_codec`` on a card.

A buffer is laid out as a (rows, 512) int32 tensor of little-endian
words, zero-padded to 1, 2 or 4 tiles of 512 rows (1 MiB each); a buffer
past 4 MiB is sampled by eight evenly spaced windows.  Per tile the probe
counts the equal adjacent byte pairs inside each word (3 of every 4
pairs) and sums the bytes; ``stream_probe`` takes out what the zero
padding added.

The route follows the tensor: a CPU tensor takes ``probe_tiles_plain``,
a CUDA tensor launches ``csrc/probe.cu`` (one pass for both sums) or
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels, target_device

LANES = kernels.PROBE_LANES
TILE_ROWS = kernels.PROBE_TILE_ROWS
TILE_BYTES = TILE_ROWS * LANES * 4


def probe_tiles_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: (tiles, 2) int32 of (runs, byte sum)
    per whole tile of ``words``."""
    tiles = words.shape[0] // TILE_ROWS
    b = words[: tiles * TILE_ROWS].reshape(tiles, TILE_ROWS * LANES)
    b = b.view(torch.uint8).view(tiles, -1, 4)
    runs = (b[..., :3] == b[..., 1:]).sum(dim=(1, 2), dtype=torch.int32)
    total = b.sum(dim=(1, 2), dtype=torch.int32)
    return torch.stack([runs, total], dim=1)


def probe_tiles(words: torch.Tensor) -> torch.Tensor:
    """Per-tile (runs, byte sum) of a (rows, 512) int32 tensor; rows past
    the last whole tile are not read (≙ _probe_runs and _probe_bytesum)."""
    if words.device.type == "cuda":
        return kernels.probe_tiles(words)
    kernels.check_words(words)
    if words.device.type != "cpu":
        raise ValueError(f"no probe route for device {words.device}")
    return probe_tiles_plain(words)


def probe_ready(data, device=None) -> torch.Tensor:
    """A byte buffer as the probe's (rows, 512) int32 tensor on
    ``device`` (None: the current CUDA device), zero-padded and snapped to
    1, 2 or 4 tiles; past 4 MiB, eight evenly spaced windows spanning the
    buffer."""
    target = target_device(device, "probe_ready")
    host = np.frombuffer(
        data.tobytes() if isinstance(data, np.ndarray) else bytes(data),
        dtype=np.uint8,
    )
    tiles_needed = -(-max(host.size, 1) // TILE_BYTES)
    tiles = 1 if tiles_needed <= 1 else 2 if tiles_needed <= 2 else 4
    budget = tiles * TILE_BYTES
    if host.size > budget:
        nwin = 8
        win = budget // nwin
        step = (host.size - win) // (nwin - 1)
        host = np.concatenate([host[k * step : k * step + win] for k in range(nwin)])
    buf = np.zeros(budget, dtype=np.uint8)
    buf[: host.size] = host
    return torch.from_numpy(buf.view(np.int32).reshape(-1, LANES)).to(target)


def stream_probe(data, device=None) -> dict:
    """{"run_fraction", "mean_byte", "n"} of a buffer, probed on
    ``device`` (see probe_ready), or of a (rows, 512) int32 tensor taken
    as it is, on its own device."""
    if isinstance(data, torch.Tensor):
        kernels.check_words(data)
        words = data
        n = words.shape[0] * LANES * 4
    else:
        n = len(data) if not isinstance(data, np.ndarray) else data.nbytes
        words = probe_ready(data, device)
    sums = probe_tiles(words).cpu().numpy().astype(np.int64).sum(axis=0)
    runs, bsum = int(sums[0]), int(sums[1])
    total = words.shape[0] * LANES * 4
    n = min(n, total)  # probe_ready samples at most 4 tiles
    # the zero padding adds 3 equal pairs per padded word and 0 to the sum
    pad_words = (total - n) // 4
    runs = max(runs - 3 * pad_words, 0)
    pairs = max(3 * (n // 4), 1)
    return {
        "run_fraction": min(runs / pairs, 1.0),
        "mean_byte": bsum / max(n, 1),
        "n": n,
    }
