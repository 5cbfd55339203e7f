#!/usr/bin/env python3
"""Dry run of the port's sharded pipeline over n ranks.

    python3 dryrun_torch.py [n] [--device cuda|cpu]

Starts ``n`` processes (default 2), one rank each.  By default they run on
the CUDA devices: rank r on ``cuda:r`` over NCCL where the host has ``n``
cards, else the ranks share the cards it has (rank r on ``cuda:r % cards``)
and gather over Gloo, their operands staged through the host; with no card
it fails.  ``--device cpu`` runs the ranks on the CPU over Gloo.  Every rank:

1. runs the rank step (filter, byte histogram, per-block diff counts) on
   its two of ``2n`` blocks of 1024 bytes, with the all_reduce and the
   all_gather, and holds the rows to a NumPy byte shuffle, the histogram to
   the byte count and the diff counts to NumPy's;
2. compresses ``4n`` MiB plus a 123-byte tail with
   ``compress_chunked_mesh(..., return_stats=True)`` and checks that the
   frame is ``chunk.compress_chunked``'s, that it decodes to the data
   through ``decompress_chunked_mesh``, and that the histogram sums to
   ``sample_bytes``.

Rank 0 prints one "ok" line.  The counterpart of ``dryrun_multichip`` in
``__graft_entry__.py``; it imports no jax.
"""

from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def run_rank(rank: int, world: int, store_file: str, device_kind: str) -> None:
    import torch
    import torch.distributed as dist

    from tpu_blosc_torch import chunk
    from tpu_blosc_torch.dist import mesh
    from tpu_blosc_torch.format import Shuffle
    from tpu_blosc_torch.options import Options

    device = comm = torch.device("cpu")
    if device_kind == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device("cuda", rank % cards)
        torch.cuda.set_device(device)
        # NCCL takes one rank a card; ranks that share one gather over Gloo
        comm = device if cards >= world else comm
    mesh.initialize_distributed(
        comm, store=dist.FileStore(store_file, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    try:
        type_size, bs, nb = 4, 1024, 2 * world
        blocks = np.arange(nb * bs, dtype=np.uint8).reshape(nb, bs)
        rows = blocks[2 * rank : 2 * rank + 2]
        y, hist, diffs = mesh._mesh_filter_step(
            torch.from_numpy(rows).to(device), type_size, Shuffle.SHUFFLE, None)
        want = blocks.reshape(nb, bs // type_size, type_size).transpose(0, 2, 1).reshape(nb, bs)
        if not np.array_equal(y.cpu().numpy(), want[2 * rank : 2 * rank + 2]):
            raise RuntimeError("the sharded filter diverged from the NumPy shuffle")
        if int(hist.sum()) != nb * bs or not np.array_equal(
                diffs, (want[:, 1:] != want[:, :-1]).sum(axis=1)):
            raise RuntimeError("the step's collectives gave wrong statistics")

        rng = np.random.default_rng(42)
        big_bs, nb_big = 1 << 20, 4 * world
        payload_n = nb_big * big_bs + 123
        base = np.arange(payload_n // 4, dtype=np.float32).view(np.uint8)
        data = base.tobytes() + rng.integers(0, 256, payload_n - base.size, np.uint8).tobytes()
        opts = Options(block_size=big_bs, type_size=type_size)
        t0 = time.perf_counter()
        frame, stats = mesh.compress_chunked_mesh(data, opts, device=device, return_stats=True)
        t_mesh = time.perf_counter() - t0
        if frame != chunk.compress_chunked(data, opts.clamped()):
            raise RuntimeError("the mesh frame diverged from the single-process frame")
        t0 = time.perf_counter()
        if mesh.decompress_chunked_mesh(frame, device=device) != data:
            raise RuntimeError("the mesh frame did not decode to the data")
        t_dec = time.perf_counter() - t0
        if int(stats.histogram.sum()) != stats.sample_bytes:
            raise RuntimeError("the histogram does not cover sample_bytes")
        dist.barrier()
        if rank == 0:
            print(
                f"dryrun_torch ok: {world} ranks on {device_kind} over {dist.get_backend()}"
                + (f" ({torch.cuda.device_count()} card(s))" if device_kind == "cuda" else "")
                + "; "
                f"rank step verified ({nb} blocks x {bs} B, all_reduce + all_gather); "
                f"end-to-end at {payload_n / 2**20:.0f} MiB ({nb_big} x 1 MiB blocks, "
                f"{nb_big // world} per rank): frame == single-process bytes, roundtrip ok, "
                f"compress {t_mesh:.2f}s decompress {t_dec:.2f}s"
            )
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device_kind: str = "cuda", timeout: float = 300.0) -> None:
    """Start the ``n`` ranks, wait, and raise RuntimeError if one fails or
    outlasts ``timeout`` seconds (all are killed then), or if
    ``device_kind`` is "cuda" and there is no CUDA device."""
    if device_kind == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to run "
                               "the ranks on the CPU")
    with tempfile.TemporaryDirectory(prefix="dryrun_torch_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            subprocess.Popen([sys.executable, os.path.abspath(__file__), str(n), "--device",
                              device_kind, "--rank", str(r), "--store", store])
            for r in range(n)
        ]
        try:
            deadline = time.monotonic() + timeout
            for r, proc in enumerate(procs):
                try:
                    rc = proc.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"rank {r} of {n} timed out") from None
                if rc != 0:
                    raise RuntimeError(f"rank {r} of {n} exited with code {rc}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int, nargs="?", default=2, help="ranks to start")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the ranks run (default: the CUDA devices)")
    parser.add_argument("--rank", type=int, help="(a rank's own process)")
    parser.add_argument("--store", help="(a rank's own process) the FileStore's path")
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.rank is None:
        dryrun_multichip(args.n, args.device)
    else:
        run_rank(args.rank, args.n, args.store, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
