"""Worker for the windowed sharded save test (not a test module).

    python tests/torch_ckpt_window_worker.py <rank> <world> <store_file> <out_dir>

One of ``world`` processes over Gloo on the CPU.  Each places the leaves
of ``tree(world)`` over a one-dimensional mesh as DTensors and writes,
with ``save_pytree_sharded``, its local shards through the pipeline that
CUDA leaves take (CPU tensors handed to it):

    win.p{rank}.tpbs    with windows of ``WINDOW_BYTES``
    lone.p{rank}.tpbs   with no window (every leaf alone)
    win.r{rank}.json    ``checkpoint.saved`` after the windowed save
    fail.r{rank}.json   a save whose second window's native call raises:
                        the error, the threads left, the file closed
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import threading
import time

import numpy as np
import torch

BLOCK = 4096
# two leaves of 3 full blocks a window (24 KiB of 32 KiB)
WINDOW_BYTES = 32 * 1024


def tree(world: int) -> dict:
    """Six sharded leaves whose local shards are 3 full blocks and a
    ragged tail of 1,000 bytes, fp32 and then bf16 (three windows a
    rank), and a replicated one that process 0 alone writes."""
    rng = np.random.default_rng(5)
    rows = world * (3 * BLOCK + 1000)

    def leaf(dtype):
        return torch.from_numpy(rng.normal(size=(rows // dtype.itemsize,)).astype(np.float32)
                                * 0.01).to(dtype)

    leaves = {f"f{i}": leaf(torch.float32) for i in range(4)}
    leaves.update({f"h{i}": leaf(torch.bfloat16) for i in range(2)})
    return {"sharded": leaves, "bias": torch.ones(3000), "step": 7}


def main() -> None:
    rank, world, store_file, out_dir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    )
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, init_device_mesh

    from torch_ckpt_worker import place
    from tpu_blosc_torch import checkpoint, device
    from tpu_blosc_torch.dist import initialize_distributed
    from tpu_blosc_torch.options import Options
    from tpu_blosc_torch.stream import StreamWriter

    initialize_distributed(
        "cpu", store=dist.FileStore(store_file, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    try:
        mesh = init_device_mesh("cpu", (world,))
        state = tree(world)
        state["sharded"] = {k: place(v, mesh, [Shard(0)]) for k, v in state["sharded"].items()}
        checkpoint._on_cuda = lambda leaf: isinstance(leaf, torch.Tensor)
        opts = Options(block_size=BLOCK)

        checkpoint._SAVE_WINDOW_BYTES = WINDOW_BYTES
        checkpoint.reset_saved()
        checkpoint.save_pytree_sharded(os.path.join(out_dir, "win"), state, opts)
        with open(os.path.join(out_dir, f"win.r{rank}.json"), "w") as f:
            json.dump(checkpoint.saved, f)
        checkpoint._SAVE_WINDOW_BYTES = 0
        checkpoint.save_pytree_sharded(os.path.join(out_dir, "lone"), state, opts)

        checkpoint._SAVE_WINDOW_BYTES = WINDOW_BYTES
        opened = []

        class Recorded(StreamWriter):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                opened.append(self)

        checkpoint.StreamWriter = Recorded
        real, calls = device._native_slots, []

        def failing(*args, **kwargs):
            calls.append(1)
            if len(calls) == 3:  # the second window's full blocks
                raise RuntimeError("native compress_blocks failed (-2)")
            return real(*args, **kwargs)

        device._native_slots = failing
        before = set(threading.enumerate())
        raised = ""
        try:
            checkpoint.save_pytree_sharded(os.path.join(out_dir, "fail"), state, opts)
        except RuntimeError as exc:
            raised = str(exc)
        deadline = time.monotonic() + 10
        while set(threading.enumerate()) - before and time.monotonic() < deadline:
            time.sleep(0.01)
        with open(os.path.join(out_dir, f"fail.r{rank}.json"), "w") as f:
            json.dump({"raised": raised,
                       "threads": [t.name for t in set(threading.enumerate()) - before],
                       "closed": [w._closed and w._f.closed for w in opened]}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
