"""Worker for the port's sharded checkpoint tests (not a test module).

    python tests/torch_ckpt_worker.py <rank> <world> <store_file> <out_dir>

One of ``world`` processes over Gloo on the CPU.  Each builds every tree
of ``trees(world)`` (the full tensors from fixed seeds, the same in every
process and in the tests), places its sharded leaves over a device mesh
as DTensors, and writes its file of ``{out_dir}/{case}.p{rank}.tpbs``
with ``save_pytree_sharded``.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def trees(world: int) -> dict:
    """case -> (mesh shape, tree, {key: placements as ("S", dim) / "R" per
    mesh dimension}, save_pytree_sharded keywords).  A leaf with
    placements becomes a DTensor over the mesh; the others stay as they
    are (replicated: process 0 writes them)."""
    rng = np.random.default_rng(11)

    def ref() -> dict:
        w = torch.arange(world * 4 * 1000, dtype=torch.float32).reshape(world * 4, 1000)
        return {"w": w, "bias": np.ones(7, np.float32), "step": 42}

    out = {
        # the tree tests/ckpt_worker.py writes with the JAX package
        "ref": ((world,), ref(), {"w": [("S", 0)]}, {}),
        "checksum_zstd": ((world,), ref(), {"w": [("S", 0)]},
                          {"checksum": True, "opts": dict(codec=5, level=3)}),
        "dtypes": ((world,), {
            "bf16": _bf16(rng.normal(size=(world * 6, 40)) * 0.02),
            "i16": torch.from_numpy(rng.integers(-3000, 3000, (8, 4 * world), dtype=np.int16)),
            "plain": {"b": _bf16(rng.normal(size=33)), "none": None, "name": "run-7"},
            "whole": torch.from_numpy(rng.random((5, 3))),
        }, {"bf16": [("S", 0)], "i16": [("S", 1)], "whole": ["R"]}, {}),
        # 10 rows over the ranks (4, 4, 2 at three); world - 1 rows, so the
        # last rank's shard is empty; a leaf with no element at all
        "uneven": ((world,), {
            "ten": torch.from_numpy(rng.random((10, 7)).astype(np.float32)),
            "short": [torch.arange((world - 1) * 5, dtype=torch.int32).reshape(world - 1, 5)],
            "none": torch.empty((0, 4), dtype=torch.float32),
            "lr": 1e-3,
        }, {"ten": [("S", 0)], "short/0": [("S", 0)], "none": [("S", 0)]}, {}),
    }
    if world == 4:
        out["mesh2d"] = ((2, 2), {
            "a": torch.from_numpy(rng.random((6, 5)).astype(np.float32)),
            "b": torch.from_numpy(rng.integers(0, 99, (4, 6), dtype=np.int64)),
            "c": _bf16(rng.normal(size=(3, 8))),
            "d": torch.arange(9, dtype=torch.float64).reshape(9, 1),
        }, {"a": ["R", ("S", 0)], "b": [("S", 0), ("S", 1)], "c": [("S", 1), "R"],
            "d": [("S", 0), ("S", 0)]}, {})
    return out


def place(full: torch.Tensor, mesh, placements):
    """``full`` as a DTensor over ``mesh``, with no communication: this
    rank's shard is cut out here with ``torch.chunk``, mesh dimension by
    mesh dimension (a rank past the last piece holds an empty shard)."""
    from torch.distributed.tensor import DTensor, Shard

    coord = mesh.get_coordinate()
    local = full
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            pieces = torch.chunk(local, mesh.size(m), dim=p.dim)
            local = pieces[coord[m]] if coord[m] < len(pieces) else local.narrow(p.dim, 0, 0)
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def main() -> None:
    rank, world, store_file, out_dir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    )
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, init_device_mesh

    from tpu_blosc_torch import checkpoint
    from tpu_blosc_torch.dist import initialize_distributed
    from tpu_blosc_torch.options import Options

    initialize_distributed(
        "cpu", store=dist.FileStore(store_file, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    try:
        for case, (mesh_shape, tree, sharded, kw) in trees(world).items():
            mesh = init_device_mesh("cpu", mesh_shape)
            for key, placements in sharded.items():
                node = tree
                *parents, last = key.split("/")
                for seg in parents:
                    node = node[seg]
                last = int(last) if isinstance(node, list) else last
                node[last] = place(node[last], mesh, [
                    Replicate() if p == "R" else Shard(p[1]) for p in placements])
            kw = dict(kw)
            if "opts" in kw:
                kw["opts"] = Options(**kw["opts"])
            checkpoint.save_pytree_sharded(os.path.join(out_dir, case), tree, **kw)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
