"""Worker for the port's sharded-tensor tests (not a test module).

    python tests/torch_sharded_worker.py <rank> <world> <store_file> <out_dir>

One of ``world`` processes over Gloo on the CPU.  Each builds the full
tensor of every case of ``cases(world)`` (fixed seeds: the same in every
process and in tests/test_torch_sharded_arrays.py), cuts its own piece
with ``torch.chunk`` (tests/torch_ckpt_worker.py ``place``) into a
DTensor over the case's device mesh, runs it through every encoder that
takes a DTensor and the frame through every decoder that takes
``sharding=``, and writes what came out under ``out_dir``:

    {case}.r{rank}.frame         compress_array
    {case}.r{rank}.env           pack_array
    {case}.r{rank}.rec.tpbs      StreamWriter.write_array into its own stream
    {case}.save.r{rank}.tpbs     save_array (process 0 alone writes it)
    {case}.tree.r{rank}.tpbs     save_pytree of {"x": x, "b": ..., "step": 7}
    {case}.r{rank}.dec.npz       each decoder's local tensor as bytes
    {case}.r{rank}.dec.json      each decoder's type, placements, shapes, device
    {case}.r{rank}.dist          float32 cases: the bytes of this rank's piece
                                 of distribute_tensor (DTensor's own split)
"""

from __future__ import annotations

import datetime
import json
import os
import sys

import numpy as np

KIB = 1024

#: the decoders' labels: each takes the case's placements, "replicate" all
#: Replicate ones
DECODERS = ("decompress_array.device", "decompress_array.transfer",
            "decompress_array.records", "decompress_array.replicate", "unpack_array",
            "read_array", "iter_arrays", "load_array")


def cases(world: int) -> dict:
    """case -> (mesh shape, dtype name, full array (bfloat16 as its uint16
    bits), placements as ("S", dim) / "R" per mesh dimension, Options
    keywords, compress_array strategy)."""
    rng = np.random.default_rng(5)
    # a 256-element pattern with 1% noise, chip_smoke.py's match data, small
    rows = np.tile(rng.random(256).astype(np.float32), (world * 8, 32))
    rows[rng.random(rows.shape) < 0.01] += 0.01
    bf16 = (rng.normal(size=(64, world * 2048)).astype(np.float32) * 0.02)
    bf16_bits = (bf16.view(np.uint32) >> 16).astype(np.uint16)
    stairs = (np.arange((world - 1) * 65536) // 64).astype(np.int16).reshape(world - 1, 65536)
    c64 = (np.arange(40 * (world * 1000 + 3)) % 777
           + 1j * (np.arange(40 * (world * 1000 + 3)) // 13)).astype(np.complex64)
    out = {
        # even rows, the match strategy
        "f32_rows": ((world,), "float32", rows, [("S", 0)],
                     dict(block_size=64 * KIB), "match"),
        # columns, bit shuffle
        "bf16_cols": ((world,), "bfloat16", bf16_bits, [("S", 1)],
                      dict(block_size=64 * KIB, shuffle=2), "transfer"),
        # world - 1 rows: the last rank's shard is empty; the rle strategy
        "i16_uneven": ((world,), "int16", stairs, [("S", 0)],
                       dict(block_size=32 * KIB), "rle"),
        # an uneven split of columns, complex values (type size 8), ZSTD
        "c64_cols": ((world,), "complex64", c64.reshape(40, world * 1000 + 3), [("S", 1)],
                     dict(block_size=64 * KIB, codec=5), "transfer"),
    }
    if world == 4:
        grid = (np.arange(12 * 8192) % 5003).astype(np.float32).reshape(12, 8192)
        out["mesh2d_rep"] = ((2, 2), "float32", grid, [("S", 0), "R"],
                             dict(block_size=64 * KIB), "transfer")
        out["mesh2d_two"] = ((2, 2), "float32", grid, [("S", 1), ("S", 0)],
                             dict(block_size=64 * KIB, shuffle=2), "transfer")
    return out


def full_tensor(dtype: str, arr: np.ndarray):
    import torch

    if dtype == "bfloat16":
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def placements_of(spec):
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if p == "R" else Shard(p[1]) for p in spec]


def local_bytes(t) -> np.ndarray:
    from tpu_blosc_torch.device import tensor_bytes

    return tensor_bytes(t.to_local()).numpy()


def main() -> None:
    rank, world, store_file, out_dir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    )
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor, init_device_mesh

    from torch_ckpt_worker import place

    import tpu_blosc_torch as tb
    from tpu_blosc_torch.dist import initialize_distributed

    initialize_distributed(
        "cpu", store=dist.FileStore(store_file, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    try:
        for case, (mesh_shape, dtype, arr, spec, kw, strategy) in cases(world).items():
            mesh = init_device_mesh("cpu", mesh_shape)
            placements = placements_of(spec)
            full = full_tensor(dtype, arr)
            x = place(full, mesh, placements)
            if full.dtype == torch.float32:
                with open(f"{os.path.join(out_dir, case)}.r{rank}.dist", "wb") as f:
                    f.write(local_bytes(distribute_tensor(full, mesh, placements)).tobytes())
            opts = tb.Options(**kw)
            base = os.path.join(out_dir, f"{case}.r{rank}")
            frame = tb.compress_array(x, opts, strategy=strategy)
            env = tb.pack_array(x, opts)
            with tb.StreamWriter(base + ".rec.tpbs", opts) as w:
                w.write_array(x, strategy=strategy)
            tb.save_array(os.path.join(out_dir, f"{case}.save.r{rank}.tpbs"), x, opts)
            tb.save_pytree(os.path.join(out_dir, f"{case}.tree.r{rank}.tpbs"),
                           {"x": x, "b": torch.arange(5, dtype=torch.int32), "step": 7}, opts)
            for what, blob in (("frame", frame), ("env", env)):
                with open(f"{base}.{what}", "wb") as f:
                    f.write(blob)

            sharding = (mesh, placements)
            shape = tuple(full.shape)
            got = {}
            for s in ("device", "transfer", "records"):
                got[f"decompress_array.{s}"] = tb.decompress_array(
                    frame, full.dtype, shape=shape, device="cpu", sharding=sharding,
                    strategy=s)
            got["decompress_array.replicate"] = tb.decompress_array(
                frame, full.dtype, shape=shape, sharding=(mesh, [Replicate()] * mesh.ndim))
            got["unpack_array"] = tb.unpack_array(env, sharding=sharding)
            with tb.StreamReader(base + ".rec.tpbs") as r:
                got["read_array"] = r.read_array(0, full.dtype, shape=shape, sharding=sharding,
                                                 strategy="device")
                got["iter_arrays"], = list(r.iter_arrays(full.dtype, shape=shape,
                                                         sharding=sharding))
            got["load_array"] = tb.load_array(base + ".rec.tpbs", full.dtype, shape=shape,
                                              device="cpu", sharding=sharding)
            np.savez(base + ".dec.npz", **{k: local_bytes(v) for k, v in got.items()})
            with open(base + ".dec.json", "w") as f:
                json.dump({k: {"type": type(v).__name__, "placements": [repr(p) for p in
                                                                        v.placements],
                               "shape": list(v.shape), "local_shape": list(v.to_local().shape),
                               "device": str(v.to_local().device),
                               "dtype": str(v.dtype)}
                           for k, v in got.items()}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
