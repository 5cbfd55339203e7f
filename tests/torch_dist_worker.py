"""Worker for the port's multi-process frame tests (not a test module).

    python tests/torch_dist_worker.py <rank> <world> <store_file> <out_dir>

One of ``world`` processes over Gloo on the CPU.  Each runs every case of
``cases()`` through ``compress_chunked_mesh`` (with statistics),
``decompress_chunked_mesh``, ``compress_chunked_multihost`` (with its
work-division record) and ``decompress_chunked_multihost``, and writes
what came out under ``out_dir`` for tests/test_torch_dist.py and
tests/test_torch_multihost.py to read:

    {case}.r{rank}.mesh      the mesh frame
    {case}.r{rank}.meshplain the mesh frame of a call without statistics
    {case}.r{rank}.stats.npz histogram, block_diffs, sample_bytes
    {case}.r{rank}.meshdec   decompress_chunked_mesh of it
    {case}.r{rank}.mh        the multihost frame
    {case}.r{rank}.mh.json   the stats dict and the decoded slice's range
    {case}.r{rank}.mhdec     this rank's decoded slice
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys

import numpy as np

KIB = 1024


def cases() -> dict:
    """name -> (bytes, Options keywords): the same in every process and in
    the tests, made from fixed seeds."""
    rng = np.random.default_rng(7)
    ramp = np.arange(140_000, dtype=np.float32).tobytes()
    noise = rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()

    def words(n_bytes: int) -> bytes:
        return (np.arange(n_bytes // 4, dtype=np.uint32) % 65536).tobytes()

    mixed = bytearray(words(7 * 16 * KIB))
    mixed[2 * 16 * KIB : 3 * 16 * KIB] = rng.integers(0, 256, 16 * KIB, dtype=np.uint8).tobytes()
    return {
        # memcpy and compressed blocks mixed, a ragged tail (tests/multihost_worker.py)
        "ramp_noise": (ramp + noise, dict(block_size=64 * KIB)),
        "ramp_noise_bit": (ramp + noise, dict(block_size=64 * KIB, shuffle=2)),
        "ramp_noise_zstd_ts8": (ramp + noise, dict(block_size=64 * KIB, codec=5, type_size=8)),
        "ramp_noise_noshuffle": (ramp + noise, dict(block_size=64 * KIB, shuffle=0)),
        # 4 full blocks and a tail: at 2 ranks the filter stage's partition
        # [0,1][2,3] is not the codec stage's [0,1,2][3,4]
        "four_and_tail": (words(4 * 16 * KIB) + b"tail" * 25 + b"xyz", dict(block_size=16 * KIB)),
        # 7 full blocks: at 3 ranks [0,1,2][3,4,5][6] against [0,1,2][3,4][5,6];
        # 5 full blocks: at 4 ranks [0,1][2,3][4][] against [0,1][2][3][4]
        "seven_blocks": (bytes(mixed), dict(block_size=16 * KIB, shuffle=2, type_size=2)),
        "five_blocks": (words(5 * 16 * KIB), dict(block_size=16 * KIB, codec=2)),
        "five_and_tail": (words(5 * 16 * KIB) + b"\x01\x02\x03", dict(block_size=16 * KIB)),
        # fewer blocks than ranks: ranks with no block at all
        "one_block": (words(16 * KIB), dict(block_size=16 * KIB)),
        # 5 MiB in 1 MiB blocks: the histogram is sampled, the last shard padded
        "sampled": (words(5 << 20) + b"\x07" * 100, dict(block_size=1 << 20)),
    }


def spawn_group(worker: str, world: int, out_dir: str, timeout: float = 120.0) -> None:
    """Run ``python worker <rank> <world> <store_file> <out_dir>`` for
    every rank at once and wait; a rank that fails or outlasts ``timeout``
    seconds kills the whole group and raises RuntimeError with its
    standard error."""
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen([sys.executable, worker, str(r), str(world), store, out_dir],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)
    ]
    try:
        for r, proc in enumerate(procs):
            try:
                _, err = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {r} of {world} timed out") from None
            if proc.returncode != 0:
                raise RuntimeError(f"rank {r} of {world} failed:\n"
                                   + err.decode(errors="replace")[-3000:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def group_cache(tmp_path_factory, worker: str, label: str):
    """world size -> the directory its ranks wrote to: each group is
    spawned once, the first time a test asks for it (the body of the test
    modules' module-scoped ``spawned`` fixtures)."""
    done: dict[int, str] = {}

    def get(world: int) -> str:
        if world not in done:
            out = str(tmp_path_factory.mktemp(f"{label}_w{world}"))
            spawn_group(worker, world, out)
            done[world] = out
        return done[world]

    return get


def read_output(out_dir: str, case: str, rank: int, what: str) -> bytes:
    with open(os.path.join(out_dir, f"{case}.r{rank}.{what}"), "rb") as f:
        return f.read()


def main() -> None:
    rank, world, store_file, out_dir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    )
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch.distributed as dist

    from tpu_blosc_torch.chunk import choose_block_size
    from tpu_blosc_torch.dist import mesh, multihost
    from tpu_blosc_torch.options import Options

    mesh.initialize_distributed(
        "cpu", store=dist.FileStore(store_file, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    try:
        for name, (data, kw) in cases().items():
            opts = Options(**kw)
            base = os.path.join(out_dir, f"{name}.r{rank}")
            frame, stats = mesh.compress_chunked_mesh(data, opts, device="cpu",
                                                      return_stats=True)
            with open(base + ".mesh", "wb") as f:
                f.write(frame)
            np.savez(base + ".stats.npz", histogram=stats.histogram,
                     block_diffs=stats.block_diffs, sample_bytes=stats.sample_bytes)
            with open(base + ".meshplain", "wb") as f:
                f.write(mesh.compress_chunked_mesh(data, opts, device="cpu"))
            with open(base + ".meshdec", "wb") as f:
                f.write(mesh.decompress_chunked_mesh(frame, device="cpu"))

            block_size = choose_block_size(len(data), opts.clamped().type_size, opts.block_size)
            start, end = multihost.process_slice(len(data), block_size, rank, world)
            record: dict = {}
            frame = multihost.compress_chunked_multihost(len(data), data[start:end], opts,
                                                         stats=record)
            with open(base + ".mh", "wb") as f:
                f.write(frame)
            local, dstart, dend = multihost.decompress_chunked_multihost(frame)
            record.update(slice=[start, end], decoded=[dstart, dend])
            with open(base + ".mh.json", "w") as f:
                json.dump(record, f)
            with open(base + ".mhdec", "wb") as f:
                f.write(local)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
