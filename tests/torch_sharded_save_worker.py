"""Worker for the port's sharded training-state save tests (not a test module).

    python tests/torch_sharded_save_worker.py <rank> <world> <store_file> <out_dir>

One of ``world`` processes over Gloo on the CPU.  Each makes its shards of
the benchmark's Nemotron-3-Nano training state at the small widths of
``SMALL`` (``benchmark/data/nemotron_3_nano_train.py``, DTensors with
``Shard(0)`` over a one-dimensional CPU mesh), hands its tensors to the
save's pipeline as CUDA leaves are handed to it (stage 1 on a worker
thread, stage 2 on the caller), and writes ``{out_dir}/state.p{rank}.tpbs``
with ``save_pytree_sharded`` under ``stats.trace`` inside a
``bench.save_sharded`` span.  It leaves beside the file
``rank{rank}.json``: the trace's file and the save's counters.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "nemotron-3-nano-fsdp4.save"
SEED = 2**31 + 29
# every width the generator reads, small: the embedding's rows stay the
# published vocabulary, so its shards pass the 4 MiB automatic block
# threshold in both dtypes and are multi-block frames, as at the
# published widths; every other leaf is a single-block frame
SMALL = {"hidden_size": 68, "mamba_num_heads": 4, "mamba_head_dim": 8, "n_groups": 2,
         "ssm_state_size": 8, "n_routed_experts": 8, "n_routed_experts_published": 16,
         "moe_intermediate_size": 16, "moe_shared_expert_intermediate_size": 32,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8}


def small_cell(sample_bytes: int = 18 << 20):
    """The benchmark's cell with the small widths, its traffic's bytes
    and its reference's sample to match."""
    sys.path.insert(0, ROOT)
    from benchmark import harness

    cell = harness.load_cell(CELL, ROOT)
    cell.config.update(SMALL)
    cell.config["reference"]["sample_bytes"] = sample_bytes
    cell.traffic["tensor_bytes"] = generator(cell).state_bytes(cell.config)
    return cell


def generator(cell):
    return cell.module("data", cell.config["data"]["generator"])


def main() -> None:
    rank, world, store_file, out_dir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    )
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import record_function

    cell = small_cell()
    from tpu_blosc_torch import Codec, Options, Shuffle, checkpoint, stats
    from tpu_blosc_torch.dist import initialize_distributed

    initialize_distributed(
        "cpu", store=dist.FileStore(store_file, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    try:
        mesh = init_device_mesh("cpu", (world,))
        cfg = cell.config
        state = generator(cell).make(cell.traffic["tensor_bytes"], SEED, torch.device("cpu"),
                                     cfg, mesh)
        o = cfg["options"]
        opts = Options(codec=Codec[o["codec"]], level=o["level"], shuffle=Shuffle[o["shuffle"]],
                       block_size=o["block_size"], num_threads=o["num_threads"])
        # the pipeline a CUDA leaf takes: stage 1 on the worker thread
        checkpoint._on_cuda = lambda leaf: isinstance(leaf, torch.Tensor)
        checkpoint.reset_saved()
        with stats.trace(out_dir) as t:
            with record_function("bench.save_sharded"):
                checkpoint.save_pytree_sharded(os.path.join(out_dir, "state"), state, opts)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"trace_file": t["trace_file"], "saved": checkpoint.saved}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
