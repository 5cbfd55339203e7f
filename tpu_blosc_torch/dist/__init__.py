"""Distributed (multi-device, multi-process) block pipeline of the port,
on ``torch.distributed``: one rank, one process, one device."""

from ._group import comm_device, initialize_distributed, rank, world_size
from .mesh import (
    MeshStats,
    compress_chunked_mesh,
    decompress_chunked_mesh,
    filter_blocks_sharded,
    unfilter_blocks_sharded,
)

__all__ = [
    "MeshStats",
    "comm_device",
    "compress_chunked_mesh",
    "decompress_chunked_mesh",
    "filter_blocks_sharded",
    "initialize_distributed",
    "rank",
    "unfilter_blocks_sharded",
    "world_size",
]
