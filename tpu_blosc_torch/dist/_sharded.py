"""Sharded tensors (``torch.distributed.tensor.DTensor``) at the
single-frame entry points: the full tensor of a DTensor, and a DTensor
made from a full tensor.

The JAX package has no counterpart: ``np.asarray`` of a sharded
``jax.Array`` gathers it, and ``jax.device_put(x, sharding)`` places it.
Here ``gather_full`` is the first and ``place`` the second; the encoders
(compress_array, pack_array, the stream writers, save_pytree) gather a
DTensor and write the frame of its full tensor, and the decoders take
``sharding=(mesh, placements)`` and place what they decode.

``gather_full`` is a collective: every rank of the DTensor's device mesh
must call it, for the same tensors in the same order, or the others wait
until the group's timeout.  ``place`` makes no collective.

A DTensor exists only once ``torch.distributed.tensor`` has been imported,
so ``is_dtensor`` looks the module up in ``sys.modules`` and nothing here
imports it before it is handed a DTensor or a mesh.

Spans follow ``torch.chunk``, as DTensor's ``Shard`` does: ``Shard(d)``
over a mesh dimension of k ranks splits what the mesh dimensions before it
left of dimension d into pieces of ceil(size / k), the last ones short or
empty; ``Replicate`` leaves it whole.
"""

from __future__ import annotations

import itertools
import sys

import torch
import torch.distributed as dist

from . import _group


def is_dtensor(obj) -> bool:
    """Whether ``obj`` is a DTensor (never imports its module)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(obj, mod.DTensor)


def check_placements(placements, ndim: int) -> None:
    """Refuse placements other than ``Shard`` and ``Replicate`` (TypeError:
    a ``Partial`` tensor has no full value to write without a reduction),
    and a count that is not the mesh's number of dimensions."""
    from torch.distributed.tensor import Replicate, Shard

    placements = tuple(placements)
    if len(placements) != ndim:
        raise ValueError(f"{len(placements)} placements for a {ndim}-D device mesh")
    for p in placements:
        if type(p) not in (Shard, Replicate):
            raise TypeError(f"unsupported DTensor placement: {p!r} (Shard and Replicate only)")


def span_at(shape, mesh_shape, placements, coord) -> list:
    """[[start, stop], ...] in ``shape`` of the piece the rank at mesh
    coordinate ``coord`` holds, for any coordinate of the mesh."""
    from torch.distributed.tensor import Shard

    span = [[0, int(d)] for d in shape]
    for m, p in enumerate(placements):
        if type(p) is Shard:
            start, stop = span[p.dim]
            size = stop - start
            piece = -(-size // mesh_shape[m])
            span[p.dim] = [start + min(coord[m] * piece, size),
                           start + min((coord[m] + 1) * piece, size)]
    return span


def shard_span(obj) -> tuple[list, bool]:
    """(this rank's span of the DTensor ``obj``, whether it writes the
    piece in a sharded checkpoint): of the ranks that hold the same piece
    (a ``Replicate`` placement), the one at coordinate 0 of every
    replicated mesh dimension writes it."""
    mesh = obj.device_mesh
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this process is not in the DTensor's device mesh")
    check_placements(obj.placements, mesh.ndim)
    writer = all(coord[m] == 0 for m, p in enumerate(obj.placements) if p.is_replicate())
    return span_at(obj.shape, tuple(mesh.shape), obj.placements, coord), writer


def _slices(span) -> tuple:
    return tuple(slice(a, b) for a, b in span)


def _numel(span) -> int:
    n = 1
    for a, b in span:
        n *= b - a
    return n


def gather_full(x) -> torch.Tensor:
    """The full tensor of the DTensor ``x``, on its local shard's device.

    A collective over ``x.device_mesh``: every rank of the mesh calls it.
    The pieces travel as bytes (Gloo takes no bfloat16), padded to the
    largest piece, one ``all_gather`` along each mesh dimension that
    shards ``x``; each piece goes to its span.  A fully replicated ``x``
    is its local tensor.
    """
    from ..device import tensor_bytes

    mesh = x.device_mesh
    shape, placements = tuple(x.shape), tuple(x.placements)
    mesh_shape = tuple(mesh.shape)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this process is not in the DTensor's device mesh")
    check_placements(placements, mesh.ndim)
    local = x.to_local()
    if x.numel() == 0:
        return torch.empty(shape, dtype=x.dtype, device=local.device)
    itemsize = x.element_size()
    # a Replicate dimension's ranks hold the same piece: no gather along it
    dims = [m for m, p in enumerate(placements) if p.is_shard()]
    if not dims:
        return local
    width = itemsize * max(
        _numel(span_at(shape, mesh_shape, placements, c))
        for c in _coords(mesh_shape))
    rows = torch.zeros((1, width), dtype=torch.uint8, device=local.device)
    mine = tensor_bytes(local)
    rows[0, : mine.numel()] = mine
    held = [tuple(coord)]  # the mesh coordinate of each row
    ranks = mesh.mesh
    for m in dims:
        group = mesh.get_group(m)
        rows = _group.all_gather_rows(rows, group)
        along = [_coordinate(ranks, g)[m] for g in dist.get_process_group_ranks(group)]
        held = [h[:m] + (c,) + h[m + 1:] for c in along for h in held]
    rows = rows.to(local.device)
    full = torch.empty((*shape, itemsize), dtype=torch.uint8, device=local.device)
    for c, row in zip(held, rows):
        span = span_at(shape, mesh_shape, placements, c)
        n = _numel(span)
        if n:
            full[_slices(span)] = row[: n * itemsize].view(*(b - a for a, b in span), itemsize)
    return full.view(-1).view(x.dtype).view(shape)


def _coords(mesh_shape):
    return itertools.product(*(range(k) for k in mesh_shape))


def _coordinate(ranks: torch.Tensor, rank: int) -> tuple:
    """The mesh coordinate of global rank ``rank`` in the mesh's rank
    tensor."""
    return tuple(int(i) for i in (ranks == rank).nonzero()[0])


def sharding_device(sharding, device=None) -> torch.device:
    """The device a decode with ``sharding`` (a ``(DeviceMesh,
    placements)`` pair) lands on: the mesh's device type, on the current
    CUDA device for a CUDA mesh.  ``device`` (None, or a bool from
    unpack_array, otherwise ignored) may name the device too, and must
    then be of the mesh's type (ValueError); its index picks the card."""
    mesh, placements = _unpack(sharding)
    check_placements(placements, mesh.ndim)
    if device is not None and not isinstance(device, bool):
        dev = torch.device(device)
        if dev.type != mesh.device_type:
            raise ValueError(
                f"device {dev} disagrees with the sharding's {mesh.device_type!r} mesh")
        if dev.type != "cuda" or dev.index is not None:
            return dev
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _unpack(sharding):
    try:
        mesh, placements = sharding
    except (TypeError, ValueError):
        raise TypeError(
            f"sharding is a (DeviceMesh, placements) pair, got {type(sharding)!r}") from None
    return mesh, tuple(placements)


def place(full: torch.Tensor, sharding, device=None):
    """``full`` as a DTensor over ``sharding``'s mesh: this rank's span of
    it, copied to ``sharding_device(sharding, device)``, with the global
    shape and C-order stride.  No collective."""
    from torch.distributed.tensor import DTensor

    mesh, placements = _unpack(sharding)
    target = sharding_device(sharding, device)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this process is not in the sharding's device mesh")
    span = span_at(full.shape, tuple(mesh.shape), placements, coord)
    local = full[_slices(span)].to(target).contiguous()
    stride = torch.empty(full.shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape, stride=stride)
