"""The process group the distributed entry points run in.

Counterpart: ``jax.process_index()`` / ``jax.process_count()`` and
``tpu_blosc/dist/mesh.py:64-71`` (``initialize_distributed``).  One rank
is one process with one device.  With no group initialised there is one
rank, as ``jax`` reports one process on one host.

Collectives run on ``comm_device()``: the current CUDA device under NCCL,
the CPU under Gloo.  Every operand is moved there before its collective,
whatever device the rank computes on (NCCL takes no CPU tensor and Gloo
few CUDA ones).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..filters import target_device


#: the gather into one tensor: torch 2.13 names it ``all_gather_single`` and
#: deprecates ``all_gather_into_tensor`` (a FutureWarning on every call);
#: torch 2.11 has only the older name
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def is_grouped() -> bool:
    """True when a default process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    """This process's rank in ``group`` (None: the default group); 0 when
    no group is initialised."""
    return dist.get_rank(group) if is_grouped() else 0


def world_size(group=None) -> int:
    """The number of ranks in ``group``; 1 when no group is initialised."""
    return dist.get_world_size(group) if is_grouped() else 1


def comm_device(group=None) -> torch.device:
    """The device ``group``'s collectives take their tensors on."""
    if "nccl" in str(dist.get_backend(group)):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize_distributed(device=None, **kwargs) -> None:
    """Start the default process group (a wrapper of
    ``torch.distributed.init_process_group``).

    ``device`` is where this rank's collectives run: None is the current
    CUDA device, a CUDA device is made current, and either picks the
    ``"nccl"`` backend; ``"cpu"`` picks ``"gloo"`` (ranks that compute on
    a CUDA device may still gather over Gloo: operands are staged through
    the host).  ``store`` or ``init_method``, ``rank``, ``world_size`` and
    ``timeout`` pass through.
    """
    dev = target_device(device, "initialize_distributed")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kwargs)


def all_gather_rows(local: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``local`` (one shape and dtype on all ranks), stacked
    along the first axis in rank order, on ``comm_device()``."""
    cd = comm_device(group)
    local = local.to(cd).contiguous()
    out = torch.empty((world_size(group) * local.shape[0], *local.shape[1:]),
                      dtype=local.dtype, device=cd)
    _all_gather_into(out, local, group=group)
    return out
