"""The CUDA byte-shuffle kernels: nvcc build, ctypes binding, launches.

The source is ``tpu_blosc_torch/csrc/shuffle.cu``; it replaces the TPU
kernels ``byte_plane_split`` and ``byte_plane_merge``
(``tpu_blosc/filters/pallas_kernels.py:292-333``).  It is compiled with
nvcc for ``sm_90a`` into ``tpu_blosc_torch/_build/`` at the first launch,
as a shared library with a plain C interface, and bound with ctypes.
Nothing here is built or loaded when the module is imported.

Each wrapper takes CUDA tensors only, launches on PyTorch's current
stream, and raises when the launch is refused.  ``launches`` counts the
launches of each kernel, so a caller can show that a path went through
it.  The plain PyTorch versions live in ``filters/batched.py``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from .. import buildlib

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "shuffle.cu"
)
LIB_PATH = os.path.join(buildlib.BUILD_DIR, "libtpbt_shuffle.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
]

# launches of each kernel since the last reset_launches()
launches = {"shuffle_blocks": 0, "unshuffle_blocks": 0}

_lib = None
_load_lock = threading.Lock()
# seconds the first load of this process spent compiling (0.0: up to date)
build_seconds: float | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def lib() -> ctypes.CDLL:
    """The kernel library, built first if the source changed."""
    global _lib, build_seconds
    if _lib is None:
        with _load_lock:
            if _lib is None:
                build_seconds = buildlib.ensure_built(
                    LIB_PATH, [SOURCE],
                    [[nvcc(), *NVCC_FLAGS, SOURCE, "-o", buildlib.OUT]],
                )
                handle = ctypes.CDLL(LIB_PATH)
                p, i64 = ctypes.c_void_p, ctypes.c_int64
                handle.tpbt_shuffle_blocks.restype = ctypes.c_int
                handle.tpbt_shuffle_blocks.argtypes = [p, p, i64, i64, i64, p]
                handle.tpbt_unshuffle_blocks.restype = ctypes.c_int
                handle.tpbt_unshuffle_blocks.argtypes = [p, p, p, i64, i64, i64, p]
                _lib = handle
    return _lib


def check_blocks(blocks: torch.Tensor, type_size: int) -> None:
    """The geometry every shuffle route takes: a contiguous (nb, bs)
    uint8 tensor with ``type_size >= 2`` and ``bs % type_size == 0``."""
    if blocks.dtype != torch.uint8:
        raise TypeError(f"blocks must be uint8, got {blocks.dtype}")
    if blocks.dim() != 2:
        raise ValueError(f"blocks must be 2-D (nb, bs), got shape {tuple(blocks.shape)}")
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    if type_size < 2:
        raise ValueError(f"type_size must be >= 2, got {type_size}")
    if blocks.shape[1] % type_size:
        raise ValueError(
            f"block size {blocks.shape[1]} is not a multiple of type_size {type_size}"
        )


def _check_cuda(t: torch.Tensor, device: torch.device, what: str) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")


def _output(blocks: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    if out is None:
        return torch.empty_like(blocks)
    _check_cuda(out, blocks.device, "out")
    if out.dtype != torch.uint8 or out.shape != blocks.shape or not out.is_contiguous():
        raise ValueError("out must be a contiguous uint8 tensor shaped like blocks")
    if out.data_ptr() == blocks.data_ptr():
        raise ValueError("out must not alias blocks")
    return out


def _raise_if_failed(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def shuffle_blocks(blocks: torch.Tensor, type_size: int,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Byte-shuffle each row of a CUDA (nb, bs) uint8 tensor."""
    if blocks.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {blocks.device}")
    check_blocks(blocks, type_size)
    out = _output(blocks, out)
    nb, bs = blocks.shape
    if nb == 0:
        return out
    with torch.cuda.device(blocks.device):
        rc = lib().tpbt_shuffle_blocks(
            blocks.data_ptr(), out.data_ptr(), nb, bs, type_size,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, "tpbt_shuffle_blocks")
    launches["shuffle_blocks"] += 1
    return out


def unshuffle_blocks(blocks: torch.Tensor, type_size: int,
                     keep_raw: torch.Tensor | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of shuffle_blocks; rows where ``keep_raw`` (a (nb,) bool
    tensor) is True are copied verbatim."""
    if blocks.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {blocks.device}")
    check_blocks(blocks, type_size)
    out = _output(blocks, out)
    nb, bs = blocks.shape
    keep_ptr = None
    if keep_raw is not None:
        _check_cuda(keep_raw, blocks.device, "keep_raw")
        if keep_raw.dtype != torch.bool or keep_raw.shape != (nb,) or not keep_raw.is_contiguous():
            raise ValueError(f"keep_raw must be a contiguous bool tensor of shape ({nb},)")
        keep_ptr = keep_raw.data_ptr()
    if nb == 0:
        return out
    with torch.cuda.device(blocks.device):
        rc = lib().tpbt_unshuffle_blocks(
            blocks.data_ptr(), out.data_ptr(), keep_ptr, nb, bs, type_size,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, "tpbt_unshuffle_blocks")
    launches["unshuffle_blocks"] += 1
    return out
