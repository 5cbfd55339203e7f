"""tpu_blosc_torch: the Blosc codec of tpu_blosc for PyTorch tensors on CUDA.

The port of the JAX package ``tpu_blosc`` to PyTorch and an NVIDIA Hopper
GPU.  It imports torch, numpy and ctypes and never jax or tpu_blosc, and
its frames are byte-identical to tpu_blosc's: both run one native host
codec, compiled from ``tpu_blosc/native/tpublosc.cpp``.

    import torch, tpu_blosc_torch as tbt
    x = torch.arange(1 << 24, dtype=torch.float32, device="cuda")
    frame = tbt.compress_array(x, tbt.Options(codec=tbt.Codec.LZ4))
    y = tbt.decompress_array(frame, torch.float32, device="cuda",
                             strategy="device")

The byte and bit shuffles of a device tensor run in hand-written CUDA
kernels (``csrc/shuffle.cu``, ``csrc/bitshuffle.cu``), built with nvcc at
first use, and so do the match strategy's literal mask (``csrc/match.cu``,
behind ``compress_array(..., strategy="match")``) and the probe behind
``suggest_codec`` (``csrc/probe.cu``).

On top of that pair sit the files the JAX package writes, byte for byte:
``pack_array`` envelopes, TPBS streams and ``save_pytree`` checkpoints,
whose CUDA leaves are filtered on the device:

    tbt.save_pytree("ckpt.tpbs", {"params": params, "step": 1000})
    state = tbt.load_pytree("ckpt.tpbs", device=True)
"""

from .api import (
    AUTO_BLOCK_THRESHOLD,
    compress_batch_with_options,
    compress_with_options,
    decompress,
    decompress_batch,
    decompress_batch_into,
    decompress_into,
    decompress_range,
    decompress_range_into,
    decompress_with_size,
    get_decompressed_size,
    get_info,
    suggest_codec,
    suggest_options,
)
from .array import pack_array, unpack_array, unpack_array_rows
from .checkpoint import load_leaf, load_pytree, save_pytree
from .device import compress_array, decompress_array
from .errors import (
    BloscError,
    CompressionFailedError,
    DataTooLargeError,
    DecompressionFailedError,
    InvalidCodecError,
    InvalidDataError,
    InvalidHeaderError,
    InvalidVersionError,
    SizeMismatchError,
)
from .filters import backend_name
from .format import Codec, Shuffle
from .options import Options
from .stream import StreamReader, StreamWriter, load, load_array, save, save_array

__all__ = [
    "AUTO_BLOCK_THRESHOLD",
    "BloscError",
    "Codec",
    "CompressionFailedError",
    "DataTooLargeError",
    "DecompressionFailedError",
    "InvalidCodecError",
    "InvalidDataError",
    "InvalidHeaderError",
    "InvalidVersionError",
    "Options",
    "Shuffle",
    "SizeMismatchError",
    "StreamReader",
    "StreamWriter",
    "backend_name",
    "compress_array",
    "compress_batch_with_options",
    "compress_with_options",
    "decompress",
    "decompress_array",
    "decompress_batch",
    "decompress_batch_into",
    "decompress_into",
    "decompress_range",
    "decompress_range_into",
    "decompress_with_size",
    "get_decompressed_size",
    "get_info",
    "load",
    "load_array",
    "load_leaf",
    "load_pytree",
    "pack_array",
    "save",
    "save_array",
    "save_pytree",
    "suggest_codec",
    "suggest_options",
    "unpack_array",
    "unpack_array_rows",
]
