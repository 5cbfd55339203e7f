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

The byte shuffle of a device tensor runs in hand-written CUDA kernels
(``csrc/shuffle.cu``), built with nvcc at first use, and so do the
match strategy's literal mask (``csrc/match.cu``, behind
``compress_array(..., strategy="match")``) and the probe behind
``suggest_codec`` (``csrc/probe.cu``).
"""

from .api import (
    compress_with_options,
    decompress,
    decompress_into,
    decompress_with_size,
    get_decompressed_size,
    suggest_codec,
    suggest_options,
)
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

__all__ = [
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
    "backend_name",
    "compress_array",
    "compress_with_options",
    "decompress",
    "decompress_array",
    "decompress_into",
    "decompress_with_size",
    "get_decompressed_size",
    "suggest_codec",
    "suggest_options",
]
