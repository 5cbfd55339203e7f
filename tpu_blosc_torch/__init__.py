"""tpu_blosc_torch: the Blosc codec of tpu_blosc for PyTorch tensors on CUDA.

The port of the JAX package ``tpu_blosc`` to PyTorch and an NVIDIA Hopper
GPU.  It imports torch, numpy and ctypes and never jax or tpu_blosc, and
its frames are byte-identical to tpu_blosc's: it compiles its own copy of
tpu_blosc's native host codec (``native/tpublosc.cpp``) and of its
fastcall module (``native/fastmod.c``).  With ``TPU_BLOSC_NO_NATIVE=1`` it
runs without a native build, as tpu_blosc does: the codecs in pure
Python, host buffers of 256 KiB or more filtered on the card.

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

Several processes, one device each, write one frame or one checkpoint
together over ``torch.distributed`` (``tpu_blosc_torch.dist``,
``checkpoint.save_pytree_sharded``; reached as submodules, as in
tpu_blosc).

The bytes API is tpu_blosc's, name for name, with its open codec
registry (a registered codec runs at every entry point, the device ones
included), ``stats`` (``compress_with_stats``, ``frame_stats``, and
``stats.trace`` for a ``torch.profiler`` trace of a region) and the CLI
``python -m tpu_blosc_torch``:

    frame = tbt.compress(data, tbt.LZ4, 5, tbt.SHUFFLE, 4)
    assert tbt.decompress(frame) == data
    tbt.register_codec(42, my_codec)  # compress/decompress/name
"""

from .api import (
    AUTO_BLOCK_THRESHOLD,
    compress,
    compress_batch,
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
from .codecs.registry import get_codec, list_codecs, register_codec
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
from .filters import (
    backend_name,
    bit_shuffle,
    bit_unshuffle,
    shuffle_buffer,
    shuffle_bytes,
    unshuffle_buffer,
    unshuffle_bytes,
)
from .format import (
    FLAG_BITSHUFFLE,
    FLAG_MEMCPY,
    FLAG_SHUFFLE,
    FLAG_SPLIT,
    FORMAT_VERSION,
    HEADER_SIZE,
    MIN_HEADER_SIZE,
    VERSION,
    Codec,
    Header,
    Shuffle,
    parse_header,
)
from .options import Options, default_options
from .stats import CompressionStats, FrameStats, compress_with_stats, frame_stats
from .stream import StreamReader, StreamWriter, load, load_array, save, save_array

# the codecs' and filters' names as the quick-start spells them
# (≙ tpu_blosc/__init__.py:88-99)
BLOSCLZ = Codec.BLOSCLZ
LZ4 = Codec.LZ4
LZ4HC = Codec.LZ4HC
SNAPPY = Codec.SNAPPY
ZLIB = Codec.ZLIB
ZSTD = Codec.ZSTD
NOSHUFFLE = Shuffle.NOSHUFFLE
SHUFFLE = Shuffle.SHUFFLE
BITSHUFFLE = Shuffle.BITSHUFFLE

__version__ = VERSION

__all__ = [
    "AUTO_BLOCK_THRESHOLD",
    "BITSHUFFLE",
    "BLOSCLZ",
    "BloscError",
    "Codec",
    "CompressionFailedError",
    "CompressionStats",
    "DataTooLargeError",
    "DecompressionFailedError",
    "FLAG_BITSHUFFLE",
    "FLAG_MEMCPY",
    "FLAG_SHUFFLE",
    "FLAG_SPLIT",
    "FORMAT_VERSION",
    "FrameStats",
    "HEADER_SIZE",
    "Header",
    "InvalidCodecError",
    "InvalidDataError",
    "InvalidHeaderError",
    "InvalidVersionError",
    "LZ4",
    "LZ4HC",
    "MIN_HEADER_SIZE",
    "NOSHUFFLE",
    "Options",
    "SHUFFLE",
    "SNAPPY",
    "Shuffle",
    "SizeMismatchError",
    "StreamReader",
    "StreamWriter",
    "VERSION",
    "ZLIB",
    "ZSTD",
    "backend_name",
    "bit_shuffle",
    "bit_unshuffle",
    "compress",
    "compress_array",
    "compress_batch",
    "compress_batch_with_options",
    "compress_with_options",
    "compress_with_stats",
    "decompress",
    "decompress_array",
    "decompress_batch",
    "decompress_batch_into",
    "decompress_into",
    "decompress_range",
    "decompress_range_into",
    "decompress_with_size",
    "default_options",
    "frame_stats",
    "get_codec",
    "get_decompressed_size",
    "get_info",
    "list_codecs",
    "load",
    "load_array",
    "load_leaf",
    "load_pytree",
    "pack_array",
    "parse_header",
    "register_codec",
    "save",
    "save_array",
    "save_pytree",
    "shuffle_buffer",
    "shuffle_bytes",
    "suggest_codec",
    "suggest_options",
    "unpack_array",
    "unpack_array_rows",
    "unshuffle_buffer",
    "unshuffle_bytes",
]
