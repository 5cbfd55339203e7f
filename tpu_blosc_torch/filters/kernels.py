"""The CUDA kernels: nvcc build, ctypes binding, launches.

Every ``.cu`` file under ``tpu_blosc_torch/csrc/`` goes into one shared
library with a plain C interface:

- ``shuffle.cu``: ``tpbt_shuffle_blocks`` / ``tpbt_unshuffle_blocks``,
  replacing ``byte_plane_split`` and ``byte_plane_merge``
  (``tpu_blosc/filters/pallas_kernels.py:292-333``), each with two paths
  that ``shuffle_path`` picks between;
- ``match.cu``: ``tpbt_match_nibble``, replacing
  ``match_select_open_nibble`` (:343-497), with ``tpbt_match_mask``, the
  same kernel writing the packed mask and the rows' literal counts, and
  ``tpbt_match_count``,
  replacing the count phase of the XLA match core
  (``tpu_blosc/device.py:303-335``); each with two paths that
  ``match_path`` picks between;
- ``probe.cu``: ``tpbt_probe_tiles``, replacing ``_probe_runs`` and
  ``_probe_bytesum`` (:80-126);
- ``bitshuffle.cu``: ``tpbt_bitshuffle_blocks`` /
  ``tpbt_bitunshuffle_blocks``, replacing the XLA device programs
  ``_bit_shuffle_batch_dev`` and ``_bit_unshuffle_batch_dev``
  (``tpu_blosc/filters/batched.py:65-79``); the launcher picks its path;
- ``rle.cu``: ``tpbt_seg_run_counts`` and ``tpbt_rows_rle``, replacing the
  XLA device programs ``_device_filter_seg_counts`` (its count; the
  filter before it is the shuffle kernel) and ``_device_rows_rle``
  (``tpu_blosc/device.py:165-207``); two paths that ``rle_path`` picks
  between;
- ``fill.cu``: ``tpbt_match_fill``, replacing the scatter and the forward
  fill of ``_device_match_decode`` (``tpu_blosc/device.py:1248-1357``);
  two paths that ``fill_path`` picks between.

nvcc compiles each source for ``sm_90a``, all at once, into
``tpu_blosc_torch/_build/`` at the first launch; a change to any source
rebuilds the library.  Nothing here is built or loaded when the module is
imported.

Each wrapper takes CUDA tensors only, launches on PyTorch's current
stream, and raises when the launch is refused.  ``launches`` counts the
launches of each kernel (and of each path of the shuffle and match
kernels, as ``"shuffle_blocks.vec16"`` and the like), so a caller can show
that a path went through it.  The plain PyTorch versions live in ``filters/batched.py``,
``filters/match.py``, ``filters/probe.py``, ``filters/rle.py`` and
``filters/fill.py``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import threading

import torch

from .. import buildlib

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
SOURCES = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
LIB_PATH = os.path.join(buildlib.BUILD_DIR, "libtpbt_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
]

# the shuffle pair's paths, as csrc/shuffle.cu numbers them
SHUFFLE_PATHS = {"generic": 0, "vec16": 1}
VEC16_TYPE_SIZES = (2, 4, 8, 16)
# the match kernels' paths, as csrc/match.cu numbers them
MATCH_PATHS = {"generic": 0, "vec16": 1}
# the rle kernels' and the fill kernel's paths, as csrc/rle.cu and
# csrc/fill.cu number them
RLE_PATHS = {"generic": 0, "vec16": 1}
FILL_PATHS = {"generic": 0, "vec16": 1}

# launches of each kernel since the last reset_launches()
launches = {"shuffle_blocks": 0, "unshuffle_blocks": 0, "match_nibble": 0,
            "match_count": 0, "probe_tiles": 0, "bit_shuffle_blocks": 0,
            "bit_unshuffle_blocks": 0, "seg_run_counts": 0, "rows_rle": 0,
            "match_fill": 0}
launches.update({f"{kernel}.{path}": 0 for kernel in ("shuffle_blocks", "unshuffle_blocks")
                 for path in SHUFFLE_PATHS})
launches.update({f"{kernel}.{path}": 0 for kernel in ("match_nibble", "match_count")
                 for path in MATCH_PATHS})
launches.update({f"{kernel}.{path}": 0 for kernel in ("seg_run_counts", "rows_rle")
                 for path in RLE_PATHS})
launches.update({f"match_fill.{path}": 0 for path in FILL_PATHS})

# the mask kernel's window bounds the run length (csrc/match.cu kMaxT)
MATCH_MAX_T = 9
# the count kernel's offsets per launch (csrc/match.cu kMaxOffsets)
MATCH_MAX_OFFSETS = 32
# the longest segment the match kernels take (32-bit positions with room
# for a tile past the row: csrc/match.cu refuse)
MATCH_MAX_SEG = 2**31 - 1 - 2 * 16384
# the largest offset the fill kernel takes (csrc/fill.cu kMaxD): the
# largest candidate of match.match_offsets
FILL_MAX_D = 1024
# the positions of a row the fill kernel takes at a time (csrc/fill.cu
# kTile): what lies on both sides of a multiple of it meets in the
# kernel's halo
FILL_TILE = 8192
# the probe's layout: int32 words per row, rows per 1 MiB tile
PROBE_LANES = 512
PROBE_TILE_ROWS = 512

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
    """The kernel library, built first if a source changed."""
    global _lib, build_seconds
    if _lib is None:
        with _load_lock:
            if _lib is None:
                objects = [
                    os.path.join(buildlib.BUILD_DIR, os.path.basename(src) + ".o")
                    for src in SOURCES
                ]
                build_seconds = buildlib.ensure_built(
                    LIB_PATH, SOURCES,
                    [[nvcc(), "-shared", *objects, "-o", buildlib.OUT]],
                    together=[
                        [nvcc(), *NVCC_FLAGS, "-c", src, "-o", obj]
                        for src, obj in zip(SOURCES, objects)
                    ],
                )
                handle = ctypes.CDLL(LIB_PATH)
                p, i64 = ctypes.c_void_p, ctypes.c_int64
                for name, argtypes in (
                    ("tpbt_shuffle_blocks", [p, p, i64, i64, i64, ctypes.c_int, p]),
                    ("tpbt_unshuffle_blocks", [p, p, p, i64, i64, i64, ctypes.c_int, p]),
                    ("tpbt_match_nibble", [p, p, p, i64, i64, i64, i64, ctypes.c_int, p]),
                    ("tpbt_match_mask", [p, p, p, p, i64, i64, i64, i64, ctypes.c_int, p]),
                    ("tpbt_match_count", [p, p, p, p, i64, i64, i64, ctypes.c_int, p]),
                    ("tpbt_probe_tiles", [p, i64, p, p]),
                    ("tpbt_bitshuffle_blocks", [p, p, i64, i64, i64, p]),
                    ("tpbt_bitunshuffle_blocks", [p, p, p, i64, i64, i64, p]),
                    ("tpbt_seg_run_counts", [p, p, i64, i64, ctypes.c_int, p]),
                    ("tpbt_rows_rle", [p, p, p, p, p, p, i64, i64, i64, ctypes.c_int, p]),
                    ("tpbt_match_fill", [p, p, p, p, p, i64, i64, ctypes.c_int, p]),
                ):
                    fn = getattr(handle, name)
                    fn.restype = ctypes.c_int
                    fn.argtypes = argtypes
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


def check_bit_blocks(blocks: torch.Tensor, type_size: int) -> None:
    """The geometry every bit-shuffle route takes: check_blocks', and
    whole groups of 8 elements, ``bs % (8 * type_size) == 0``."""
    check_blocks(blocks, type_size)
    if blocks.shape[1] % (8 * type_size):
        raise ValueError(
            f"block size {blocks.shape[1]} is not a multiple of 8*type_size "
            f"({8 * type_size})"
        )


def shuffle_path(bs: int, type_size: int, src_ptr: int, dst_ptr: int) -> str:
    """The shuffle pair's path for (nb, bs) blocks at these addresses:
    "vec16" where type_size is 2, 4, 8 or 16, bs/type_size is a multiple
    of 16, bs < 2**31 and both pointers lie on 16-byte boundaries;
    "generic" everywhere else.  The launchers check the same conditions
    and refuse "vec16" where they do not hold."""
    ok = (type_size in VEC16_TYPE_SIZES and bs // type_size % 16 == 0
          and bs < 1 << 31 and src_ptr % 16 == 0 and dst_ptr % 16 == 0)
    return "vec16" if ok else "generic"


def match_path(seg: int, segs_ptr: int, out_ptr: int = 0) -> str:
    """The match kernels' path for rows of ``seg`` bytes at these
    addresses (the count kernel's output needs no alignment: 0):
    "vec16" where seg is a multiple of 64 and both pointers lie on 16-byte
    boundaries, "generic" everywhere else.  The launchers check the same
    conditions and refuse "vec16" where they do not hold."""
    ok = seg % 64 == 0 and segs_ptr % 16 == 0 and out_ptr % 16 == 0
    return "vec16" if ok else "generic"


def rle_path(seg: int, segs_ptr: int) -> str:
    """The rle kernels' path for rows of ``seg`` bytes at this address:
    "vec16" where seg is a multiple of 16 and the pointer lies on a
    16-byte boundary, "generic" everywhere else.  The launchers check the
    same conditions and refuse "vec16" where they do not hold."""
    return "vec16" if seg % 16 == 0 and segs_ptr % 16 == 0 else "generic"


def fill_path(seg: int, out_ptr: int) -> str:
    """The fill kernel's path for rows of ``seg`` bytes written at this
    address: "vec16" or "generic", by rle_path's rule."""
    return rle_path(seg, out_ptr)


def check_rle_segs(segs: torch.Tensor) -> None:
    """The geometry every route of the rle kernels takes: a contiguous
    (nseg, seg) uint8 tensor with 1 <= seg <= MATCH_MAX_SEG."""
    if segs.dtype != torch.uint8 or segs.dim() != 2 or not segs.is_contiguous():
        raise ValueError("segs must be a contiguous 2-D uint8 tensor")
    if not 1 <= segs.shape[1] <= MATCH_MAX_SEG:
        raise ValueError(f"segment length {segs.shape[1]} is not in 1..{MATCH_MAX_SEG}")


def check_rows_args(segs: torch.Tensor, rows: torch.Tensor, bases: torch.Tensor) -> None:
    """check_rle_segs', and the chosen rows as a (k,) int64 tensor with
    their record bases as a (k + 1,) int64 tensor, both on segs' device."""
    check_rle_segs(segs)
    for name, t in (("rows", rows), ("bases", bases)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 tensor")
        if t.device != segs.device:
            raise ValueError(f"{name} is on {t.device}, segs on {segs.device}")
    if bases.shape[0] != rows.shape[0] + 1:
        raise ValueError(f"bases must have {rows.shape[0] + 1} entries, got {bases.shape[0]}")


def check_fill_args(pos: torch.Tensor, vals: torch.Tensor, row_first: torch.Tensor,
                    row_d: torch.Tensor, nseg: int, seg: int) -> None:
    """The geometry every route of the fill takes: (n_lit,) int32
    positions with their (n_lit,) uint8 bytes, (nseg + 1,) int64 first
    records and (nseg,) int32 offsets, contiguous and on one device;
    nseg >= 0, seg >= 1 and nseg * seg < 2**31 (positions are int32)."""
    if nseg < 0 or seg < 1 or nseg * seg >= 2**31:
        raise ValueError(f"need nseg >= 0, seg >= 1 and nseg * seg < 2**31, got {nseg}, {seg}")
    shapes = (("pos", pos, torch.int32, pos.shape[:1]), ("vals", vals, torch.uint8, pos.shape[:1]),
              ("row_first", row_first, torch.int64, (nseg + 1,)),
              ("row_d", row_d, torch.int32, (nseg,)))
    for name, t, dtype, shape in shapes:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)}")
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, pos on {pos.device}")


def _check_segs(segs: torch.Tensor, least: int) -> None:
    if segs.dtype != torch.uint8 or segs.dim() != 2 or not segs.is_contiguous():
        raise ValueError("segs must be a contiguous 2-D uint8 tensor")
    seg = segs.shape[1]
    if seg < least or seg % 4 or seg > MATCH_MAX_SEG:
        raise ValueError(f"segment length {seg} is not a multiple of 4 from {least} "
                         f"to {MATCH_MAX_SEG}")


def check_count_args(segs: torch.Tensor, offsets) -> None:
    """The geometry every route of the count phase takes: contiguous
    (nseg, seg) uint8 with seg % 4 == 0, and 1 to 32 integer offsets d
    with 1 <= d < seg."""
    _check_segs(segs, 4)
    seg = segs.shape[1]
    if not 1 <= len(offsets) <= MATCH_MAX_OFFSETS:
        raise ValueError(f"need 1 to {MATCH_MAX_OFFSETS} offsets, got {len(offsets)}")
    if not all(isinstance(d, int) and 1 <= d < seg for d in offsets):
        raise ValueError(f"every offset must be an int d with 1 <= d < {seg}, got {offsets}")


def check_match_args(segs: torch.Tensor, row_d: torch.Tensor, tail: int,
                     T: int) -> None:
    """The geometry every route takes: contiguous (nseg, seg) uint8 with
    seg % 4 == 0 and seg >= T, a (nseg,) int32 offset per row on the same
    device, ``tail >= 0`` and ``1 <= T <= 9``."""
    if tail < 0 or not 1 <= T <= MATCH_MAX_T:
        raise ValueError(f"need tail >= 0 and 1 <= T <= {MATCH_MAX_T}, got {tail}, {T}")
    _check_segs(segs, max(T, 4))
    nseg = segs.shape[0]
    if row_d.dtype != torch.int32 or row_d.shape != (nseg,) or not row_d.is_contiguous():
        raise ValueError(f"row_d must be a contiguous int32 tensor of shape ({nseg},)")
    if row_d.device != segs.device:
        raise ValueError(f"row_d is on {row_d.device}, segs on {segs.device}")


def check_words(words: torch.Tensor) -> None:
    """The probe's layout, on every route: a contiguous (rows, 512)
    int32 tensor."""
    if (words.dtype != torch.int32 or words.dim() != 2
            or words.shape[1] != PROBE_LANES):
        raise TypeError("device arrays must be (rows, 512) int32; use probe_ready()")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")


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


def _keep_ptr(keep_raw: torch.Tensor | None, blocks: torch.Tensor) -> int | None:
    """The device address of a (nb,) bool ``keep_raw``, None for none."""
    if keep_raw is None:
        return None
    nb = blocks.shape[0]
    _check_cuda(keep_raw, blocks.device, "keep_raw")
    if keep_raw.dtype != torch.bool or keep_raw.shape != (nb,) or not keep_raw.is_contiguous():
        raise ValueError(f"keep_raw must be a contiguous bool tensor of shape ({nb},)")
    return keep_raw.data_ptr()


def _raise_if_failed(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {t.device}")


@functools.lru_cache(maxsize=32)
def offsets_tensor(offsets: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``offsets`` as an int32 tensor on ``device``, made once for each
    list and device: copying a list to the card makes the host wait for
    the stream."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def _named_path(path: str | None, picked: str, paths: dict, what: str) -> str:
    if path is None:
        return picked
    if path not in paths:
        raise ValueError(f"unknown {what} path {path!r}; expected one of {list(paths)}")
    return path


def _pick_match_path(path: str | None, segs: torch.Tensor, out_ptr: int = 0) -> str:
    return _named_path(path, match_path(segs.shape[1], segs.data_ptr(), out_ptr),
                       MATCH_PATHS, "match")


def _pick_path(path: str | None, blocks: torch.Tensor, type_size: int,
               out: torch.Tensor) -> str:
    picked = shuffle_path(blocks.shape[1], type_size, blocks.data_ptr(), out.data_ptr())
    return _named_path(path, picked, SHUFFLE_PATHS, "shuffle")


def shuffle_blocks(blocks: torch.Tensor, type_size: int,
                   out: torch.Tensor | None = None,
                   path: str | None = None) -> torch.Tensor:
    """Byte-shuffle each row of a CUDA (nb, bs) uint8 tensor, on the path
    ``shuffle_path`` picks unless ``path`` names one."""
    _require_cuda(blocks)
    check_blocks(blocks, type_size)
    out = _output(blocks, out)
    nb, bs = blocks.shape
    if nb == 0:
        return out
    path = _pick_path(path, blocks, type_size, out)
    with torch.cuda.device(blocks.device):
        rc = lib().tpbt_shuffle_blocks(
            blocks.data_ptr(), out.data_ptr(), nb, bs, type_size,
            SHUFFLE_PATHS[path], torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, f"tpbt_shuffle_blocks ({path} path)")
    launches["shuffle_blocks"] += 1
    launches[f"shuffle_blocks.{path}"] += 1
    return out


def unshuffle_blocks(blocks: torch.Tensor, type_size: int,
                     keep_raw: torch.Tensor | None = None,
                     out: torch.Tensor | None = None,
                     path: str | None = None) -> torch.Tensor:
    """Inverse of shuffle_blocks; rows where ``keep_raw`` (a (nb,) bool
    tensor) is True are copied verbatim."""
    _require_cuda(blocks)
    check_blocks(blocks, type_size)
    out = _output(blocks, out)
    nb, bs = blocks.shape
    keep_ptr = _keep_ptr(keep_raw, blocks)
    if nb == 0:
        return out
    path = _pick_path(path, blocks, type_size, out)
    with torch.cuda.device(blocks.device):
        rc = lib().tpbt_unshuffle_blocks(
            blocks.data_ptr(), out.data_ptr(), keep_ptr, nb, bs, type_size,
            SHUFFLE_PATHS[path], torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, f"tpbt_unshuffle_blocks ({path} path)")
    launches["unshuffle_blocks"] += 1
    launches[f"unshuffle_blocks.{path}"] += 1
    return out


def bit_shuffle_blocks(blocks: torch.Tensor, type_size: int,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Bit-shuffle each row of a CUDA (nb, bs) uint8 tensor, in the
    reference's local groups of 8 elements; ``bs % (8 * type_size)`` must
    be 0."""
    _require_cuda(blocks)
    check_bit_blocks(blocks, type_size)
    out = _output(blocks, out)
    nb, bs = blocks.shape
    if nb == 0:
        return out
    with torch.cuda.device(blocks.device):
        rc = lib().tpbt_bitshuffle_blocks(
            blocks.data_ptr(), out.data_ptr(), nb, bs, type_size,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, "tpbt_bitshuffle_blocks")
    launches["bit_shuffle_blocks"] += 1
    return out


def bit_unshuffle_blocks(blocks: torch.Tensor, type_size: int,
                         keep_raw: torch.Tensor | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of bit_shuffle_blocks; rows where ``keep_raw`` (a (nb,)
    bool tensor) is True are copied verbatim."""
    _require_cuda(blocks)
    check_bit_blocks(blocks, type_size)
    out = _output(blocks, out)
    nb, bs = blocks.shape
    keep_ptr = _keep_ptr(keep_raw, blocks)
    if nb == 0:
        return out
    with torch.cuda.device(blocks.device):
        rc = lib().tpbt_bitunshuffle_blocks(
            blocks.data_ptr(), out.data_ptr(), keep_ptr, nb, bs, type_size,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, "tpbt_bitunshuffle_blocks")
    launches["bit_unshuffle_blocks"] += 1
    return out


def match_nibble(segs: torch.Tensor, row_d: torch.Tensor, tail: int,
                 T: int, path: str | None = None) -> torch.Tensor:
    """Literal-mask nibbles of a CUDA (nseg, seg) uint8 tensor at each
    row's offset ``row_d`` (a (nseg,) int32 CUDA tensor): an (nseg,
    seg/4) uint8 tensor whose byte j holds bit t = byte 4j+t is literal.
    On the path ``match_path`` picks unless ``path`` names one."""
    _require_cuda(segs)
    check_match_args(segs, row_d, tail, T)
    nseg, seg = segs.shape
    out = torch.empty((nseg, seg // 4), dtype=torch.uint8, device=segs.device)
    if nseg == 0:
        return out
    path = _pick_match_path(path, segs, out.data_ptr())
    with torch.cuda.device(segs.device):
        rc = lib().tpbt_match_nibble(
            segs.data_ptr(), row_d.data_ptr(), out.data_ptr(), nseg, seg,
            tail, T, MATCH_PATHS[path], torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, f"tpbt_match_nibble ({path} path)")
    launches["match_nibble"] += 1
    launches[f"match_nibble.{path}"] += 1
    return out


def match_mask(segs: torch.Tensor, row_d: torch.Tensor, tail: int, T: int,
               path: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(lit_counts, packed) of the same mask, by the same kernel, in the
    form the match strategy ships: each row's literal count (int32), and
    (nseg, seg/8) bytes whose byte j holds bit i = byte 8j+i is literal.
    seg must be a multiple of 8.  Counted as a launch of ``match_nibble``."""
    _require_cuda(segs)
    check_match_args(segs, row_d, tail, T)
    nseg, seg = segs.shape
    if seg % 8:
        raise ValueError(f"the packed mask holds 8 bytes a bit-byte; seg={seg} % 8 != 0")
    packed = torch.empty((nseg, seg // 8), dtype=torch.uint8, device=segs.device)
    lit_counts = torch.zeros((nseg,), dtype=torch.int32, device=segs.device)
    if nseg == 0:
        return lit_counts, packed
    path = _pick_match_path(path, segs, packed.data_ptr())
    with torch.cuda.device(segs.device):
        rc = lib().tpbt_match_mask(
            segs.data_ptr(), row_d.data_ptr(), packed.data_ptr(), lit_counts.data_ptr(),
            nseg, seg, tail, T, MATCH_PATHS[path], torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, f"tpbt_match_mask ({path} path)")
    launches["match_nibble"] += 1
    launches[f"match_nibble.{path}"] += 1
    return lit_counts, packed


def match_count(segs: torch.Tensor, offsets: tuple[int, ...],
                path: str | None = None) -> torch.Tensor:
    """Per row of a CUDA (nseg, seg) uint8 tensor, the index into
    ``offsets`` of the offset d with the most p >= d where x[p] ==
    x[p-d], as an int64 tensor: the lowest such index, and 0 for a row
    with no equal bytes.  On the path ``match_path`` picks unless
    ``path`` names one."""
    _require_cuda(segs)
    check_count_args(segs, offsets)
    nseg, seg = segs.shape
    best = torch.empty((nseg,), dtype=torch.int64, device=segs.device)
    if nseg == 0:
        return best
    path = _pick_match_path(path, segs)
    offs = offsets_tensor(tuple(offsets), segs.device)
    counts = torch.zeros((nseg, len(offsets)), dtype=torch.int32, device=segs.device)
    with torch.cuda.device(segs.device):
        rc = lib().tpbt_match_count(
            segs.data_ptr(), offs.data_ptr(), counts.data_ptr(), best.data_ptr(),
            nseg, seg, len(offsets), MATCH_PATHS[path],
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, f"tpbt_match_count ({path} path)")
    launches["match_count"] += 1
    launches[f"match_count.{path}"] += 1
    return best


def probe_tiles(words: torch.Tensor) -> torch.Tensor:
    """Per-tile (runs, byte sum) of a CUDA (tiles*512, 512) int32 tensor,
    as a (tiles, 2) int32 tensor; rows past the last whole tile are not
    read."""
    _require_cuda(words)
    check_words(words)
    if words.data_ptr() % 16:
        raise ValueError("words must start on a 16-byte boundary")
    tiles = words.shape[0] // PROBE_TILE_ROWS
    out = torch.zeros((tiles, 2), dtype=torch.int32, device=words.device)
    if tiles == 0:
        return out
    with torch.cuda.device(words.device):
        rc = lib().tpbt_probe_tiles(
            words.data_ptr(), tiles, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, "tpbt_probe_tiles")
    launches["probe_tiles"] += 1
    return out


def seg_run_counts(segs: torch.Tensor, path: str | None = None) -> torch.Tensor:
    """Per row of a CUDA (nseg, seg) uint8 tensor, its runs: 1 + the
    number of p >= 1 with x[p] != x[p-1], as an int32 tensor.  On the path
    ``rle_path`` picks unless ``path`` names one."""
    _require_cuda(segs)
    check_rle_segs(segs)
    nseg, seg = segs.shape
    counts = torch.zeros((nseg,), dtype=torch.int32, device=segs.device)
    if nseg == 0:
        return counts
    path = _named_path(path, rle_path(seg, segs.data_ptr()), RLE_PATHS, "rle")
    with torch.cuda.device(segs.device):
        rc = lib().tpbt_seg_run_counts(
            segs.data_ptr(), counts.data_ptr(), nseg, seg, RLE_PATHS[path],
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, f"tpbt_seg_run_counts ({path} path)")
    launches["seg_run_counts"] += 1
    launches[f"seg_run_counts.{path}"] += 1
    return counts


def rows_rle(segs: torch.Tensor, rows: torch.Tensor, bases: torch.Tensor,
             n_runs: int, path: str | None = None):
    """(vals, lens, bad) of the rows ``rows`` (a (k,) int64 CUDA tensor)
    of a CUDA (nseg, seg) uint8 tensor: every run's byte (uint8) and
    length (int32), row after row in the order given; row j's records
    start at ``bases[j]`` (a (k + 1,) int64 CUDA tensor: the exclusive sum
    of the rows' run counts, ``bases[k] == n_runs``).  ``bad`` is a
    one-element int32 CUDA tensor, 1 when some row's runs were not its
    count (the records are then not to be used), and reading it waits for
    the kernel.  On the path ``rle_path`` picks unless ``path`` names
    one."""
    _require_cuda(segs)
    check_rows_args(segs, rows, bases)
    if n_runs < 0:
        raise ValueError(f"n_runs must be >= 0, got {n_runs}")
    nseg, seg = segs.shape
    k = rows.shape[0]
    vals = torch.empty((n_runs,), dtype=torch.uint8, device=segs.device)
    lens = torch.empty((n_runs,), dtype=torch.int32, device=segs.device)
    bad = torch.zeros((1,), dtype=torch.int32, device=segs.device)
    if k == 0:
        return vals, lens, bad
    path = _named_path(path, rle_path(seg, segs.data_ptr()), RLE_PATHS, "rle")
    with torch.cuda.device(segs.device):
        rc = lib().tpbt_rows_rle(
            segs.data_ptr(), rows.data_ptr(), bases.data_ptr(), vals.data_ptr(),
            lens.data_ptr(), bad.data_ptr(), nseg, seg, k, RLE_PATHS[path],
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, f"tpbt_rows_rle ({path} path)")
    launches["rows_rle"] += 1
    launches[f"rows_rle.{path}"] += 1
    return vals, lens, bad


def match_fill(pos: torch.Tensor, vals: torch.Tensor, row_first: torch.Tensor,
               row_d: torch.Tensor, nseg: int, seg: int,
               out: torch.Tensor | None = None, path: str | None = None) -> torch.Tensor:
    """The (nseg, seg) uint8 stream of literal records on the card:
    ``pos`` are the literals' sorted, unique flat positions (int32),
    ``vals`` their bytes, row r's records ``pos[row_first[r] :
    row_first[r+1]]`` (int64) and its offset ``row_d[r]`` (int32, 1 to
    FILL_MAX_D); out[r, i] is the literal at i, else out[r, i - d], 0
    below d.  The result goes to ``out`` when given.  On the path
    ``fill_path`` picks unless ``path`` names one."""
    _require_cuda(pos)
    check_fill_args(pos, vals, row_first, row_d, nseg, seg)
    if out is None:
        out = torch.empty((nseg, seg), dtype=torch.uint8, device=pos.device)
    else:
        _check_cuda(out, pos.device, "out")
        if out.dtype != torch.uint8 or tuple(out.shape) != (nseg, seg) or not out.is_contiguous():
            raise ValueError(f"out must be a contiguous uint8 tensor of shape ({nseg}, {seg})")
    if nseg == 0:
        return out
    path = _named_path(path, fill_path(seg, out.data_ptr()), FILL_PATHS, "fill")
    with torch.cuda.device(pos.device):
        rc = lib().tpbt_match_fill(
            pos.data_ptr(), vals.data_ptr(), row_first.data_ptr(), row_d.data_ptr(),
            out.data_ptr(), nseg, seg, FILL_PATHS[path],
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, f"tpbt_match_fill ({path} path)")
    launches["match_fill"] += 1
    launches[f"match_fill.{path}"] += 1
    return out
