"""The plain reference of a checkpoint: a TPBS file read as any reader of its layout would.

It knows the layout and nothing of the program: it imports no part of
tpu_blosc_torch and takes only the file's path.  Blosc frames are read
by ``blosc_frame.py`` beside it, and their payloads decoded by the codec
module of the codec ID they state (``lz4.py`` for LZ4 and LZ4HC,
``zstd.py`` for ZSTD).

The file (little-endian):

    bytes 0-3   magic b"TPBS"
    byte  4     stream version, 1
    byte  5     flags: bit 0 set where every record carries a crc32
    bytes 6-7   zero
    records     each a uint64 length, then that many bytes of frame, then
                its uint32 crc32 under flag bit 0
    footer      uint64 count, count x uint64 record offsets (from the
                start of the file), uint64 bytes of the footer, b"TPBI"

The records lie back to back from byte 8 to the footer, and the footer's
offsets are theirs, in order.  A checkpoint's record 0 is a JSON manifest
(UTF-8): ``{"version": 1, "tree": node, "leaves": n}`` with n + 1
records in the file.  A node is ``{"t": "dict", "items": [[key, node],
...]}``, ``{"t": "list" | "tuple", "items": [node, ...]}``, ``{"t":
"raw", "v": value}``, ``{"t": "array0", "dtype": name, "shape": [...]}``
(an array with no elements, no record) or ``{"t": "array", "i": k,
"dtype": name, "shape": [...]}``: array leaf k is record k + 1, a Blosc
frame of the leaf's bytes in C order at a type size of its element size.
Every k from 0 to n - 1 appears once.  A leaf's path is its keys and list
positions joined by "/", as ``params/h/0/attn/c_attn/w``.

``make(config)`` is what the benchmark calls: ``reference(path, seed)``
reads the header, the records' layout, the footer, the manifest and every
leaf record's 16-byte frame header, which must state the configuration's
codec and filter, the leaf's element size and its bytes; it then decodes
a sample of the leaf records that the seed draws, about
``sample_bytes`` of leaves: every int64 leaf, one multi-block leaf, one
single-block leaf and further leaves, none larger than half the budget.
It returns ``{"leaves": {path: (dtype, shape)}, "values": {path: value},
"decoded": {path: uint8 array}}``, or raises ``FileError`` (a
ValueError) for a file that does not keep to the layout.
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MAGIC, FOOTER_MAGIC, VERSION, FLAG_CRC = b"TPBS", b"TPBI", 1, 0x1
MANIFEST_VERSION = 1
CODEC_MODULES = {1: "lz4", 2: "lz4", 5: "zstd"}
ITEMSIZE = {"bool": 1, "int8": 1, "uint8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
            "int16": 2, "uint16": 2, "float16": 2, "bfloat16": 2, "int32": 4, "uint32": 4,
            "float32": 4, "int64": 8, "uint64": 8, "float64": 8, "complex64": 8,
            "complex128": 16}


class FileError(ValueError):
    """The file is not a checkpoint that keeps to the layout."""


def _module(name: str):
    """``<name>.py`` beside this file."""
    spec = importlib.util.spec_from_file_location(f"benchmark_reference_ckpt_{name}",
                                                  os.path.join(HERE, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BLOSC = _module("blosc_frame")


def _record_offsets(f, size: int) -> tuple[list, int]:
    """The records' (offset, frame length) from byte 8 to the footer, held
    to the footer's index; and whether they carry a crc32."""
    head = f.read(8)
    if len(head) < 8 or head[:4] != MAGIC or head[4] != VERSION or head[6:] != b"\0\0" \
            or head[5] & ~FLAG_CRC:
        raise FileError(f"not a TPBS stream of version {VERSION}: {head!r}")
    crc = head[5] & FLAG_CRC
    if size < 8 + 20:
        raise FileError("no footer")
    f.seek(size - 12)
    index_bytes, magic = struct.unpack("<Q4s", f.read(12))
    start = size - index_bytes
    if magic != FOOTER_MAGIC or not 8 <= start <= size - 20:
        raise FileError(f"footer magic {magic!r}, {index_bytes} bytes")
    f.seek(start)
    (count,) = struct.unpack("<Q", f.read(8))
    if index_bytes != 20 + 8 * count:
        raise FileError(f"a footer of {index_bytes} bytes for {count} records")
    index = list(struct.unpack(f"<{count}Q", f.read(8 * count)))
    walked, pos = [], 8
    while pos < start:
        f.seek(pos)
        length = f.read(8)
        if len(length) < 8:
            raise FileError(f"a record's length at {pos} runs past the data")
        (n,) = struct.unpack("<Q", length)
        walked.append((pos, n))
        pos += 8 + n + 4 * crc
    if pos != start or [p for p, _ in walked] != index:
        raise FileError("the footer's offsets are not the records'")
    return walked, crc


def _frame(f, at: tuple, crc: int) -> bytes:
    pos, n = at
    f.seek(pos + 8)
    frame = f.read(n)
    if crc:
        (want,) = struct.unpack("<I", f.read(4))
        if zlib.crc32(frame) != want:
            raise FileError(f"the record at {pos} fails its crc32")
    return frame


def _filter_name(flags: int) -> str:
    if flags & BLOSC.FLAG_BITSHUFFLE:
        return "BITSHUFFLE"
    return "SHUFFLE" if flags & BLOSC.FLAG_SHUFFLE else "NOSHUFFLE"


def _walk(node, path: str, leaves: dict, values: dict, records: dict) -> None:
    t = node.get("t") if isinstance(node, dict) else None
    if t == "dict":
        for key, child in node["items"]:
            _walk(child, f"{path}/{key}" if path else key, leaves, values, records)
    elif t in ("list", "tuple"):
        for k, child in enumerate(node["items"]):
            _walk(child, f"{path}/{k}" if path else str(k), leaves, values, records)
    elif t == "raw":
        values[path] = node["v"]
    elif t in ("array", "array0"):
        if node["dtype"] not in ITEMSIZE:
            raise FileError(f"leaf {path}: dtype {node['dtype']!r}")
        leaves[path] = (node["dtype"], tuple(node["shape"]))
        if t == "array":
            records[path] = node["i"]
    else:
        raise FileError(f"manifest node {node!r} at {path!r}")


def _sample(rng: random.Random, sizes: dict, split: dict, dtypes: dict, budget: int) -> list:
    """The leaves to decode: every int64 leaf, one multi-block and one
    single-block leaf, then drawn leaves until ``budget`` bytes."""
    small = [p for p in sizes if sizes[p] <= budget // 2]
    chosen = [p for p in sizes if dtypes[p] == "int64"]
    for group in ([p for p in small if split[p]], [p for p in small if not split[p]]):
        left = [p for p in group if p not in chosen]
        if left:
            chosen.append(rng.choice(left))
    rest = [p for p in small if p not in chosen]
    rng.shuffle(rest)
    total = sum(sizes[p] for p in chosen)
    for p in rest:
        if total >= budget:
            break
        chosen.append(p)
        total += sizes[p]
    return chosen


def read(path, seed: int, codec_id: int, shuffle: str, sample_bytes: int) -> dict:
    """The checkpoint at ``path``, its seed-drawn sample decoded (the
    module's docstring)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        at, crc = _record_offsets(f, size)
        if not at:
            raise FileError("no manifest record")
        manifest = _frame(f, at[0], crc)
        head = BLOSC.HEADER.unpack_from(manifest) if len(manifest) >= 16 else None
        if head is None or head[1] not in CODEC_MODULES:
            raise FileError("the manifest record is not a frame of a known codec")
        raw = BLOSC.decode(manifest, head[1], _filter_name(head[2]), head[3],
                           _module(CODEC_MODULES[head[1]]).decompress)
        try:
            meta = json.loads(raw.tobytes().decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as err:
            raise FileError(f"the manifest is not JSON: {err}") from None
        if not isinstance(meta, dict) or meta.get("version") != MANIFEST_VERSION \
                or meta.get("leaves") != len(at) - 1:
            raise FileError(f"manifest version {meta.get('version')!r}, "
                            f"{meta.get('leaves')!r} leaves for {len(at) - 1} records")
        leaves, values, records = {}, {}, {}
        try:
            _walk(meta.get("tree"), "", leaves, values, records)
        except (KeyError, TypeError, ValueError) as err:
            raise FileError(f"the manifest's tree: {err!r}") from None
        if sorted(records.values()) != list(range(len(at) - 1)):
            raise FileError("the manifest's leaves are not records 1 to n, each once")
        sizes, split = {}, {}
        for p, i in records.items():
            dtype, shape = leaves[p]
            sizes[p] = ITEMSIZE[dtype] * int(np.prod(shape, dtype=np.int64))
            pos, n = at[i + 1]
            f.seek(pos + 8)
            h = f.read(16)
            if len(h) < 16 or n < 16:
                raise FileError(f"leaf {p}: a record of {n} bytes")
            version, codec, flags, ts, orig, _, total = BLOSC.HEADER.unpack(h)
            stated = flags & (BLOSC.FLAG_SHUFFLE | BLOSC.FLAG_BITSHUFFLE)
            raw_single = flags & BLOSC.FLAG_RAW and not flags & BLOSC.FLAG_BLOCKS
            if (version, codec, ts, orig, total) != (2, codec_id, min(ITEMSIZE[dtype], 255),
                                                     sizes[p], n) \
                    or not (raw_single or stated == BLOSC.MODE_FLAGS[shuffle]):
                raise FileError(f"leaf {p}: frame header (version {version}, codec {codec}, "
                                f"flags {flags:#x}, type size {ts}, {orig} bytes, {total} of "
                                f"{n}) for {dtype} {shape}")
            split[p] = bool(flags & BLOSC.FLAG_BLOCKS)
        dtypes = {p: leaves[p][0] for p in records}
        decompress = _module(CODEC_MODULES[codec_id]).decompress
        decoded = {}
        for p in _sample(random.Random(seed), sizes, split, dtypes, sample_bytes):
            frame = _frame(f, at[records[p] + 1], crc)
            decoded[p] = BLOSC.decode(frame, codec_id, shuffle, ITEMSIZE[dtypes[p]],
                                      decompress)
    return {"leaves": leaves, "values": values, "decoded": decoded}


def make(config: dict):
    """The reference of a checkpoint configuration: (path, seed) -> the
    reading of ``read`` with the configuration's codec ID, filter and
    sample size."""
    ref, opts = config["reference"], config["options"]
    return lambda path, seed: read(path, seed, ref["codec_id"], opts["shuffle"],
                                   ref["sample_bytes"])
