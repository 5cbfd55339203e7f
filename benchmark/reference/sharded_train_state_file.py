"""The plain reference of a sharded training state's checkpoint: the set of one TPBS file a rank, read as any reader of the layout would.

It loads a copy of ``checkpoint_file.py`` of its own, as
``train_state_file.py`` does, and takes from it the TPBS layout (the
header, the records, the footer's index), the manifest's frame and the
frames' decoding; it imports no part of tpu_blosc_torch.  A set of ``n``
processes is ``{prefix}.p{p}.tpbs`` for p in 0..n-1, each a TPBS stream
whose record 0 is a JSON manifest (UTF-8)::

    {"version": 1, "tree": node, "leaf_records": [entry, ...], "process": p}

The tree's nodes are ``checkpoint_file.py``'s, and besides them
``{"t": "sharded_array", "i": k, "dtype": name, "shape": [...]}``: leaf k
sharded over the processes.  Leaf k is an "array" (a replicated leaf) or
a "sharded_array" node, each k from 0 to len(leaf_records) - 1 once.
Entry k of process p's ``leaf_records`` is ``{"k": "replicated", "n": 0
or 1}`` or ``{"k": "sharded", "n": m, "spans": [[[start, stop], ...],
...]}`` with m spans, one for each of the leaf's records in p's file:
its records follow the records of the leaves before it, in order, from
record 1.  A record is a Blosc frame of the span's bytes in C order at a
type size of the leaf's element size.

``make(config)`` is what the benchmark calls: ``reference(prefix,
seed)`` reads every file of the configuration's ``shard_ranks`` processes
and requires that

- each keeps to the layout, names itself as process p, and holds the
  tree of process 0's file;
- each record's 16-byte frame header states the configuration's codec
  and filter, the leaf's element size and the span's bytes;
- a replicated leaf has exactly one record in the set, and the spans of
  a sharded leaf lie inside its shape and tile it, with no hole and no
  overlap;

then decodes a sample of the shard records that the seed draws, about
``sample_bytes``: every int64 record, one single-block shard record, one
multi-block shard record of each floating dtype and every shard of one
whole leaf (each no larger than half the budget), then drawn shard
records up to the budget.  It returns ``{"leaves": {path: (dtype,
shape)}, "values": {path: value}, "spans": {path: {p: [span, ...]}},
"decoded": {(path, p): uint8 array of p's record of the leaf}, "whole":
{path: uint8 array of the leaf put together from all its shards},
"kinds": {kind: the leaf decoded for it}}``, with the kinds ``"int64"``,
``"single_block"``, ``"multi_block/<dtype>"`` and ``"whole_leaf"``, or
raises ``FileError`` (a ValueError) for a set that does not keep to the
layout.  A process writes at most one record of a leaf here (a shard
replicated over a mesh dimension is written once), so ``(path, p)``
names a record.
"""

from __future__ import annotations

import importlib.util
import json
import os
import random

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _checkpoint_file():
    """A copy of ``checkpoint_file.py`` of this module's own."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_reference_sharded_checkpoint_file", os.path.join(HERE, "checkpoint_file.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BASE = _checkpoint_file()
BLOSC = BASE.BLOSC
FileError = BASE.FileError


def _walk(node, path: str, leaves: dict, values: dict) -> None:
    """{path: (dtype, shape, node type, leaf index)} of the array leaves
    and {path: value} of the raw ones."""
    t = node.get("t") if isinstance(node, dict) else None
    if t == "dict":
        for key, child in node["items"]:
            _walk(child, f"{path}/{key}" if path else key, leaves, values)
    elif t in ("list", "tuple"):
        for k, child in enumerate(node["items"]):
            _walk(child, f"{path}/{k}" if path else str(k), leaves, values)
    elif t == "raw":
        values[path] = node["v"]
    elif t in ("array", "sharded_array", "array0"):
        if node["dtype"] not in BASE.ITEMSIZE:
            raise FileError(f"leaf {path}: dtype {node['dtype']!r}")
        leaves[path] = (node["dtype"], tuple(node["shape"]), t, node.get("i"))
    else:
        raise FileError(f"manifest node {node!r} at {path!r}")


def _manifest(f, at: list, crc: int, p: int) -> dict:
    frame = BASE._frame(f, at[0], crc)
    head = BLOSC.HEADER.unpack_from(frame) if len(frame) >= 16 else None
    if head is None or head[1] not in BASE.CODEC_MODULES:
        raise FileError(f"file {p}: the manifest record is not a frame of a known codec")
    raw = BLOSC.decode(frame, head[1], BASE._filter_name(head[2]), head[3],
                       BASE._module(BASE.CODEC_MODULES[head[1]]).decompress)
    try:
        meta = json.loads(raw.tobytes().decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as err:
        raise FileError(f"file {p}: the manifest is not JSON: {err}") from None
    if not isinstance(meta, dict) or meta.get("version") != BASE.MANIFEST_VERSION \
            or meta.get("process") != p or not isinstance(meta.get("leaf_records"), list):
        raise FileError(f"file {p}: manifest version {meta.get('version')!r}, process "
                        f"{meta.get('process')!r}")
    return meta


def _numel(span) -> int:
    return int(np.prod([b - a for a, b in span], dtype=np.int64))


def _inside(span, shape) -> bool:
    return len(span) == len(shape) and all(
        isinstance(a, int) and isinstance(b, int) and 0 <= a <= b <= n
        for (a, b), n in zip(span, shape))


def _overlap(s, t) -> bool:
    return all(max(a, c) < min(b, d) for (a, b), (c, d) in zip(s, t))


def _record_header(f, at: tuple, what: str, codec_id: int, shuffle: str, dtype: str,
                   nbytes: int) -> bool:
    """Check a record's frame header; whether it is a multi-block frame."""
    pos, n = at
    f.seek(pos + 8)
    h = f.read(16)
    if len(h) < 16 or n < 16:
        raise FileError(f"{what}: a record of {n} bytes")
    version, codec, flags, ts, orig, _, total = BLOSC.HEADER.unpack(h)
    stated = flags & (BLOSC.FLAG_SHUFFLE | BLOSC.FLAG_BITSHUFFLE)
    raw_single = flags & BLOSC.FLAG_RAW and not flags & BLOSC.FLAG_BLOCKS
    if (version, codec, ts, orig, total) != (2, codec_id, min(BASE.ITEMSIZE[dtype], 255),
                                             nbytes, n) \
            or not (raw_single or stated == BLOSC.MODE_FLAGS[shuffle]):
        raise FileError(f"{what}: frame header (version {version}, codec {codec}, flags "
                        f"{flags:#x}, type size {ts}, {orig} bytes, {total} of {n}) for "
                        f"{dtype}, {nbytes} bytes")
    return bool(flags & BLOSC.FLAG_BLOCKS)


def draw(rng: random.Random, items: dict, leaves: dict, budget: int, kinds: dict) -> list:
    """The records to decode (the module's docstring), each kind's leaf
    put in ``kinds``; ``items`` is {(path, p): (bytes, multi-block)}."""
    small = [k for k, (n, _) in items.items() if n <= budget // 2]
    chosen = [k for k in items if leaves[k[0]][0] == "int64"]
    if chosen:
        kinds["int64"] = chosen[0][0]
    sharded = [k for k in small if leaves[k[0]][2] == "sharded_array"]
    groups = {f"multi_block/{d}": [k for k in sharded if items[k][1] and leaves[k[0]][0] == d]
              for d in sorted({leaves[k[0]][0] for k in sharded if items[k][1]})}
    groups["single_block"] = [k for k in sharded if not items[k][1]]
    for kind, group in groups.items():
        left = [k for k in group if k not in chosen]
        if left:
            pick = rng.choice(left)
            kinds[kind] = pick[0]
            chosen.append(pick)
    sizes: dict = {}
    for (path, _), (n, _) in items.items():
        if leaves[path][2] == "sharded_array":
            sizes[path] = sizes.get(path, 0) + n
    whole = sorted(p for p, n in sizes.items() if n <= budget // 2)
    if whole:
        kinds["whole_leaf"] = rng.choice(whole)
        chosen += [k for k in items if k[0] == kinds["whole_leaf"] and k not in chosen]
    rest = [k for k in sharded if k not in chosen]
    rng.shuffle(rest)
    total = sum(items[k][0] for k in chosen)
    for k in rest:
        if total >= budget:
            break
        chosen.append(k)
        total += items[k][0]
    return chosen


def read(prefix, processes: int, seed: int, codec_id: int, shuffle: str,
         sample_bytes: int) -> dict:
    """The set ``{prefix}.p{p}.tpbs``, its seed-drawn sample decoded (the
    module's docstring)."""
    handles = []
    try:
        layouts, metas = [], []
        for p in range(processes):
            path = f"{prefix}.p{p}.tpbs"
            handles.append(open(path, "rb"))
            at, crc = BASE._record_offsets(handles[p], os.path.getsize(path))
            if not at:
                raise FileError(f"file {p}: no manifest record")
            layouts.append((at, crc))
            metas.append(_manifest(handles[p], at, crc, p))
            if metas[p]["tree"] != metas[0]["tree"] \
                    or len(metas[p]["leaf_records"]) != len(metas[0]["leaf_records"]):
                raise FileError(f"file {p}: its tree is not process 0's")
        leaves, values = {}, {}
        try:
            _walk(metas[0]["tree"], "", leaves, values)
        except (KeyError, TypeError, ValueError) as err:
            raise FileError(f"the manifest's tree: {err!r}") from None
        index = {v[3]: path for path, v in leaves.items() if v[2] != "array0"}
        if sorted(index) != list(range(len(metas[0]["leaf_records"]))):
            raise FileError("the manifest's leaves are not leaf_records 0 to n-1, each once")
        items, spans, where = {}, {}, {}
        for p, (meta, (at, _)) in enumerate(zip(metas, layouts)):
            record = 1
            for i, entry in enumerate(meta["leaf_records"]):
                path = index[i]
                dtype, shape, t, _ = leaves[path]
                n = entry.get("n") if isinstance(entry, dict) else None
                if not isinstance(n, int) or n < 0 or n > 1:
                    raise FileError(f"file {p}, leaf {path}: {entry!r}")
                if t == "array":
                    if entry.get("k") != "replicated":
                        raise FileError(f"file {p}, leaf {path}: {entry!r}")
                    piece = [[0, d] for d in shape]
                else:
                    got = entry.get("spans")
                    if entry.get("k") != "sharded" or not isinstance(got, list) \
                            or len(got) != n or not all(_inside(s, shape) for s in got):
                        raise FileError(f"file {p}, leaf {path}: {entry!r} for {shape}")
                    spans.setdefault(path, {})[p] = got
                    piece = got[0] if n else None
                if n:
                    if record >= len(at):
                        raise FileError(f"file {p}: fewer records than its manifest names")
                    nbytes = BASE.ITEMSIZE[dtype] * _numel(piece)
                    multi = _record_header(handles[p], at[record], f"file {p}, leaf {path}",
                                           codec_id, shuffle, dtype, nbytes)
                    items[(path, p)] = (nbytes, multi)
                    where[(path, p)] = (record, piece)
                record += n
            if record != len(at):
                raise FileError(f"file {p}: {len(at)} records for a manifest of {record}")
        for path, (dtype, shape, t, _) in leaves.items():
            if t == "array" and sum(k[0] == path for k in items) != 1:
                raise FileError(f"replicated leaf {path}: not one record in the set")
            if t == "sharded_array":
                held = [s for got in spans.get(path, {}).values() for s in got]
                if sum(_numel(s) for s in held) != _numel([[0, d] for d in shape]) or any(
                        _overlap(s, u) for j, s in enumerate(held) for u in held[j + 1:]):
                    raise FileError(f"sharded leaf {path}: its spans do not tile {shape}")
        kinds: dict = {}
        decompress = BASE._module(BASE.CODEC_MODULES[codec_id]).decompress
        decoded, whole = {}, {}
        for key in draw(random.Random(seed), items, leaves, sample_bytes, kinds):
            path, p = key
            dtype, shape = leaves[path][:2]
            record, _ = where[key]
            frame = BASE._frame(handles[p], layouts[p][0][record], layouts[p][1])
            decoded[key] = BLOSC.decode(frame, codec_id, shuffle, BASE.ITEMSIZE[dtype],
                                        decompress)
        if "whole_leaf" in kinds:
            path = kinds["whole_leaf"]
            dtype, shape = leaves[path][:2]
            size = BASE.ITEMSIZE[dtype]
            out = np.zeros((*shape, size), dtype=np.uint8)
            for p, got in spans[path].items():
                for s in got:
                    out[tuple(slice(a, b) for a, b in s)] = decoded[(path, p)].reshape(
                        *(b - a for a, b in s), size)
            whole[path] = out.reshape(-1)
    finally:
        for f in handles:
            f.close()
    return {"leaves": {p: v[:2] for p, v in leaves.items()}, "values": values,
            "spans": spans, "decoded": decoded, "whole": whole, "kinds": kinds}


def make(config: dict):
    """The reference of a sharded training-state configuration: (prefix,
    seed) -> the reading of ``read`` over the configuration's
    ``shard_ranks`` files, with its codec ID, filter and sample size."""
    ref, opts = config["reference"], config["options"]
    return lambda prefix, seed: read(prefix, config["shard_ranks"], seed, ref["codec_id"],
                                     opts["shuffle"], ref["sample_bytes"])
