"""The plain reference of a training state's checkpoint: ``checkpoint_file.py``'s reading, with a draw that covers every kind of leaf record.

A training state holds leaves of more than one floating dtype (fp32
master weights beside bf16 moments), each written at a type size of its
own.  ``checkpoint_file.py`` decodes one multi-block leaf of any dtype;
this module decodes every int64 leaf, one multi-block leaf of each dtype
that has one no larger than half the budget, one single-block leaf other
than those, then drawn leaves up to the budget, as ``checkpoint_file.py``
draws them.  Everything else (the TPBS layout, the manifest, every
record's header and the decoding) is ``checkpoint_file.py``'s, unchanged:
this module loads a copy of that file of its own and hands the copy this
draw.  It imports no part of tpu_blosc_torch.

``make(config)`` is what the benchmark calls: ``reference(path, seed)``
returns ``checkpoint_file.py``'s reading, ``{"leaves", "values",
"decoded"}``, and ``"kinds"``: {kind: the leaf decoded for it}, with the
kinds ``"int64"``, ``"single_block"`` and ``"multi_block/<dtype>"``; it
raises ``FileError`` (a ValueError) for a file that does not keep to the
layout.
"""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def _checkpoint_file():
    """A copy of ``checkpoint_file.py`` of this module's own."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_reference_train_state_checkpoint_file",
        os.path.join(HERE, "checkpoint_file.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BASE = _checkpoint_file()
FileError = BASE.FileError


def draw(rng, sizes: dict, split: dict, dtypes: dict, budget: int, kinds: dict) -> list:
    """The leaves to decode (the module's docstring), each kind's leaf
    put in ``kinds``."""
    small = [p for p in sizes if sizes[p] <= budget // 2]
    chosen = [p for p in sizes if dtypes[p] == "int64"]
    if chosen:
        kinds["int64"] = chosen[0]
    groups = {f"multi_block/{d}": [p for p in small if split[p] and dtypes[p] == d]
              for d in sorted({dtypes[p] for p in small if split[p]})}
    groups["single_block"] = [p for p in small if not split[p]]
    for kind, group in groups.items():
        left = [p for p in group if p not in chosen]
        if left:
            kinds[kind] = rng.choice(left)
            chosen.append(kinds[kind])
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
    """The checkpoint at ``path`` as ``checkpoint_file.read`` reads it,
    with this module's draw, and the kinds it covered."""
    kinds: dict = {}
    BASE._sample = lambda rng, sizes, split, dtypes, budget: draw(
        rng, sizes, split, dtypes, budget, kinds)
    reading = BASE.read(path, seed, codec_id, shuffle, sample_bytes)
    reading["kinds"] = kinds
    return reading


def make(config: dict):
    """The reference of a training-state configuration: (path, seed) ->
    the reading of ``read`` with the configuration's codec ID, filter and
    sample size."""
    ref, opts = config["reference"], config["options"]
    return lambda path, seed: read(path, seed, ref["codec_id"], opts["shuffle"],
                                   ref["sample_bytes"])
