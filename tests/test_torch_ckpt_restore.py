"""The GPT-2 medium checkpoint of the benchmark's restore cell, on the CPU.

At a small GPT-2 shape the state of ``benchmark/data/gpt2_medium.py`` goes
through ``save_pytree`` and ``load_pytree(path, device="cpu")``, the prefetch
pipeline a CUDA target takes; every leaf comes back as saved and as the
plain reader ``benchmark/reference/checkpoint_file.py`` reads it from the
same file, and that reader refuses a damaged file.  At the published sizes
the generator's shapes are counted without allocating.

The pipeline decodes its leaves in windows (``stream._decode_window``),
onto the host as onto a device: a tree that mixes every kind of record in
one window comes back as saved and as tpu_blosc's ``load_pytree`` reads
the same file, in the number of windows its sizes give, and a damaged
record raises the error through a window that it raises through
``StreamReader.read_frame``.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time

import pytest
import torch
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc_torch as tb
from benchmark import harness
from tpu_blosc import checkpoint as jc
from tpu_blosc_torch import checkpoint, dtypes, stream
from tpu_blosc_torch.native import backend as native
from tpu_blosc_torch.stream import StreamWriter

CELL = "gpt2-medium-bf16.restore"
SMALL = {"n_layer": 2, "n_embd": 64, "n_positions": 64, "vocab_size": 512, "init_std": 0.02}
SEED = 2**31 + 11


def _cell():
    return harness.load_cell(CELL)


def _flat(tree) -> dict:
    """{path: leaf}, as the restore loop and the plain reader name leaves."""
    return _cell().module("loops", "restore").leaves(tree)


def _u8(t: torch.Tensor):
    return t.contiguous().view(-1).view(torch.uint8).numpy()


def _small_state():
    """(the configuration, the state at the small shape from SEED)."""
    cell = _cell()
    gen = cell.module("data", "gpt2_medium")
    return cell.config, gen.make(gen.state_bytes(SMALL, torch.bfloat16), torch.bfloat16,
                                 SEED, torch.device("cpu"), SMALL)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(path of the small state's checkpoint under the configuration's
    options, the state)."""
    config, state = _small_state()
    path = tmp_path_factory.mktemp("ckpt") / "gpt2.tpbs"
    o = config["options"]
    tb.save_pytree(path, state, tb.Options(codec=tb.Codec[o["codec"]], level=o["level"],
                                           shuffle=tb.Shuffle[o["shuffle"]]))
    return path, state


def _reference(sample_bytes: int = 1 << 30):
    cell = _cell()
    cell.config["reference"]["sample_bytes"] = sample_bytes
    return cell.reference()


def test_the_restore_equals_the_state_and_the_plain_reader(saved):
    path, state = saved
    restored = _flat(tb.load_pytree(path, device="cpu"))
    want = _flat(state)
    reading = _reference()(path, SEED)
    assert set(restored) == set(want) == set(reading["leaves"]) | set(reading["values"])
    assert set(reading["decoded"]) == set(reading["leaves"])  # the budget takes every leaf
    for p, w in want.items():
        if not isinstance(w, torch.Tensor):
            assert restored[p] == reading["values"][p] == w
            continue
        got = restored[p]
        assert got.dtype == w.dtype and got.shape == w.shape and got.device.type == "cpu"
        assert (_u8(got) == _u8(w)).all() and (reading["decoded"][p] == _u8(w)).all()
        assert reading["leaves"][p] == (str(w.dtype).removeprefix("torch."), tuple(w.shape))


def test_the_sample_takes_an_int64_a_multi_block_and_a_single_block_leaf(tmp_path):
    """Under a budget below the whole state the seed draws the sample: the
    int64 leaf, a multi-block and a single-block leaf (8 KiB blocks make
    every leaf above 8 KiB a multi-block frame), then drawn leaves up to
    the budget, none above half of it."""
    _, state = _small_state()
    path = tmp_path / "blocks.tpbs"
    tb.save_pytree(path, state, tb.Options(block_size=8192))
    sizes = {p: v.numel() * v.element_size() for p, v in _flat(state).items()
             if isinstance(v, torch.Tensor)}
    drawn = set()
    for seed in range(6):
        got = _reference(100_000)(path, seed)["decoded"]
        total = sum(a.size for a in got.values())
        assert "rng" in got and 100_000 <= total < 150_000
        assert all(sizes[p] <= 50_000 for p in got)
        assert any(sizes[p] > 8192 for p in got) and any(sizes[p] <= 8192 for p in got)
        drawn.add(tuple(sorted(got)))
    assert len(drawn) > 1


def _record(data: bytearray, k: int) -> int:
    """The offset of record ``k``, from the footer."""
    start = len(data) - int.from_bytes(data[-12:-4], "little")
    return int.from_bytes(data[start + 8 + 8 * k:start + 16 + 8 * k], "little")


def _flip_header(data: bytearray) -> None:
    """The codec byte of wte's frame (record 1)."""
    data[_record(data, 1) + 8 + 1] ^= 0x04


def _flip_payload(data: bytearray) -> None:
    """A byte in the middle of wte's frame."""
    at = _record(data, 1)
    data[at + 8 + int.from_bytes(data[at:at + 8], "little") // 2] ^= 0x10


def _truncate_footer(data: bytearray) -> None:
    del data[-3:]


@pytest.mark.parametrize("damage", [_flip_header, _flip_payload, _truncate_footer],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_the_reader_refuses_a_damaged_file(saved, tmp_path, damage):
    """A flipped header byte or a cut footer raises; a flipped payload
    byte decodes to other bytes than the state's, or raises."""
    path, state = saved
    data = bytearray(path.read_bytes())
    damage(data)
    bad = tmp_path / "bad.tpbs"
    bad.write_bytes(bytes(data))
    try:
        decoded = _reference()(bad, SEED)["decoded"]
    except ValueError:
        return
    assert damage is _flip_payload
    assert (decoded["params/wte"] != _u8(state["params"]["wte"])).any()


def _meta(node):
    if isinstance(node, dict):
        return {k: _meta(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_meta(v) for v in node]
    return torch.empty(node, dtype=torch.bfloat16, device="meta")


def test_the_generator_gives_the_published_widths_without_allocating():
    cell = _cell()
    gen = cell.module("data", "gpt2_medium")
    params = cell.config["data"]
    # each shape as a tensor on the meta device, which holds no data
    shapes = {p: tuple(t.shape) for p, t in _flat(_meta(gen.shapes(params))).items()}
    values = sum(math.prod(s) for s in shapes.values())
    assert len(shapes) + 1 == 292 + 1 and values + 2 == 354_823_168 + 2
    assert gen.state_bytes(params, torch.bfloat16) == cell.traffic["tensor_bytes"] == 709_646_352
    e = params["n_embd"]
    assert shapes["wte"] == (50257, e) and shapes["wpe"] == (1024, e) and e == 1024
    assert shapes["h/23/attn/c_attn/w"] == (e, 3 * e)
    assert shapes["h/23/mlp/c_fc/w"] == (e, 4 * e) and shapes["h/23/mlp/c_proj/w"] == (4 * e, e)
    # leaves above the 4 MiB automatic block threshold become multi-block frames
    big = [p for p, s in shapes.items() if math.prod(s) * 2 > 4 << 20]
    assert len(big) == 73 and "wte" in big


def test_the_generator_follows_the_seed():
    cell = _cell()
    gen = cell.module("data", "gpt2_medium")
    n = gen.state_bytes(SMALL, torch.bfloat16)
    a, b, c = (gen.make(n, torch.bfloat16, s, torch.device("cpu"), SMALL)
               for s in (SEED, SEED, SEED + 1))
    assert torch.equal(a["params"]["wte"], b["params"]["wte"])
    assert not torch.equal(a["params"]["wte"], c["params"]["wte"])
    assert a["rng"].tolist() == [SEED, SEED + 1] and a["step"] == 1000
    assert abs(float(a["params"]["wte"].float().std()) - 0.02) < 0.002
    with pytest.raises(ValueError):
        gen.make(n + 2, torch.bfloat16, SEED, torch.device("cpu"), SMALL)


# ------------------------------------------------------------ windowed restores

BLOCK = 8192


def _values(n: int, dtype: torch.dtype, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return (torch.randn(n, generator=g) * 0.02).to(dtype)
    return torch.randint(-1000, 1000, (n,), generator=g, dtype=dtype)


def _mixed_leaves() -> list:
    """(name, tensor, options) in walk order: multi-block leaves of whole
    blocks and with a short last block under one key, a second key, one
    multi-block leaf larger than a window, single-block leaves of 2 B to
    2 MiB, an int64 leaf after a bf16 one of 6 B, and ``dict``, which the
    dictionary case writes as a dictionary record."""
    bf, f32 = torch.bfloat16, torch.float32
    blocks = tb.Options(block_size=BLOCK)
    bits = tb.Options(block_size=2 * BLOCK, shuffle=tb.Shuffle.BITSHUFFLE)
    plain = tb.Options()
    leaves = [
        ("whole_a", _values(4 * BLOCK // 2, bf, 1), blocks),
        ("ragged_a", _values((3 * BLOCK + 1000) // 2, bf, 2), blocks),
        ("whole_b", _values(2 * BLOCK // 2, bf, 3), blocks),
        ("ragged_b", _values((BLOCK + 6) // 2, bf, 4), blocks),
        ("bits", _values(3 * 2 * BLOCK // 4, f32, 5), bits),
        ("two_bytes", _values(1, bf, 6), plain),
        ("six_bytes", _values(3, bf, 7), plain),
        ("rng", _values(5, torch.int64, 8), plain),
        ("dict", _values(1000, f32, 9), plain),
        ("wide", _values(40 * BLOCK // 2, bf, 10), blocks),
        ("small", _values(100, f32, 11), plain),
        ("mid", _values(32768, bf, 12), plain),
        ("two_mib", _values(1 << 20, bf, 13), plain),
        ("tail", _values(7, torch.int16, 14), plain),
    ]
    return [(n, t, o if t.element_size() == 4 else _with_ts(o, t.element_size()))
            for n, t, o in leaves]


def _with_ts(opts: tb.Options, ts: int) -> tb.Options:
    return tb.Options(codec=opts.codec, level=opts.level, shuffle=opts.shuffle,
                      type_size=ts, block_size=opts.block_size)


def _write_checkpoint(path, leaves, *, checksum=False, dictionary=False, reverse=False):
    """The checkpoint of {name: tensor} as save_pytree lays it out, each
    leaf's record compressed with its own options; ``reverse`` writes the
    records in the reverse of the manifest's walk; ``dictionary`` writes
    the leaf ``dict`` as a dictionary record, its dictionary's definition
    record just before it."""
    flat: list = []
    skeleton = checkpoint._encode({n: t for n, t, _ in leaves}, flat)
    order = list(range(len(flat)))[::-1] if reverse else list(range(len(flat)))
    at = {k: pos for pos, k in enumerate(order)}
    for _, node in skeleton["items"]:
        node["i"] = at[node["i"]]
    manifest = json.dumps({"version": 1, "tree": skeleton, "leaves": len(flat)}).encode()
    zdict = bytes(range(256)) * 16 if dictionary else None
    with StreamWriter(path, checksum=checksum, dictionary=zdict) as w:
        w.write_frame(tb.compress_with_options(manifest, tb.Options(type_size=1)))
        for k in order:
            name, t, opts = leaves[k]
            raw = t.contiguous().view(-1).view(torch.uint8).numpy()
            if name == "dict" and dictionary:
                w.write(raw, opts)
            else:
                w.write_frame(tb.compress_with_options(raw, opts))
    return order


def _windows_of(sizes, window: int) -> int:
    """Windows of consecutive leaves, each leaf's size rounded up to 64 bytes,
    of at most ``window`` bytes, a larger leaf alone."""
    count, total = 0, None
    for n in sizes:
        n = -(-n // 64) * 64
        if total is None or total + n > window:
            count, total = count + 1, n
        else:
            total += n
    return count


WINDOW_CASES = {
    "plain": {},
    "checksum": {"checksum": True},
    "dictionary_record": {"dictionary": True},
    "walk_not_in_index_order": {"reverse": True},
    "one_window": {"window": 64 << 20},
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_a_windowed_restore_equals_the_state_and_the_host_load(tmp_path, monkeypatch, case):
    """``load_pytree`` onto the host (``device=False``) and onto ``"cpu"``
    decodes windows of 256 KiB here: every leaf comes back with its dtype
    and shape, in storage of its own, byte for byte the state and
    tpu_blosc's ``load_pytree`` of the same file, in the windows its sizes
    give; multi-block leaves share native block calls."""
    kw = dict(WINDOW_CASES[case])
    if kw.get("dictionary"):
        pytest.importorskip("zstandard")
    window = kw.pop("window", 256 << 10)
    monkeypatch.setattr(stream, "_BATCH_WINDOW_BYTES", window)
    leaves = _mixed_leaves()
    path = tmp_path / "mixed.tpbs"
    order = _write_checkpoint(path, leaves, **kw)
    theirs = jc.load_pytree(path)
    calls = []
    real = native.decompress_blocks
    monkeypatch.setattr(native, "decompress_blocks",
                        lambda *a, **k: calls.append(a[4:6]) or real(*a, **k))
    sizes = [leaves[k][1].nbytes for k in order]
    multi = sum(o.block_size > 0 for _, _, o in leaves)
    for device in (False, torch.device("cpu")):
        calls.clear()
        checkpoint.reset_restored()
        got = tb.load_pytree(path, device=device)
        assert set(got) == set(theirs) == {n for n, _, _ in leaves}
        for name, want, _ in leaves:
            have, jax_leaf = got[name], theirs[name]
            assert have.dtype == want.dtype and have.shape == want.shape
            assert jax_leaf.dtype.name == dtypes.manifest_name(want.dtype)
            assert jax_leaf.shape == tuple(want.shape)
            assert (_u8(have) == _u8(want)).all(), name
            assert _u8(have).tobytes() == jax_leaf.tobytes(), name
            assert have.untyped_storage().nbytes() == want.nbytes  # a leaf of its own
        assert checkpoint.restored == {"leaves": len(leaves), "bytes": sum(sizes),
                                       "multi_block_leaves": multi,
                                       "windows": _windows_of(sizes, window)}
        assert checkpoint.restored["windows"] > (case != "one_window")
        if native.available():  # leaves of one key share a call
            assert 0 < len(calls) < multi
        else:  # the route without a native build decodes through decompress_into
            assert not calls


DAMAGES = ["forged_length", "truncated_last_record", "crc_mismatch"]


@pytest.mark.parametrize("route", ["read_frame", "window"])
@pytest.mark.parametrize("damage", DAMAGES)
def test_a_damaged_record_raises_through_a_window_as_through_read_frame(
        tmp_path, monkeypatch, damage, route):
    """A length field past the file's end, a file cut short inside its last
    record once the reader has opened it, and a payload byte that its
    crc32 refuses: ``load_leaf(device="cpu")`` (read_frame) and the
    windowed ``load_pytree`` raise the same InvalidDataError, naming the
    record, and leave no thread of the window route running."""
    monkeypatch.setattr(stream, "_BATCH_WINDOW_BYTES", 256 << 10)
    leaves = _mixed_leaves()
    path = tmp_path / "bad.tpbs"
    _write_checkpoint(path, leaves, checksum=damage == "crc_mismatch")
    data = bytearray(path.read_bytes())
    k = len(leaves) if damage == "truncated_last_record" else 3  # record 3: whole_b
    at = _record(data, k)
    flen = int.from_bytes(data[at:at + 8], "little")
    if damage == "forged_length":
        data[at:at + 8] = (len(data) * 4).to_bytes(8, "little")
        want = f"record {k} length overruns file"
    elif damage == "crc_mismatch":
        data[at + 8 + flen // 2] ^= 0x10
        want = f"record {k} checksum mismatch"
    else:
        real = checkpoint._read_manifest

        def read_then_cut(r):
            meta = real(r)
            os.truncate(path, at + 8 + flen // 2)
            return meta

        monkeypatch.setattr(checkpoint, "_read_manifest", read_then_cut)
        want = f"truncated record {k}"
    path.write_bytes(bytes(data))
    threads = threading.active_count()
    with pytest.raises(tb.InvalidDataError, match=want):
        if route == "read_frame":
            tb.load_leaf(path, leaves[k - 1][0], device=torch.device("cpu"))
        else:
            tb.load_pytree(path, device=torch.device("cpu"))
    # the window route's reader and decoder threads end with the error
    deadline = time.monotonic() + 10
    while threading.active_count() > threads and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == threads
