"""The GPT-2 medium checkpoint of the benchmark's restore cell, on the CPU.

At a small GPT-2 shape the state of ``benchmark/data/gpt2_medium.py`` goes
through ``save_pytree`` and ``load_pytree(path, device="cpu")``, the prefetch
pipeline a CUDA target takes; every leaf comes back as saved and as the
plain reader ``benchmark/reference/checkpoint_file.py`` reads it from the
same file, and that reader refuses a damaged file.  At the published sizes
the generator's shapes are counted without allocating.
"""

from __future__ import annotations

import math

import pytest
import torch

import tpu_blosc_torch as tb
from benchmark import harness

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
