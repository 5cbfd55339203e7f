"""The DeepSeek-V2-Lite training state of the benchmark's save cell, on the CPU.

At the published widths the generator ``benchmark/data/deepseek_v2_lite_train.py``
is counted on the meta device, without allocating: 151 parameter
tensors of 692,345,344 values, 454 leaves of 5,538,762,768 bytes, 376 of
them above the 4 MiB automatic block threshold.  At a small width its
state (fp32 master weights beside bf16 moments) goes through the port's
``save_pytree``, on the host route and on the pipeline that CUDA leaves
take (here CPU tensors handed to it as device leaves), and the file is
byte for byte tpu_blosc's ``save_pytree`` of the same tree.  The save
loop ``benchmark/loops/save.py`` runs its window and its check at that
width and reads ``correct``; its control and each of its planted faults
read not ``correct``.
"""

from __future__ import annotations

import math
import os
from unittest import mock

import ml_dtypes
import numpy as np
import pytest
import torch
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from benchmark import harness
from tpu_blosc import checkpoint as jc
from tpu_blosc.options import Options as JOptions
from tpu_blosc_torch import api, checkpoint

CELL = "deepseek-v2-lite-train.save"
# every key the generator reads, at a width the CPU tests can afford: one
# dense layer and one MoE layer of two held experts, a router of four
SMALL = {"hidden_size": 64, "num_attention_heads": 2, "qk_nope_head_dim": 16,
         "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
         "intermediate_size": 128, "moe_intermediate_size": 32, "n_routed_experts": 2,
         "n_routed_experts_published": 4, "n_shared_experts": 2, "vocab_size": 256,
         "num_hidden_layers": 2, "first_k_dense_replace": 1}
SEED = 2**31 + 21
CPU = torch.device("cpu")
# at the small width the leaves above this are multi-block frames, as the
# leaves above api.AUTO_BLOCK_THRESHOLD are at the published widths
SMALL_THRESHOLD = 8192


def _cell(sample_bytes: int = 60_000):
    cell = harness.load_cell(CELL)
    cell.config.update(SMALL)
    cell.traffic["tensor_bytes"] = _gen(cell).state_bytes(cell.config)
    cell.config["reference"]["sample_bytes"] = sample_bytes
    return cell


def _gen(cell):
    return cell.module("data", cell.config["data"]["generator"])


def _flat(tree) -> dict:
    return harness.load_cell(CELL).module("loops", "save").leaves(tree)


def test_the_generator_gives_the_published_widths_without_allocating():
    cell = harness.load_cell(CELL)
    gen = _gen(cell)
    state = gen.shapes(cell.config)
    tensors = {p: t for p, t in _flat(state).items() if isinstance(t, torch.Tensor)}
    assert all(t.device.type == "meta" for t in tensors.values())
    params = gen.parameter_shapes(cell.config)
    assert len(params) == 151 and sum(math.prod(s) for s in params.values()) == 692_345_344
    assert len(tensors) == 454 and state["step"] == 1000
    total = sum(t.nbytes for t in tensors.values())
    assert total == gen.state_bytes(cell.config) == cell.traffic["tensor_bytes"]
    assert total == 5_538_762_768 == cell.config["published_size_bytes"]
    assert sum(t.nbytes > api.AUTO_BLOCK_THRESHOLD for t in tensors.values()) == 376
    by_dtype = {d: sum(t.dtype == d for t in tensors.values())
                for d in (torch.float32, torch.bfloat16, torch.int64)}
    assert by_dtype == {torch.float32: 151, torch.bfloat16: 302, torch.int64: 1}
    m = state["master"]
    assert m["model.embed_tokens.weight"].shape == (102400, 2048)
    assert m["model.layers.0.mlp.gate_proj.weight"].shape == (10944, 2048)
    assert m["model.layers.1.self_attn.q_proj.weight"].shape == (16 * (128 + 64), 2048)
    assert m["model.layers.1.self_attn.kv_a_proj_with_mqa.weight"].shape == (512 + 64, 2048)
    assert m["model.layers.1.self_attn.kv_b_proj.weight"].shape == (16 * (128 + 128), 512)
    assert m["model.layers.4.mlp.gate.weight"].shape == (64, 2048)  # the published router
    assert m["model.layers.4.mlp.experts.7.down_proj.weight"].shape == (2048, 1408)
    assert "model.layers.4.mlp.experts.8.down_proj.weight" not in m
    assert m["model.layers.4.mlp.shared_experts.up_proj.weight"].shape == (2 * 1408, 2048)
    assert state["exp_avg_sq"].keys() == m.keys()


def test_the_generator_follows_the_seed():
    cell = _cell()
    gen, n = _gen(cell), cell.traffic["tensor_bytes"]
    a, b, c = (gen.make(n, s, CPU, cell.config) for s in (SEED, SEED, SEED + 1))
    name = "model.layers.1.mlp.experts.0.up_proj.weight"
    for group in ("master", "exp_avg", "exp_avg_sq"):
        assert torch.equal(a[group][name], b[group][name])
        assert not torch.equal(a[group][name], c[group][name])
    assert a["master"][name].dtype == torch.float32
    assert a["exp_avg"][name].dtype == a["exp_avg_sq"][name].dtype == torch.bfloat16
    assert abs(float(a["master"]["model.embed_tokens.weight"].std()) - 0.006) < 6e-4
    norm = a["master"]["model.layers.0.input_layernorm.weight"]
    assert abs(float(norm.mean()) - 1) < 0.02 and float(a["exp_avg_sq"][name].min()) >= 0
    assert a["rng"].tolist() == [SEED, SEED + 1] and a["step"] == 1000
    with pytest.raises(ValueError):
        gen.make(n + 2, SEED, CPU, cell.config)


def _numpy(tree):
    """The tree with NumPy leaves, bfloat16 as ml_dtypes', for tpu_blosc."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return tree.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return tree.numpy()
    return tree


@pytest.mark.parametrize("block_size", [0, 8192], ids=["auto_blocks", "8k_blocks"])
@pytest.mark.parametrize("route", ["host", "device_pipeline"])
def test_the_save_is_tpu_blosc_s_file(tmp_path, monkeypatch, route, block_size):
    """The port's save of the small state, through the host batches or the
    stage-1 / stage-2 pipeline, is tpu_blosc's file byte for byte, and
    loads back as the state."""
    cell = _cell()
    state = _gen(cell).make(cell.traffic["tensor_bytes"], SEED, CPU, cell.config)
    if route == "device_pipeline":
        monkeypatch.setattr(checkpoint, "_on_cuda", lambda leaf: isinstance(leaf, torch.Tensor))
    mine, theirs = tmp_path / "t.tpbs", tmp_path / "j.tpbs"
    tb.save_pytree(mine, state, tb.Options(codec=tb.Codec.LZ4, level=5,
                                           shuffle=tb.Shuffle.SHUFFLE, block_size=block_size))
    jc.save_pytree(theirs, _numpy(state), JOptions(codec=jb.LZ4, level=5,
                                                   shuffle=jb.Shuffle.SHUFFLE,
                                                   block_size=block_size))
    assert mine.read_bytes() == theirs.read_bytes()
    back = _flat(tb.load_pytree(mine))
    for p, want in _flat(state).items():
        if isinstance(want, torch.Tensor):
            assert back[p].dtype == want.dtype and torch.equal(back[p], want), p
        else:
            assert back[p] == want


def _run(seed, trace=False, ctrl=()):
    return harness.execute(_cell(), seed, 0.3, trace, CPU, 0.0, ctrl)


@pytest.fixture
def small_blocks(monkeypatch):
    """Multi-block frames above SMALL_THRESHOLD bytes, single-block ones
    below: the mix of the published widths at the small one."""
    monkeypatch.setattr(api, "AUTO_BLOCK_THRESHOLD", SMALL_THRESHOLD)


@pytest.mark.parametrize("seed", [5, 2**31 + 5])
def test_the_window_and_the_check_are_correct(small_blocks, seed):
    out = _run(seed)
    rec = out["record"]
    assert out["correct"] and all(v == 0 for v, _ in out["checks"].values()), out["checks"]
    assert rec["round_trips"] == len(rec["ops"]["encode"]) > 0 and rec["ops"]["decode"] == []
    assert rec["tensor_bytes"] == _cell().traffic["tensor_bytes"] and rec["window_s"] >= 0.3
    assert out["metrics"]["tensor_gbps"]["value"] == pytest.approx(
        rec["round_trips"] * rec["tensor_bytes"] / rec["window_s"] / 1e9)
    # the file at the save's path and the sampled one, each read by the
    # reference (a set-up save filled the slot, so both are there)
    judged = out["judged"]
    assert judged["sampled"] == 2
    assert judged["bad"] == 0 and judged["frames_read"] >= 4 * judged["sampled"]
    assert out["frame_bytes"] > 0


def test_the_reference_decodes_every_kind_of_leaf_record(small_blocks, tmp_path):
    cell = _cell()
    state = _gen(cell).make(cell.traffic["tensor_bytes"], SEED, CPU, cell.config)
    path = tmp_path / "state.tpbs"
    tb.save_pytree(path, state)
    sizes = {p: t.nbytes for p, t in _flat(state).items() if isinstance(t, torch.Tensor)}
    drawn = set()
    for seed in range(4):
        reading = cell.reference()(path, seed)
        kinds = reading["kinds"]
        assert set(kinds) == set(cell.config["reference"]["kinds"])
        assert all(k in reading["decoded"] for k in kinds.values())
        assert kinds["int64"] == "rng" and sizes[kinds["single_block"]] <= SMALL_THRESHOLD
        assert kinds["multi_block/float32"].startswith("master/")
        assert kinds["multi_block/bfloat16"].startswith("exp_avg")
        assert all(sizes[kinds[k]] > SMALL_THRESHOLD
                   for k in ("multi_block/float32", "multi_block/bfloat16"))
        drawn.add(tuple(sorted(reading["decoded"])))
    assert len(drawn) > 1


def test_a_traced_run_is_complete_and_correct(small_blocks):
    """On the CPU every leaf takes the host route: the codec, write and
    entry spans are there, the wait (stage 1 of CUDA leaves) and the
    copies from a device are not."""
    out = _run(2**31 + 9, trace=True)
    assert out["correct"] and out["complete"]
    assert set(out["metrics"]) == {"save_codec_ms", "save_write_ms", "save_self_ms"}
    assert all(m["value"] >= 0 for m in out["metrics"].values())


@pytest.mark.parametrize("fault", ["control", "flipped_byte", "dropped_leaf",
                                   "unshuffled_leaf"])
def test_the_control_and_every_fault_are_not_correct(small_blocks, fault):
    mod = harness.load_cell(CELL).module("loops", "save")
    ctrl = mod.CONTROL if fault == "control" else mod.FAULTS[fault]
    out = _run(12, ctrl=(ctrl,))
    assert not out["correct"], out["checks"]
    checks = {k: v for k, (v, _) in out["checks"].items()}
    assert checks["state_bad_bytes"] == 0  # no fault touches the live state
    assert checks["decoded_bad_bytes"] > 0
    if fault in ("control", "dropped_leaf"):
        assert checks["frame_bad_bytes"] > 0


def test_the_temporary_directory_is_gone_after_the_check(small_blocks):
    cell = _cell()
    loop = cell.module("loops", "save").Loop(cell, 4, CPU)
    loop.warm(1)
    assert os.path.exists(loop.path)
    loop.window(0.05)
    assert len(os.listdir(loop.dir)) <= 1 + cell.traffic["check_sample"]
    loop.check(cell.reference())
    assert not os.path.exists(loop.dir)


@pytest.mark.parametrize("seed", [7, 2**31 + 7])
def test_every_save_of_the_window_truncates_a_whole_file(small_blocks, seed):
    """The sample's draws leave every save of the window the same file
    work: the path holds a whole save's file when the save opens it, and
    no file is renamed over another.  The window is a fixed count of
    saves (``traced``: the window's own ``_run`` with a span a save), so
    what is checked does not depend on how many saves a host under load
    fits in a time."""
    cell = _cell()
    loop = cell.module("loops", "save").Loop(cell, seed, CPU)
    save, found = loop.save, []

    def spy(path, state, opts):
        found.append(os.path.getsize(path) if os.path.exists(path) else 0)
        save(path, state, opts)

    loop.save = spy
    renamed_over = []
    rename = os.rename

    def no_overwrite(src, dst):
        renamed_over.append(os.path.exists(dst))
        rename(src, dst)

    loop.warm(3)
    with mock.patch.object(os, "rename", no_overwrite):
        rec = loop.traced(3)
    assert rec["round_trips"] == 3 and not any(renamed_over)
    assert found[3:] == [loop.frame_bytes] * rec["round_trips"]
    assert sorted(os.listdir(loop.dir)) == ["sample0.tpbs", "state.tpbs"]
    assert loop.check(cell.reference())[1] == {"sampled": 2, "bad": 0,
                                               "frames_read": mock.ANY}


def test_a_save_that_raises_is_counted_and_not_correct(small_blocks):
    def broken(loop, stack):
        def refuse(path, state, opts):
            raise OSError("disk full")

        loop.save = refuse

    out = _run(3, ctrl=(broken,))
    assert not out["correct"] and out["failed"] > 0 and "disk full" in out["first_error"]
    assert out["record"]["round_trips"] == 0
