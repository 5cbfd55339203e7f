"""The port's checkpoints against the JAX package's, on the CPU.

After the single-process part of tests/test_checkpoint.py.  The same tree
(NumPy leaves for tpu_blosc; NumPy leaves or CPU tensors for the port)
gives a byte-identical file from both packages, and each package loads
the other's, with bfloat16, complex64, int64, bool and 0-element leaves
and checksums on.  CUDA leaves are "device" records written through the
stage-1/stage-2 pipeline; here the pipeline runs on CPU tensors handed to
it as device records, and must write the file that per-leaf
compress_array writes.  Loads onto a device run with ``device="cpu"``.
"""

from __future__ import annotations

import json
import time

import ml_dtypes
import numpy as np
import pytest
import torch
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc import checkpoint as jc
from tpu_blosc.options import Options as JOptions
from tpu_blosc_torch import checkpoint as tc
from tpu_blosc_torch.stream import StreamReader, StreamWriter


def _tensor(a) -> torch.Tensor:
    a = np.array(a, order="C")
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _state():
    rng = np.random.default_rng(9)
    return {
        "params": {
            "dense": {
                "w": rng.normal(size=(64, 128)).astype(np.float32),
                "b": np.zeros(128, np.float32),
            },
            "emb": (np.arange(1000, dtype=np.int32), rng.random(50)),
            "bf16": (rng.normal(size=(32, 48)) * 0.02).astype(ml_dtypes.bfloat16),
            "c64": (rng.random(40) + 1j * rng.random(40)).astype(np.complex64),
            "i64": rng.integers(-(2**40), 2**40, 70),
            "mask": rng.random(33) < 0.5,
            "big": np.linspace(0, 1, 300_000, dtype=np.float32),  # multi-block
        },
        "step": 12345,
        "lr": 1e-3,
        "name": "run-7",
        "done": False,
        "note": None,
        "history": [1, 2.5, "x"],
        "empty": np.empty((0, 4), np.float32),
        "scalar": np.float32(2.5),
        "rng": np.array([7, 11], dtype=np.int64),
    }


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tensors(v) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return _tensor(tree)
    return tree


def _assert_same(t, a):
    """The port's tree ``t`` holds what the NumPy tree ``a`` does."""
    if isinstance(a, dict):
        assert isinstance(t, dict) and t.keys() == a.keys()
        for k in a:
            _assert_same(t[k], a[k])
    elif isinstance(a, (list, tuple)):
        assert type(t) is type(a) and len(t) == len(a)
        for x, y in zip(t, a):
            _assert_same(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        a = np.asarray(a)
        assert isinstance(t, torch.Tensor), type(t)
        assert t.dtype == tb.dtypes.from_numpy(a.dtype) and tuple(t.shape) == a.shape
        assert tb.device.tensor_bytes(t.cpu()).numpy().tobytes() == a.tobytes()
    else:
        assert t == a and type(t) is type(a)


@pytest.mark.parametrize("leaves", ["numpy", "tensors"])
@pytest.mark.parametrize("checksum", [False, True])
def test_same_file_and_cross_load(tmp_path, leaves, checksum):
    state = _state()
    mine, theirs = tmp_path / "t.ckpt", tmp_path / "j.ckpt"
    tc.save_pytree(mine, state if leaves == "numpy" else _as_tensors(state), checksum=checksum)
    jc.save_pytree(theirs, state, checksum=checksum)
    assert mine.read_bytes() == theirs.read_bytes()
    _assert_same(tc.load_pytree(theirs), state)
    back = jc.load_pytree(mine)
    assert back["params"]["bf16"].dtype == ml_dtypes.bfloat16
    assert back["params"]["bf16"].tobytes() == state["params"]["bf16"].tobytes()
    assert back["empty"].shape == (0, 4) and back["step"] == 12345


def test_opts_passthrough_same_file(tmp_path):
    state = {"w": np.arange(100_000, dtype=np.float64), "h": np.arange(500, dtype=np.int16)}
    for shuffle in ("SHUFFLE", "BITSHUFFLE"):
        mine, theirs = tmp_path / f"t{shuffle}", tmp_path / f"j{shuffle}"
        tc.save_pytree(mine, _as_tensors(state),
                       tb.Options(codec=tb.Codec.ZSTD, level=7, shuffle=tb.Shuffle[shuffle]))
        jc.save_pytree(theirs, state,
                       JOptions(codec=jb.ZSTD, level=7, shuffle=jb.Shuffle[shuffle]))
        assert mine.read_bytes() == theirs.read_bytes()
        _assert_same(tc.load_pytree(mine), state)


def test_load_onto_a_device_equals_the_host_load(tmp_path):
    """The prefetch pipeline of a device load (here onto "cpu") gives the
    host load's tensors, and places 0-element leaves there too."""
    path = tmp_path / "d.ckpt"
    state = _state()
    jc.save_pytree(path, state, checksum=True)
    _assert_same(tc.load_pytree(path, device="cpu"), state)
    _assert_same(tc.load_pytree(path, device=torch.device("cpu"), strategy="device"), state)


def test_a_host_load_takes_the_windows_of_a_device_load(tmp_path, monkeypatch):
    """``load_pytree(path)`` decodes its leaves in the pipeline's windows,
    as a device load does, and never in StreamReader.read_many_into."""
    path = tmp_path / "h.ckpt"
    state = _state()
    jc.save_pytree(path, state)

    def refused(self, indices, outs):
        raise AssertionError("a checkpoint load called read_many_into")

    monkeypatch.setattr(StreamReader, "read_many_into", refused)
    tc.reset_restored()
    _assert_same(tc.load_pytree(path), state)
    with StreamReader(path) as r:
        records = len(r)
    assert tc.restored["windows"] > 0 and tc.restored["leaves"] == records - 1


def test_device_true_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=True is valid")
    path = tmp_path / "d.ckpt"
    tc.save_pytree(path, {"w": torch.arange(10)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.load_pytree(path, device=True)


def test_checkpoint_compresses(tmp_path):
    path = tmp_path / "c.ckpt"
    tc.save_pytree(path, {"w": torch.zeros(512, 512)})
    assert path.stat().st_size < 512 * 512 * 4 // 50


def test_rejects_bad_types(tmp_path):
    for tree in ({"bad": object()}, {1: torch.zeros(3)}, {"s": np.array(["a", "b"])}):
        with pytest.raises(TypeError):
            tc.save_pytree(tmp_path / "x.ckpt", tree)


def test_leaf_count_validated_after_an_append(tmp_path):
    path = tmp_path / "m.ckpt"
    tc.save_pytree(path, {"w": torch.arange(100, dtype=torch.int32)})
    with StreamWriter(path, append=True) as w:
        w.write(b"extra" * 100)
    with pytest.raises(tb.InvalidDataError):
        tc.load_pytree(path)
    with pytest.raises(jb.InvalidDataError):
        jc.load_pytree(path)


def test_checksum_detects_bit_rot(tmp_path):
    path = tmp_path / "crc.ckpt"
    tc.save_pytree(path, {"w": torch.arange(4096, dtype=torch.float32), "step": 7},
                   checksum=True)
    assert torch.equal(tc.load_pytree(path)["w"], torch.arange(4096, dtype=torch.float32))
    with StreamReader(path) as r:
        off = r._offsets[1]
    blob = bytearray(path.read_bytes())
    blob[off + 8 + 40] ^= 0x01
    path.write_bytes(bytes(blob))
    for device in (False, "cpu"):
        with pytest.raises(tb.BloscError):
            tc.load_pytree(path, device=device)


def test_forged_manifest_shape_does_not_preallocate(tmp_path):
    skeleton = {"t": "dict", "items": [
        ["w", {"t": "array", "i": 0, "dtype": "float32", "shape": [1 << 40]}]]}
    manifest = json.dumps({"version": 1, "tree": skeleton, "leaves": 1}).encode()
    path = tmp_path / "forged.ckpt"
    with StreamWriter(path) as w:
        w.write(manifest, tb.Options(type_size=1))
        w.write(np.arange(100, dtype=np.float32), tb.Options(type_size=4))
    with pytest.raises(RuntimeError):  # the reshape of 100 elements
        tc.load_pytree(path)


def _write_manifest(path, tree, n, leaves):
    manifest = json.dumps({"version": 1, "tree": tree, "leaves": n}).encode()
    with StreamWriter(path) as w:
        w.write(manifest, tb.Options(type_size=1))
        for leaf in leaves:
            w.write(leaf, tb.Options(type_size=4))


def test_device_load_permuted_manifest(tmp_path):
    a = np.arange(50_000, dtype=np.float32)
    b = np.full(30_000, 7, np.int32)
    tree = {"t": "dict", "items": [
        ["b", {"t": "array", "i": 1, "dtype": "int32", "shape": [30_000]}],
        ["a", {"t": "array", "i": 0, "dtype": "float32", "shape": [50_000]}],
    ]}
    path = tmp_path / "perm.ckpt"
    _write_manifest(path, tree, 2, [a, b])
    for device in (False, "cpu"):
        out = tc.load_pytree(path, device=device)
        assert np.array_equal(out["a"].numpy(), a) and np.array_equal(out["b"].numpy(), b)


def test_device_load_bad_leaf_raises(tmp_path):
    tree = {"t": "dict", "items": [
        ["x", {"t": "array", "i": 0, "dtype": "float32", "shape": [100]}]]}
    path = tmp_path / "bad.ckpt"
    _write_manifest(path, tree, 1, [np.arange(50, dtype=np.float32)])
    with pytest.raises(RuntimeError):
        tc.load_pytree(path, device="cpu")


def test_load_leaf(tmp_path):
    path = tmp_path / "leaf.ckpt"
    state = {
        "params": {"layers": [{"w": np.arange(100, dtype=np.float32)},
                              {"w": np.arange(100, 300, dtype=np.float32)}]},
        "step": 123,
        "name": "run-7",
        "xs": [np.zeros(3), np.ones(3)],
    }
    jc.save_pytree(path, state)
    assert np.array_equal(tc.load_leaf(path, "params/layers/1/w").numpy(),
                          state["params"]["layers"][1]["w"])
    assert np.array_equal(tc.load_leaf(path, "params/layers/1/w", device="cpu").numpy(),
                          state["params"]["layers"][1]["w"])
    assert tc.load_leaf(path, "step") == 123
    assert tc.load_leaf(path, "name") == "run-7"
    sub = tc.load_leaf(path, "params/layers/0")
    assert np.array_equal(sub["w"].numpy(), state["params"]["layers"][0]["w"])
    for bad in ("params/missing", "params/layers/9", "step/deeper", "xs/-1"):
        with pytest.raises(KeyError):
            tc.load_leaf(path, bad)


def test_load_leaf_reads_one_record(tmp_path, monkeypatch):
    path = tmp_path / "count.ckpt"
    tc.save_pytree(path, {"a": torch.zeros(1000), "b": torch.ones(1000),
                          "c": torch.full((1000,), 2.0)})
    reads = []
    orig = StreamReader.read

    def counting_read(self, i):
        reads.append(i)
        return orig(self, i)

    monkeypatch.setattr(StreamReader, "read", counting_read)
    assert torch.equal(tc.load_leaf(path, "b"), torch.ones(1000))
    assert reads == [0, 2]


# ---- the device-record pipeline ----------------------------------------


def _device_state():
    rng = np.random.default_rng(3)
    # two runs of device records (3 leaves, then 2) split by a host leaf;
    # multi-block and single-block routing, both filters, mixed dtypes
    return [
        ("device", torch.from_numpy(rng.integers(0, 40, 2_000_000).astype(np.float32))),
        ("device", torch.from_numpy(np.tile(rng.random(1000).astype(np.float32), 1200))),
        ("device", _tensor((rng.normal(size=60_000) * 0.02).astype(ml_dtypes.bfloat16))),
        ("host", rng.random(10_000).astype(np.float32)),
        ("device", torch.zeros(800_000, dtype=torch.int32)),
        ("device", torch.from_numpy(rng.random(50).astype(np.float32))),
    ]


@pytest.mark.parametrize("shuffle", ["SHUFFLE", "BITSHUFFLE"])
def test_pipelined_device_records_equal_per_leaf_compress_array(tmp_path, shuffle):
    records = _device_state()
    opts = tb.Options(shuffle=tb.Shuffle[shuffle])
    piped, serial = tmp_path / "pipe.tpbs", tmp_path / "serial.tpbs"
    with StreamWriter(piped) as w:
        tc._write_leaf_records(w, records, opts)
    with StreamWriter(serial) as w:
        for _, leaf in records:
            t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(leaf)
            w.write_frame(tb.compress_array(t, tc._leaf_opts(opts, t.element_size())))
    assert piped.read_bytes() == serial.read_bytes()


def test_pipeline_forwards_the_strategy(tmp_path, monkeypatch):
    seen = []
    real = tc._compress_array_stage1

    def spy(x, opts, strategy):
        seen.append(strategy)
        return real(x, opts, strategy)

    monkeypatch.setattr(tc, "_compress_array_stage1", spy)
    records = [("device", torch.linspace(0, 1, 500_000)), ("device", torch.linspace(1, 2, 500_000))]
    with StreamWriter(tmp_path / "fwd.tpbs") as w:
        tc._write_leaf_records(w, records, None, strategy="match")
    assert seen == ["match", "match"]


def test_pipeline_overlaps_the_two_stages(tmp_path, monkeypatch):
    """Stage 1 of leaf k+1 runs while stage 2 of leaf k does: with a
    sleep injected into each stage, n leaves take about (n+1) sleeps in
    place of 2n."""
    delay = 0.04
    real1, real2 = tc._compress_array_stage1, tc._compress_array_stage2

    def slow1(x, opts, strategy):
        time.sleep(delay)
        return real1(x, opts, strategy)

    def slow2(staged):
        time.sleep(delay)
        return real2(staged)

    monkeypatch.setattr(tc, "_compress_array_stage1", slow1)
    monkeypatch.setattr(tc, "_compress_array_stage2", slow2)
    n = 8
    records = [("device", torch.arange(256, dtype=torch.float32).repeat(1024) * (i + 1))
               for i in range(n)]
    t0 = time.perf_counter()
    with StreamWriter(tmp_path / "pipe.tpbs") as w:
        tc._write_leaf_records(w, records, None)
    t_pipe = time.perf_counter() - t0
    assert t_pipe < 2 * n * delay / 1.3, t_pipe
