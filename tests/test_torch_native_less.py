"""The route without a native build (TPU_BLOSC_NO_NATIVE=1), on the CPU.

After tests/test_native.py:181 and tests/test_blosclz.py:245-260.  One
subprocess runs both packages with ``TPU_BLOSC_NO_NATIVE=1`` (and
``TPU_BLOSC_NO_DEVICE=1`` for tpu_blosc): for BLOSCLZ, LZ4, LZ4HC, SNAPPY,
ZLIB and ZSTD under NOSHUFFLE, SHUFFLE and BITSHUFFLE, in single-block and
multi-block frames, both write the same frame (or, for ZSTD without
``zstandard``, raise the same error); each of those frames decodes here,
on the native route, and each native frame decodes there.  The device
entry points run there on CPU tensors (filters through the plain
versions, the Python codec per block).  Then the same subprocess filters
and compresses a buffer of 300,009 bytes, past the size at which
tpu_blosc filters host buffers on its device: the port's route filters
it on the host all the same.  Last, each pure-Python codec of the port
writes the JAX package's blocks on random, run, empty, incompressible and
text inputs.  Tolerance: equal bytes.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc_torch import filters

CODECS = ["BLOSCLZ", "LZ4", "LZ4HC", "SNAPPY", "ZLIB", "ZSTD"]
SHUFFLES = ["NOSHUFFLE", "SHUFFLE", "BITSHUFFLE"]
LAYOUTS = {"single": 0, "blocks": 8192}
CASES = [(c, s, lay) for c in CODECS for s in SHUFFLES for lay in LAYOUTS]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Run with TPU_BLOSC_NO_NATIVE=1: argv[1] holds the parent's inputs, argv[2]
# gets the results.  Each result is ("ok", value) or ("error", type name,
# message).
_SCRIPT = r'''
import pickle, sys
import numpy as np
import torch
import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc_torch import filters
from tpu_blosc_torch.native import backend
from tpu_blosc_torch.dist import mesh

inp = pickle.load(open(sys.argv[1], "rb"))
data, big = inp["data"], inp["big"]
out = {"available": (backend.available(), jb.native.backend.available()),
       "backend": tb.backend_name(), "fastcall": backend.fastcall_status(),
       "frames": {}, "decoded": {}, "entry": {}, "big": {}}


def run(fn):
    try:
        return ("ok", fn())
    except Exception as exc:
        return ("error", type(exc).__name__, str(exc))


def opts(pkg, codec, shuffle, block_size=0):
    return pkg.Options(codec=pkg.Codec[codec], level=5, shuffle=pkg.Shuffle[shuffle],
                       type_size=4, block_size=block_size)


for codec, shuffle, layout in inp["cases"]:
    bs = inp["layouts"][layout]
    if bs:
        pair = [run(lambda p=p: p.compress_with_options(data, opts(p, codec, shuffle, bs)))
                for p in (tb, jb)]
    else:
        pair = [run(lambda p=p: p.compress(data, p.Codec[codec], 5, p.Shuffle[shuffle], 4))
                for p in (tb, jb)]
    out["frames"][codec, shuffle, layout] = pair
for key, frame in inp["native"].items():
    out["decoded"][key] = run(lambda: tb.decompress(frame) == data)

x = torch.from_numpy(np.frombuffer(data[: len(data) // 4 * 4], np.float32).copy())
for shuffle in ("SHUFFLE", "BITSHUFFLE"):
    o = opts(tb, "LZ4", shuffle, 8192)
    frame = tb.compress_array(x, o)
    back = tb.decompress_array(frame, torch.float32, device="cpu", strategy="device")
    out["entry"]["compress_array", shuffle] = (
        frame == tb.compress_with_options(x.numpy(), o) and torch.equal(back, x))
    out["entry"]["compress_chunked_mesh", shuffle] = (
        mesh.compress_chunked_mesh(x.numpy(), o, device="cpu")
        == tb.compress_with_options(x.numpy(), o))
tree = {"w": np.frombuffer(data[:40000], np.float32), "h": np.arange(3000, dtype=np.int16),
        "step": 7}
tb.save_pytree(inp["dir"] + "/t.tpbs", tree)
jb.save_pytree(inp["dir"] + "/j.tpbs", tree)
loaded = tb.load_pytree(inp["dir"] + "/j.tpbs", device="cpu")
out["entry"]["save_pytree", "SHUFFLE"] = (
    open(inp["dir"] + "/t.tpbs", "rb").read() == open(inp["dir"] + "/j.tpbs", "rb").read()
    and np.array_equal(loaded["w"].numpy(), tree["w"]) and loaded["step"] == 7)

for kind in ("shuffle_bytes", "unshuffle_bytes", "bit_shuffle", "bit_unshuffle"):
    out["big"][kind] = getattr(filters, kind)(big, 4).tobytes()
for shuffle in ("SHUFFLE", "BITSHUFFLE"):
    frames = [tb.compress_with_options(big, opts(tb, "LZ4", shuffle, bs)) for bs in (0, 65536)]
    out["big"]["frames", shuffle] = (
        frames == [jb.compress_with_options(big, opts(jb, "LZ4", shuffle, bs))
                   for bs in (0, 65536)]
        and all(tb.decompress(f) == big for f in frames))
pickle.dump(out, open(sys.argv[2], "wb"))
'''


def _data() -> bytes:
    """48,007 bytes: a float32 signal and a ragged tail of 7 bytes."""
    rng = np.random.default_rng(10)
    signal = (np.sin(np.arange(12_000) / 40.0) * 2000).astype(np.float32)
    return signal.tobytes() + rng.integers(0, 256, 7, dtype=np.uint8).tobytes()


def _big() -> bytes:
    """Past tpu_blosc's device threshold of 256 KiB: a float32 ramp of
    300,000 bytes and a tail of 9."""
    return np.arange(75_000, dtype=np.float32).tobytes() + bytes(range(9))


def _native_frame(codec, shuffle, layout) -> bytes:
    opts = tb.Options(codec=tb.Codec[codec], shuffle=tb.Shuffle[shuffle], type_size=4,
                      block_size=LAYOUTS[layout])
    return tb.compress_with_options(_data(), opts)


@pytest.fixture(scope="module")
def native_less(tmp_path_factory):
    """The subprocess's results."""
    work = tmp_path_factory.mktemp("native_less")
    inp = {"data": _data(), "big": _big(), "cases": CASES, "layouts": LAYOUTS,
           "native": {case: _native_frame(*case) for case in CASES}, "dir": str(work)}
    with open(work / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, TPU_BLOSC_NO_NATIVE="1", TPU_BLOSC_NO_DEVICE="1",
               JAX_PLATFORMS="cpu", PYTHONPATH=_ROOT)
    subprocess.run([sys.executable, "-c", _SCRIPT, str(work / "in.pkl"), str(work / "out.pkl")],
                   check=True, timeout=300, env=env, cwd=str(work))
    with open(work / "out.pkl", "rb") as f:
        return pickle.load(f)


def test_the_route_is_the_one_asked_for(native_less):
    assert native_less["available"] == (False, False)
    assert native_less["backend"] in ("python+torch-cpu", "python+cuda")
    assert native_less["fastcall"] == "fastcall: off (no native build)"


@pytest.mark.parametrize("codec,shuffle,layout", CASES)
def test_both_packages_write_one_frame(native_less, codec, shuffle, layout):
    mine, theirs = native_less["frames"][codec, shuffle, layout]
    assert mine == theirs
    if mine[0] == "ok":
        # the native-less frame decodes on the native route of both packages
        assert tb.decompress(mine[1]) == _data() == jb.decompress(mine[1])
    else:  # ZSTD with no zstandard: no codec on this route
        assert codec == "ZSTD" and mine[1] == "InvalidCodecError"


@pytest.mark.parametrize("codec,shuffle,layout", CASES)
def test_native_frames_decode_without_the_library(native_less, codec, shuffle, layout):
    got = native_less["decoded"][codec, shuffle, layout]
    if got[0] == "error":
        assert codec == "ZSTD" and got[1] == "InvalidCodecError"
    else:
        assert got == ("ok", True)


@pytest.mark.parametrize("entry,shuffle", [
    ("compress_array", "SHUFFLE"), ("compress_array", "BITSHUFFLE"),
    ("compress_chunked_mesh", "SHUFFLE"), ("compress_chunked_mesh", "BITSHUFFLE"),
    ("save_pytree", "SHUFFLE"),
])
def test_device_entry_points(native_less, entry, shuffle):
    assert native_less["entry"][entry, shuffle] is True


@pytest.mark.parametrize("kind,native", [
    ("shuffle_bytes", filters.shuffle_bytes), ("unshuffle_bytes", filters.unshuffle_bytes),
    ("bit_shuffle", filters.bit_shuffle), ("bit_unshuffle", filters.bit_unshuffle),
])
def test_large_host_buffers_filter_plainly(native_less, kind, native):
    assert native_less["big"][kind] == native(_big(), 4).tobytes()


@pytest.mark.parametrize("shuffle", ["SHUFFLE", "BITSHUFFLE"])
def test_large_host_buffers_write_the_frames(native_less, shuffle):
    assert native_less["big"]["frames", shuffle] is True


def _inputs() -> dict:
    rng = np.random.default_rng(11)
    return {
        "random": rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(),
        "runs": b"".join(bytes([v]) * int(n) for v, n in zip(
            rng.integers(0, 4, 300), rng.integers(1, 200, 300))),
        "empty": b"",
        "incompressible": rng.bytes(4096),
        "text": b"the quick brown fox jumps over the lazy dog " * 500,
    }


# each reference codec: (module, encoder, its keyword arguments, decoder)
_REF_CODECS = {
    "lz4": ("lz4_ref", "compress_block", {}, "decompress_block"),
    "lz4hc-16": ("lz4_ref", "compress_block", {"max_search_depth": 16}, "decompress_block"),
    "snappy": ("snappy_ref", "compress", {}, "decompress"),
    "blosclz": ("blosclz_ref", "compress", {}, "decompress"),
}


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:
        return ("error", type(exc).__name__, str(exc))


@pytest.mark.parametrize("kind", ["random", "runs", "empty", "incompressible", "text"])
@pytest.mark.parametrize("codec", list(_REF_CODECS))
def test_reference_codec_blocks_equal_tpu_blosc(codec, kind):
    """Each pure-Python codec of the port writes tpu_blosc's block and
    decodes it back, or both raise the same error."""
    data = _inputs()[kind]
    module, encoder, kwargs, decoder = _REF_CODECS[codec]
    mine, theirs = (importlib.import_module(f"{pkg}.codecs.{module}")
                    for pkg in ("tpu_blosc_torch", "tpu_blosc"))
    got = _outcome(lambda: getattr(mine, encoder)(data, **kwargs))
    assert got == _outcome(lambda: getattr(theirs, encoder)(data, **kwargs))
    if got[0] == "ok":
        assert _outcome(lambda: getattr(mine, decoder)(got[1], len(data))) == ("ok", data)
