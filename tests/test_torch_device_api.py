"""The PyTorch port's slice against the JAX package, end to end on the CPU.

compress_array, decompress_array and the bytes API of tpu_blosc_torch
run on the same inputs as their tpu_blosc counterparts, after
tests/test_device_api.py:16-96.  The contract is bytes: frames must be
byte-identical, and each package must read the other's frames.  Inputs
come from numpy with fixed seeds; every comparison is exact.
"""

from __future__ import annotations

import ast
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc.options import Options as JOptions

CODECS = ["BLOSCLZ", "LZ4", "LZ4HC", "SNAPPY", "ZLIB", "ZSTD"]
SHUFFLES = ["NOSHUFFLE", "SHUFFLE", "BITSHUFFLE"]


def _opts(**kw):
    """The same options for both packages; enum fields given by name."""
    jkw, tkw = dict(kw), dict(kw)
    if "codec" in kw:
        jkw["codec"] = jb.Codec[kw["codec"]]
        tkw["codec"] = tb.Codec[kw["codec"]]
    if "shuffle" in kw:
        jkw["shuffle"] = jb.Shuffle[kw["shuffle"]]
        tkw["shuffle"] = tb.Shuffle[kw["shuffle"]]
    return JOptions(**jkw), tb.Options(**tkw)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor holding the same bytes as the numpy array."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _ramp(n: int, dtype) -> np.ndarray:
    base = np.arange(n) % 1000
    if dtype == np.complex128:
        return (base + 1j * (base // 7)).astype(np.complex128)
    if dtype == ml_dtypes.bfloat16:
        return base.astype(np.float32).astype(ml_dtypes.bfloat16)
    return base.astype(dtype)


@pytest.mark.parametrize(
    "dtype",
    [np.float32, np.float64, np.int16, np.int32, ml_dtypes.bfloat16, np.complex128],
    ids=["float32", "float64", "int16", "int32", "bfloat16", "complex128"],
)
def test_compress_array_matches_tpu_blosc(dtype):
    data = _ramp(100_000, dtype)
    jo, to = _opts(shuffle="SHUFFLE", type_size=data.dtype.itemsize, block_size=65536)
    frame = tb.compress_array(_tensor(data), to)
    assert frame == jb.compress_with_options(data.tobytes(), jo)
    assert jb.decompress(frame) == data.tobytes()
    # tpu_blosc's device route cannot bitcast complex values to bytes
    # (jax.lax.bitcast_convert_type refuses them); for complex128 its host
    # path above, which its device frames are defined to equal, is the
    # reference
    if data.dtype != np.complex128:
        assert frame == jb.compress_array(jnp.asarray(data), jo)


@pytest.mark.parametrize(
    "dtype,ts", [(torch.float64, 8), (torch.int16, 2), (torch.complex128, 16)]
)
def test_compress_array_default_type_size_from_dtype(dtype, ts):
    x = torch.arange(50_000).to(dtype)
    frame = tb.compress_array(x)
    assert tb.format.parse_header(frame).type_size == ts
    host = x.numpy()
    assert frame == jb.compress_array(jnp.asarray(host))
    assert tb.decompress(frame) == host.tobytes()


def test_compress_array_small_input_single_block_routing():
    data = np.arange(1000, dtype=np.float32)
    frame = tb.compress_array(_tensor(data))
    assert frame == jb.compress_array(jnp.asarray(data))
    assert frame == jb.compress_with_options(data.tobytes(), JOptions(type_size=4))
    assert not tb.format.parse_header(frame).is_split


def test_compress_array_noshuffle():
    data = np.arange(100_000, dtype=np.int32)
    jo, to = _opts(shuffle="NOSHUFFLE", type_size=4, block_size=32768)
    frame = tb.compress_array(_tensor(data), to)
    assert frame == jb.compress_array(jnp.asarray(data), jo)
    assert frame == jb.compress_with_options(data.tobytes(), jo)


def test_compress_array_incompressible_memcpy_patch():
    # random data: every block takes the memcpy fallback and must carry
    # its raw bytes, from before the shuffle
    data = np.random.default_rng(5).integers(0, 2**31, 65536, dtype=np.int32)
    jo, to = _opts(shuffle="SHUFFLE", type_size=4, block_size=32768)
    frame = tb.compress_array(_tensor(data), to)
    assert frame == jb.compress_array(jnp.asarray(data), jo)
    assert frame == jb.compress_with_options(data.tobytes(), jo)
    assert jb.decompress(frame) == data.tobytes()


def test_compress_array_mixed_memcpy_and_ragged_tail():
    data = _ramp(70_001, np.float32)
    data.view(np.uint8)[65536:131072] = np.random.default_rng(6).integers(
        0, 256, 65536, dtype=np.uint8
    )
    jo, to = _opts(type_size=4, block_size=65536)
    frame = tb.compress_array(_tensor(data), to)
    entries, _ = tb.chunk.parse_block_table(frame, tb.format.parse_header(frame))
    assert [m for _, m in entries] == [False, True, False, False, False]
    assert frame == jb.compress_array(jnp.asarray(data), jo)
    assert frame == jb.compress_with_options(data.tobytes(), jo)


def test_compress_array_ragged_tail():
    data = np.arange(70_001, dtype=np.float32)  # not a block multiple
    jo, to = _opts(block_size=65536, type_size=4)
    frame = tb.compress_array(_tensor(data), to)
    assert frame == jb.compress_array(jnp.asarray(data), jo)
    assert frame == jb.compress_with_options(data.tobytes(), jo)


@pytest.mark.parametrize("codec", CODECS)
def test_compress_array_codecs_identical(codec):
    data = np.arange(80_000, dtype=np.float32)
    jo, to = _opts(codec=codec, type_size=4, block_size=65536)
    frame = tb.compress_array(_tensor(data), to)
    assert frame == jb.compress_array(jnp.asarray(data), jo)
    assert frame == jb.compress_with_options(data.tobytes(), jo)


def test_compress_array_type_size_past_the_header_byte():
    # ts 300 shuffles the device blocks at 300 and stores min(ts, 255)
    data = np.random.default_rng(7).integers(0, 4, 60_000, dtype=np.uint8)
    jo, to = _opts(type_size=300, block_size=16384)
    frame = tb.compress_array(_tensor(data), to)
    assert tb.format.parse_header(frame).type_size == 255
    assert frame == jb.compress_array(jnp.asarray(data), jo)
    assert frame == jb.compress_with_options(data.tobytes(), jo)


def test_compress_array_non_contiguous_tensor_in_c_order():
    x = torch.arange(300 * 400, dtype=torch.float32).reshape(300, 400).t()
    assert not x.is_contiguous()
    jo, to = _opts(block_size=65536)
    want = np.ascontiguousarray(x.numpy())
    frame = tb.compress_array(x, to)
    assert frame == jb.compress_with_options(want.tobytes(), jo)
    assert frame == jb.compress_array(jnp.asarray(want), jo)


def test_compress_array_lazy_views_in_logical_order():
    # a conjugate view compresses as the values it shows, as numpy sees them
    z = torch.arange(30_000, dtype=torch.float64) * (1 + 2j)
    jo, to = _opts(type_size=16, block_size=65536)
    want = z.conj().resolve_conj().numpy()
    frame = tb.compress_array(z.conj(), to)
    assert frame == jb.compress_with_options(want.tobytes(), jo)


def _jax_frames():
    """Frames written by tpu_blosc, each with the array it holds."""
    rng = np.random.default_rng(8)
    ramp = np.linspace(0, 1, 100_000, dtype=np.float32)
    noisy = _ramp(70_001, np.float32)
    noisy.view(np.uint8)[:65536] = rng.integers(0, 256, 65536, dtype=np.uint8)
    f64 = np.cumsum(rng.normal(size=40_000))
    odd = rng.integers(0, 3, 3 * 20_000, dtype=np.uint8)
    i16 = (np.arange(60_000) // 9).astype(np.int16)
    return {
        "f32-split": (ramp, jb.compress_array(jnp.asarray(ramp), JOptions(block_size=65536))),
        "f32-memcpy-row-ragged": (noisy, jb.compress_array(
            jnp.asarray(noisy), JOptions(block_size=65536))),
        "f64-zstd": (f64, jb.compress_with_options(
            f64.tobytes(), JOptions(codec=jb.ZSTD, type_size=8, block_size=32768))),
        "ts3-split": (odd, jb.compress_with_options(
            odd.tobytes(), JOptions(type_size=3, block_size=24576))),
        "bitshuffle": (i16, jb.compress_with_options(
            i16.tobytes(), JOptions(shuffle=jb.BITSHUFFLE, type_size=2, block_size=32768))),
        "single-block": (ramp, jb.compress(ramp.tobytes())),
        "noshuffle": (i16, jb.compress_with_options(
            i16.tobytes(), JOptions(shuffle=jb.NOSHUFFLE, type_size=2, block_size=16384))),
    }


_FRAMES = None


def _frames():
    global _FRAMES
    if _FRAMES is None:
        _FRAMES = _jax_frames()
    return _FRAMES


_TORCH_DTYPE = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
}


@pytest.mark.parametrize("strategy", ["auto", "transfer", "device"])
@pytest.mark.parametrize(
    "kind",
    ["f32-split", "f32-memcpy-row-ragged", "f64-zstd", "ts3-split", "bitshuffle",
     "single-block", "noshuffle"],
)
def test_decompress_array_reads_tpu_blosc_frames(kind, strategy):
    data, frame = _frames()[kind]
    out = tb.decompress_array(
        frame, _TORCH_DTYPE[data.dtype], device="cpu", strategy=strategy
    )
    assert out.dtype == _TORCH_DTYPE[data.dtype] and out.shape == (data.size,)
    assert out.numpy().tobytes() == data.tobytes()
    assert tb.decompress(frame) == data.tobytes()


def test_decompress_array_device_strategy_runs_the_block_unshuffle(monkeypatch):
    """The device strategy unshuffles full blocks through
    filters.unshuffle_blocks, with the raw rows masked."""
    data, frame = _frames()["f32-memcpy-row-ragged"]
    seen = []
    real = tb.filters.unshuffle_blocks

    def spy(blocks, ts, keep_raw=None, out=None):
        seen.append((tuple(blocks.shape), ts, None if keep_raw is None else keep_raw.tolist()))
        return real(blocks, ts, keep_raw=keep_raw, out=out)

    monkeypatch.setattr(tb.filters, "unshuffle_blocks", spy)
    out = tb.decompress_array(frame, torch.float32, device="cpu", strategy="device")
    assert out.numpy().tobytes() == data.tobytes()
    assert seen == [((4, 65536), 4, [True, False, False, False])]


def test_decompress_array_roundtrip_with_shape():
    data = np.linspace(0, 1, 100_000, dtype=np.float32).reshape(100, 1000)
    frame = tb.compress_array(_tensor(data), tb.Options(block_size=65536))
    for strategy in ("auto", "device"):
        out = tb.decompress_array(frame, torch.float32, shape=(100, 1000),
                                  device="cpu", strategy=strategy)
        assert out.shape == (100, 1000)
        assert np.array_equal(out.numpy(), data)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("block_size", [0, 16384])
def test_compress_with_options_matches_tpu_blosc(codec, shuffle, block_size):
    rng = np.random.default_rng(9)
    data = (np.cumsum(rng.integers(-3, 4, 25_000)) % 5000).astype(np.int32).tobytes()
    jo, to = _opts(codec=codec, shuffle=shuffle, type_size=4, block_size=block_size)
    frame = tb.compress_with_options(data, to)
    assert frame == jb.compress_with_options(data, jo)
    assert tb.decompress(frame) == data
    buf = bytearray(len(data))
    assert tb.decompress_into(frame, buf) == len(data) and bytes(buf) == data


def test_compress_with_options_auto_chunks_past_threshold():
    data = np.arange(tb.api.AUTO_BLOCK_THRESHOLD // 4 + 1000, dtype=np.float32).tobytes()
    frame = tb.compress_with_options(data, tb.Options())
    assert tb.format.parse_header(frame).is_split
    assert frame == jb.compress_with_options(data, JOptions())
    assert tb.get_decompressed_size(frame) == len(data)


def test_options_clamping_matches():
    data = bytes(range(256)) * 64
    for level, ts in [(0, 4), (12, 4), (5, 0), (5, -3)]:
        jo, to = _opts(level=level, type_size=ts)
        assert tb.compress_with_options(data, to) == jb.compress_with_options(data, jo)


def _error_name(fn) -> str:
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__


@pytest.mark.parametrize(
    "case",
    ["empty", "short", "bad-version", "truncated", "bad-codec", "bad-table"],
)
def test_bytes_api_errors_match_by_name(case):
    good = jb.compress_with_options(b"x" * 5000, JOptions(block_size=1024))
    frames = {
        "short": b"\x02\x01",
        "bad-version": b"\x03" + good[1:],
        "truncated": good[: len(good) // 2],
        "bad-codec": good[:1] + b"\x09" + good[2:],
        "bad-table": good[:16] + b"\xff\xff\x00\x00" + good[20:],
    }
    if case == "empty":
        want = _error_name(lambda: jb.compress_with_options(b"", JOptions()))
        got = _error_name(lambda: tb.compress_with_options(b"", tb.Options()))
    else:
        want = _error_name(lambda: jb.decompress(frames[case]))
        got = _error_name(lambda: tb.decompress(frames[case]))
    assert got == want
    assert issubclass(getattr(tb, got), tb.BloscError)


def test_decompress_array_dtype_mismatch():
    frame = tb.compress_with_options(
        b"123", tb.Options(shuffle=tb.Shuffle.NOSHUFFLE, type_size=1)
    )
    assert frame == jb.compress(b"123", jb.LZ4, 5, jb.NOSHUFFLE, 1)
    with pytest.raises(tb.InvalidDataError):
        tb.decompress_array(frame, torch.float32, device="cpu")
    with pytest.raises(jb.InvalidDataError):
        jb.decompress_array(frame, np.float32)


@pytest.mark.parametrize("path", ["rle", "records"])
def test_unported_paths_raise_not_implemented(path):
    """The rle compress strategy and the records decode run (both raised
    NotImplementedError before they were ported) and give tpu_blosc's
    result: its frame, and the array back."""
    data = (np.arange(400_000) // 64).astype(np.float32)
    jo, to = _opts(block_size=65536)
    if path == "rle":
        frame = tb.compress_array(_tensor(data), to, strategy="rle")
        assert frame == jb.compress_array(jnp.asarray(data), jo, strategy="rle")
        assert frame != tb.compress_array(_tensor(data), to)  # the emitter engaged
        assert jb.decompress(frame) == data.tobytes()
    else:
        frame = tb.compress_array(_tensor(data[:393_216]), to)
        got = tb.decompress_array(frame, torch.float32, device="cpu", strategy="records")
        want = jb.decompress_array(frame, np.float32, strategy="records")
        assert got.numpy().tobytes() == np.asarray(want).tobytes() == data[:393_216].tobytes()


@pytest.mark.parametrize(
    "strategy", ["transfer", "match"],
    ids=["bitshuffle-on-device", "match-bitshuffle-on-device"],
)
def test_bitshuffle_on_the_device_route_matches_tpu_blosc(strategy):
    """Multi-block bit-shuffled inputs take the device route (they raised
    NotImplementedError before the bit-shuffle kernel pair was ported)
    and write tpu_blosc's frames."""
    data = np.arange(40_000, dtype=np.float32)
    jo, to = _opts(shuffle="BITSHUFFLE", block_size=16384)
    frame = tb.compress_array(_tensor(data), to, strategy=strategy)
    assert tb.format.parse_header(frame).is_split
    assert frame == jb.compress_array(jnp.asarray(data), jo, strategy=strategy)
    assert jb.decompress(frame) == data.tobytes()


def test_bitshuffle_small_input_takes_host_route():
    # single-block inputs never reach the device route, so bitshuffle works
    data = np.arange(1000, dtype=np.int16)
    jo, to = _opts(shuffle="BITSHUFFLE", type_size=2)
    assert tb.compress_array(_tensor(data), to) == jb.compress_array(jnp.asarray(data), jo)


def _names_a_jax_package_path(value: str) -> bool:
    """Whether a string names ``tpu_blosc`` (not ``tpu_blosc_torch``) as a
    path or a path component."""
    return re.search(r"(^|[/\\])tpu_blosc($|[/\\])", value) is not None


def test_port_imports_no_jax():
    """The port imports nothing of JAX or of tpu_blosc, and no module of it
    names a path under tpu_blosc/ as a file to open: no string of its code
    (docstrings aside, which cite their counterparts) is such a path or
    such a path component."""
    code = (
        "import sys, tpu_blosc_torch, tpu_blosc_torch.stats, tpu_blosc_torch.codecs.standard\n"
        "import tpu_blosc_torch.__main__\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tpu_blosc.'))"
        " or m == 'tpu_blosc')\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    root = pathlib.Path(tb.__file__).parent
    named = []
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        docstrings = {id(node.body[0].value) for node in ast.walk(tree)
                      if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                      and node.body and isinstance(node.body[0], ast.Expr)}
        named += [f"{path.relative_to(root)}:{node.lineno}: {node.value!r}"
                  for node in ast.walk(tree)
                  if isinstance(node, ast.Constant) and isinstance(node.value, str)
                  and id(node) not in docstrings and _names_a_jax_package_path(node.value)]
    assert not named, named
    assert _names_a_jax_package_path("tpu_blosc/native/tpublosc.cpp")
    assert not _names_a_jax_package_path("tpu_blosc_torch/native/tpublosc.cpp")


def test_decompress_array_without_cuda_refuses_the_default_device():
    """With no card, the default device raises instead of decoding onto
    the CPU, and so does an explicit CUDA request."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    frame = tb.compress_array(torch.arange(40_000, dtype=torch.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.decompress_array(frame, torch.float32)
    for strategy in ("auto", "device"):
        with pytest.raises((RuntimeError, AssertionError)):
            tb.decompress_array(frame, torch.float32, device="cuda", strategy=strategy)


def _batch_items():
    rng = np.random.default_rng(21)
    return [
        b"tiny",
        np.arange(3000, dtype=np.float32),
        rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),  # memcpy frame
        memoryview(np.arange(5000, dtype=np.int64).tobytes()),
        np.arange(tb.api.AUTO_BLOCK_THRESHOLD // 4 + 100, dtype=np.float32),  # multi-block
    ]


@pytest.mark.parametrize("shuffle", SHUFFLES)
def test_batch_calls_match_tpu_blosc(shuffle):
    items = _batch_items()
    jo, to = _opts(shuffle=shuffle, codec="ZSTD", type_size=4)
    frames = tb.compress_batch_with_options(items, to)
    assert frames == jb.compress_batch_with_options(items, jo)
    assert frames == [tb.compress_with_options(x, to) for x in items]
    want = [bytes(x) if not isinstance(x, np.ndarray) else x.tobytes() for x in items]
    assert tb.decompress_batch(frames) == want
    assert tb.decompress_batch(frames, 2) == jb.decompress_batch(frames, 2)
    outs = [bytearray(len(w)) for w in want]
    assert tb.decompress_batch_into(frames, outs) == [len(w) for w in want]
    assert [bytes(o) for o in outs] == want


def test_batch_errors_match_the_scalar_path():
    with pytest.raises(tb.InvalidDataError, match="batch item 1"):
        tb.compress_batch_with_options([b"x", b""], tb.Options())
    frames = tb.compress_batch_with_options([b"abc" * 100, b"def" * 100], tb.Options())
    with pytest.raises(tb.BloscError):
        tb.decompress_batch([frames[0], frames[1][:20]])
    with pytest.raises(tb.InvalidDataError, match="too small"):
        tb.decompress_batch_into(frames, [bytearray(300), bytearray(10)])
    with pytest.raises(ValueError):
        tb.decompress_batch_into(frames, [bytearray(300)])


@pytest.mark.parametrize("layout", ["single-block", "split", "bitshuffle-split", "container"])
def test_decompress_range_matches_tpu_blosc(layout):
    data = (np.arange(150_000, dtype=np.int32) // 7).tobytes()
    if layout == "container":
        frame = tb.container.compress_container(data, tb.Options(block_size=8192),
                                                frame_limit=100_000)
    else:
        jo, to = _opts(shuffle="BITSHUFFLE" if layout.startswith("bit") else "SHUFFLE",
                       block_size=0 if layout == "single-block" else 8192)
        frame = tb.compress_with_options(data, to)
    for start, size in ((0, 0), (0, 10), (8191, 2), (9000, 100_000), (5, len(data) - 5),
                        (len(data) - 3, 3)):
        want = data[start : start + size]
        assert tb.decompress_range(frame, start, size) == want
        assert jb.decompress_range(frame, start, size) == want
        out = bytearray(size + 7)
        assert tb.decompress_range_into(frame, start, size, out) == size
        assert bytes(out[:size]) == want
    for start, size in ((-1, 4), (len(data) - 3, 4)):
        for fn in (tb.decompress_range, jb.decompress_range):
            with pytest.raises(Exception) as info:
                fn(frame, start, size)
            assert type(info.value).__name__ in ("InvalidDataError", "SizeMismatchError")


def test_get_info_matches_tpu_blosc():
    frame = tb.compress_with_options(b"x" * 50_000, tb.Options(block_size=16384))
    assert tb.get_info(frame) == tb.format.parse_header(frame)
    assert vars(tb.get_info(frame)) == vars(jb.get_info(frame))
