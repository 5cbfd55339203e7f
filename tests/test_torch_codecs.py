"""The port's codec registry and standard codecs against tpu_blosc's, on the CPU.

≙ tests/test_codecs.py.  The six standard codec objects write tpu_blosc's
streams byte for byte (ZSTD: each package's object decodes the other's);
a codec registered in both packages with the same object (a new ID, or
one in place of LZ4) gives tpu_blosc's frames, streams, envelopes and
checkpoint files from every entry point, and each package decodes the
other's.  One exception is the reference's and not the port's:
``compress_array(strategy="match"|"auto"|"rle")`` under an override of
LZ4 gives the host frame in the port (the transfer route), where tpu_blosc
writes its rows with the native LZ4 emitter.  Every comparison is exact.
"""

from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from torch_registry import both_registries, make_codec
from tpu_blosc import container as jcont
from tpu_blosc.codecs import lz4_ref
from tpu_blosc.codecs import registry as jreg
from tpu_blosc.codecs import standard as jstd
from tpu_blosc.dist import multihost as jmh
from tpu_blosc_torch import container as tcont
from tpu_blosc_torch.codecs import registry as treg
from tpu_blosc_torch.codecs import standard as tstd
from tpu_blosc_torch.dist import mesh as tmesh
from tpu_blosc_torch.dist import multihost as tmh
from tpu_blosc_torch.native import backend as tnb

rng = np.random.default_rng(7)

CORPUS = [
    b"a",
    b"a" * 35,
    b"abc" * 11,
    bytes(range(256)) * 8,
    rng.integers(0, 256, 10000, dtype=np.uint8).tobytes(),  # incompressible
    np.arange(4096, dtype=np.float32).tobytes(),
    b"\x00" * 5000,
    b"the quick brown fox jumps over the lazy dog. " * 100,
    rng.integers(0, 4, 8192, dtype=np.uint8).tobytes(),  # low entropy
]

STANDARD = {
    "blosclz": ("BloscLzCodec", [5]),
    "lz4": ("Lz4Codec", [5]),
    "lz4hc": ("Lz4HcCodec", list(range(1, 10))),
    "snappy": ("SnappyCodec", [5]),
    "zlib": ("ZlibCodec", [1, 6, 9]),
}
STANDARD_CASES = [(name, level) for name, (_, levels) in STANDARD.items() for level in levels]

# (codec ID, codec kind): two new IDs, and LZ4 taken over by a wrapper of
# the builtin and by another codec
REGISTERED = {
    "zlib1 at 42": (42, "zlib1"),
    "identity at 43": (43, "identity"),
    "lz4 by a counting wrapper": (1, "counting-lz4"),
    "lz4 by zlib1": (1, "zlib1"),
}


@pytest.fixture(params=sorted(REGISTERED))
def registered(request):
    """(codec ID, the codec object) registered in both packages."""
    cid, kind = REGISTERED[request.param]
    with both_registries() as register:
        yield cid, register(cid, make_codec(kind))


def _opts(pkg, cid, **kw):
    return pkg.Options(codec=cid, **kw)


def _ramp(n: int, seed: int = 0) -> bytes:
    """n bytes of a float32 ramp, the low mantissa byte of every 7th value
    random (no NaN, so values compare as bytes do)."""
    a = np.arange(n // 4 + 1, dtype=np.float32)
    low = a.view(np.uint8)[::28]
    low[:] = np.random.default_rng(seed).integers(0, 256, low.size)
    return a.tobytes()[:n]


# -- the standard codec objects -------------------------------------------


@pytest.mark.parametrize("i", range(len(CORPUS)))
@pytest.mark.parametrize("name,level", STANDARD_CASES)
def test_standard_codec_writes_tpu_blosc_stream(name, level, i):
    cls, _ = STANDARD[name]
    mine, theirs = getattr(tstd, cls)(), getattr(jstd, cls)()
    data = CORPUS[i]
    comp = mine.compress(data, level)
    assert comp == theirs.compress(data, level)
    assert mine.name() == theirs.name() == name
    assert mine.decompress(comp, len(data)) == theirs.decompress(comp, len(data)) == data


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_zstd_objects_decode_each_others_streams(i):
    mine, theirs = tstd.ZstdCodec(), jstd.ZstdCodec()
    data = CORPUS[i]
    for level in (1, 3, 5, 9):
        assert mine.decompress(theirs.compress(data, level), len(data)) == data
        assert theirs.decompress(mine.compress(data, level), len(data)) == data


def test_level_mappings_equal_tpu_blosc():
    for level in range(0, 12):
        assert tstd.hc_depth_for_level(level) == lz4_ref.hc_depth_for_level(level)
        assert tstd.ZstdCodec._tier(level) == jstd.ZstdCodec._tier(level)


def test_zlib_refuses_levels_outside_1_to_9():
    codec = tb.get_codec(tb.ZLIB)
    for level in (0, 10):
        with pytest.raises(tb.CompressionFailedError):
            codec.compress(b"data", level)


@pytest.mark.parametrize("name", ["lz4", "blosclz", "snappy"])
def test_native_decoders_refuse_malformed_streams(name):
    decode = getattr(tnb, f"{name}_decompress")
    with pytest.raises(tb.DecompressionFailedError):
        decode(b"\xf0\xff\xff", 100)


def test_the_registries_list_the_same_codecs():
    assert tb.list_codecs() == jb.list_codecs()
    for cid in range(6):
        assert type(tb.get_codec(cid)).__name__ == type(jb.get_codec(cid)).__name__
        assert tstd.is_builtin(cid) and jstd.is_builtin(cid)
        assert isinstance(tb.get_codec(cid), tb.codecs.CodecProtocol)


def test_id_7_raises_in_both_packages():
    for pkg in (jb, tb):
        with pytest.raises(pkg.InvalidCodecError):
            pkg.compress(b"data", 7, 5, pkg.NOSHUFFLE, 1)
        with pytest.raises(pkg.InvalidCodecError):
            pkg.compress_with_options(b"data" * 2000, pkg.Options(codec=7, block_size=4096))
        assert pkg.get_codec(7) is None
    with both_registries() as register:
        register(42, make_codec("zlib1"))
        frame = tb.compress(b"data" * 100, 42, 5, tb.NOSHUFFLE, 1)
    for pkg in (jb, tb):  # the codec is gone again: its frame does not decode
        with pytest.raises(pkg.InvalidCodecError):
            pkg.decompress(frame)


def test_zstd_without_zstandard_keeps_the_native_pipeline(monkeypatch):
    """Where ``zstandard`` does not import, ZSTD is not registered, yet
    ``is_builtin(ZSTD)`` holds (no entry is the builtin one), so the
    native ZSTD pipeline writes and reads the frames as before."""
    data = _ramp(300_000)
    frames = [tb.compress_with_options(data, tb.Options(codec=tb.ZSTD, block_size=bs))
              for bs in (0, 65536)]
    with both_registries():
        monkeypatch.setitem(sys.modules, "zstandard", None)
        with pytest.raises(RuntimeError, match="zstandard"):
            tstd.ZstdCodec()
        with treg._lock:
            treg._codecs.clear()
            tstd._BUILTIN_INSTANCES.clear()
        tstd.register_standard_codecs()
        assert tb.get_codec(tb.ZSTD) is None and tstd.is_builtin(tb.ZSTD)
        assert tb.ZSTD not in tb.list_codecs() and len(tb.list_codecs()) == 5
        for bs, frame in zip((0, 65536), frames):
            assert tb.compress_with_options(data, tb.Options(codec=tb.ZSTD, block_size=bs)) == frame
            assert tb.decompress(frame) == data
    assert tb.get_codec(tb.ZSTD) is not None and tb.list_codecs() == jb.list_codecs()


def test_register_codec_changes_dispatch_at_once():
    data = _ramp(100_000)
    native = tb.compress(data)
    with both_registries() as register:
        wrapper = register(tb.LZ4, make_codec("counting-lz4"))
        assert not tstd.is_builtin(tb.LZ4)
        assert tb.compress(data) == jb.compress(data)
        assert wrapper.compressed == 2  # one block in each package
    assert tstd.is_builtin(tb.LZ4) and tb.compress(data) == native


# -- the bytes API under a registered codec --------------------------------


@pytest.mark.parametrize("shuffle", ["NOSHUFFLE", "SHUFFLE", "BITSHUFFLE"])
@pytest.mark.parametrize("n,block_size", [(1000, 0), (100_003, 0), (1 << 20, 65536),
                                          ((4 << 20) + 13, 0)])
def test_compress_with_a_registered_codec_equals_tpu_blosc(registered, shuffle, n, block_size):
    cid, _ = registered
    data = _ramp(n, seed=n)
    kw = dict(shuffle=getattr(tb.Shuffle, shuffle), type_size=4, block_size=block_size)
    mine = tb.compress_with_options(data, _opts(tb, cid, **kw))
    theirs = jb.compress_with_options(data, _opts(jb, cid, **{**kw, "shuffle": getattr(
        jb.Shuffle, shuffle)}))
    assert mine == theirs
    assert tb.get_info(mine).is_split == (block_size > 0 or n > tb.AUTO_BLOCK_THRESHOLD)
    assert tb.decompress(theirs) == data and jb.decompress(mine) == data
    if block_size == 0 and n <= tb.AUTO_BLOCK_THRESHOLD:
        assert tb.compress(data, cid, 5, getattr(tb.Shuffle, shuffle), 4) == mine


def test_compress_batch_with_a_registered_codec_equals_tpu_blosc(registered):
    cid, _ = registered
    items = [_ramp(n, seed=n) for n in (7, 1000, 65_536, (4 << 20) + 5)]
    mine = tb.compress_batch(items, cid, 5, tb.SHUFFLE, 4)
    assert mine == jb.compress_batch(items, cid, 5, jb.SHUFFLE, 4)
    assert tb.decompress_batch(mine) == items == jb.decompress_batch(mine)
    outs = [np.empty(len(x), np.uint8) for x in items]
    assert tb.decompress_batch_into(mine, outs) == [len(x) for x in items]
    assert [o.tobytes() for o in outs] == items


def test_the_container_with_a_registered_codec_equals_tpu_blosc(registered):
    cid, _ = registered
    data = _ramp(300_000)
    mine = tcont.compress_container(data, _opts(tb, cid, block_size=16384), frame_limit=65536)
    theirs = jcont.compress_container(data, _opts(jb, cid, block_size=16384),
                                      frame_limit=65536)
    assert mine == theirs and mine[:4] == b"TPB2"
    assert tb.decompress(mine) == data == jb.decompress(mine)
    out = bytearray(len(data))
    assert tb.decompress_into(mine, out) == len(data) and bytes(out) == data
    assert tb.decompress_range(mine, 60_000, 100_000) == data[60_000:160_000]


@pytest.mark.parametrize("frame_kind", ["single", "split", "split, ts 2 read"])
def test_decoders_with_a_registered_codec_equal_tpu_blosc(registered, frame_kind):
    """decompress, decompress_into, decompress_range(_into) on a
    single-block and a split frame (read at another type size too)."""
    cid, _ = registered
    data = _ramp(200_000 if frame_kind == "single" else 1 << 20, seed=3)
    bs = 0 if frame_kind == "single" else 32768
    frame = jb.compress_with_options(data, _opts(jb, cid, block_size=bs))
    ts = 2 if frame_kind.endswith("read") else 0
    assert tb.decompress_with_size(frame, ts) == jb.decompress_with_size(frame, ts)
    out = np.empty(len(data) + 5, np.uint8)
    assert tb.decompress_into(frame, out) == len(data) and out[: len(data)].tobytes() == data
    for start, size in ((0, len(data)), (5, 33_000), (32_768, 4 * 32_768 + 9), (len(data) - 3, 3)):
        want = jb.decompress_range(frame, start, size, ts)
        assert tb.decompress_range(frame, start, size, ts) == want
        buf = bytearray(size)
        assert tb.decompress_range_into(frame, start, size, buf, ts) == size
        assert bytes(buf) == want


# -- the device entry points, files and distribution -----------------------


def _tensor(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy()).view(torch.float32)


@pytest.mark.parametrize("shuffle", ["SHUFFLE", "BITSHUFFLE"])
def test_compress_array_with_a_registered_codec_is_the_host_frame(registered, shuffle):
    """The transfer route keeps the filter on the tensor's device and
    calls the registered codec per block: tpu_blosc's frame, and the host
    frame; decompress_array gives the tensor back by every strategy."""
    cid, _ = registered
    data = _ramp((1 << 20) + 40)
    kw = dict(shuffle=getattr(tb.Shuffle, shuffle), block_size=131072)
    mine = tb.compress_array(_tensor(data), _opts(tb, cid, **kw))
    jkw = {**kw, "shuffle": getattr(jb.Shuffle, shuffle)}
    assert mine == jb.compress_array(jnp.asarray(np.frombuffer(data, np.float32)),
                                     _opts(jb, cid, **jkw))
    assert mine == tb.compress_with_options(data, _opts(tb, cid, **kw))
    for strategy in ("auto", "device", "records"):
        got = tb.decompress_array(mine, torch.float32, device="cpu", strategy=strategy)
        assert got.view(torch.uint8).numpy().tobytes() == data


@pytest.mark.parametrize("shuffle,tail", [("SHUFFLE", 0), ("SHUFFLE", 123), ("BITSHUFFLE", 77)])
def test_the_device_decode_with_a_registered_codec_unfilters_on_the_device(
        registered, shuffle, tail, monkeypatch):
    """decompress_array(strategy="device") of tpu_blosc's frame: the
    registered codec decodes the blocks on the host, the block kernels'
    unfilter runs once on the target device, and the bytes are
    tpu_blosc's."""
    cid, _ = registered
    data = _ramp((1 << 20) + tail, seed=tail)
    frame = jb.compress_with_options(data, _opts(jb, cid, shuffle=getattr(jb.Shuffle, shuffle),
                                                  block_size=131072))
    calls = []
    unfilter = tb.filters.unfilter_blocks
    monkeypatch.setattr(tb.filters, "unfilter_blocks",
                        lambda *a, **kw: calls.append(a[0].shape) or unfilter(*a, **kw))
    got = tb.decompress_array(frame, torch.uint8, device="cpu", strategy="device")
    assert got.numpy().tobytes() == jb.decompress(frame) == data
    assert calls == [(8, 131072)]


def test_the_device_decode_of_an_id_with_no_codec_raises_as_tpu_blosc():
    with both_registries() as register:
        register(42, make_codec("zlib1"))
        frame = jb.compress_with_options(_ramp(1 << 20), _opts(jb, 42, block_size=131072))
    with pytest.raises(jb.InvalidCodecError):
        jb.decompress(frame)
    for strategy in ("device", "auto"):
        with pytest.raises(tb.InvalidCodecError):
            tb.decompress_array(frame, torch.uint8, device="cpu", strategy=strategy)


@pytest.mark.parametrize("strategy", ["match", "auto", "rle"])
def test_strategies_under_an_override_of_lz4_give_the_host_frame(strategy):
    """tpu_blosc writes the rows with the native LZ4 emitter and the tail
    with the registered codec; the port takes the transfer route, so its
    frame is tpu_blosc's host frame and decodes with the override."""
    data = _ramp((1 << 20) + 64)
    x = _tensor(data)
    opts = tb.Options(block_size=131072)
    with both_registries() as register:
        register(tb.LZ4, make_codec("zlib1"))
        host = jb.compress_with_options(data, jb.Options(block_size=131072))
        mine = tb.compress_array(x, opts, strategy=strategy)
        assert mine == host == tb.compress_array(x, opts)
        assert tb.decompress(mine) == data == jb.decompress(mine)


@pytest.mark.parametrize("strategy", ["match", "rle"])
def test_strategies_without_an_override_keep_tpu_blosc_strategy_frame(strategy):
    """On data each strategy engages on (its frame is not the host's)."""
    data = (np.tile(np.arange(64, dtype=np.float32), 1 << 12) if strategy == "match"
            else np.arange(1 << 18, dtype=np.int32) // 64).tobytes()
    x = _tensor(data)
    mine = tb.compress_array(x, tb.Options(block_size=131072), strategy=strategy)
    theirs = jb.compress_array(jnp.asarray(np.frombuffer(data, np.float32)),
                               jb.Options(block_size=131072), strategy=strategy)
    assert mine == theirs != tb.compress_with_options(data, tb.Options(block_size=131072))


def test_pack_array_with_a_registered_codec_equals_tpu_blosc(registered):
    cid, _ = registered
    arr = np.frombuffer(_ramp(400_000), np.float32).reshape(1000, 100)
    mine = tb.pack_array(torch.from_numpy(arr.copy()), _opts(tb, cid, type_size=4))
    assert mine == jb.pack_array(arr, _opts(jb, cid, type_size=4))
    assert mine == tb.pack_array(arr, _opts(tb, cid, type_size=4))
    assert np.array_equal(tb.unpack_array(mine).numpy(), arr)
    assert np.array_equal(np.asarray(jb.unpack_array(mine)), arr)
    assert np.array_equal(tb.unpack_array_rows(mine, 10, 700).numpy(), arr[10:700])


def test_a_stream_record_with_a_registered_codec_equals_tpu_blosc(registered, tmp_path):
    cid, _ = registered
    data = _ramp(300_000)
    paths = [tmp_path / "mine.tpbs", tmp_path / "theirs.tpbs"]
    for pkg, path in zip((tb, jb), paths):
        with pkg.StreamWriter(str(path), _opts(pkg, cid, block_size=65536)) as w:
            w.write(data)
            w.write(data[:1000])
    assert paths[0].read_bytes() == paths[1].read_bytes()
    with tb.StreamReader(str(paths[1])) as r:
        assert r.read(0) == data and r.read(1) == data[:1000]
        assert r.read_range(0, 70_000, 1000) == data[70_000:71_000]
        assert r.verify(deep=True) == 2


def test_save_pytree_with_a_registered_codec_equals_tpu_blosc(registered, tmp_path):
    cid, _ = registered
    big = np.frombuffer(_ramp(5 << 20), np.float32)
    small = np.arange(300, dtype=np.int16)
    mine, theirs = tmp_path / "mine.ckpt", tmp_path / "theirs.ckpt"
    tb.save_pytree(str(mine), {"big": torch.from_numpy(big.copy()), "small":
                               torch.from_numpy(small), "step": 3}, _opts(tb, cid))
    jb.save_pytree(str(theirs), {"big": big, "small": small, "step": 3}, _opts(jb, cid))
    assert mine.read_bytes() == theirs.read_bytes()
    for path in (mine, theirs):
        tree = tb.load_pytree(str(path))
        assert np.array_equal(tree["big"].numpy(), big) and tree["step"] == 3
        assert np.array_equal(tree["small"].numpy(), small)
        assert np.array_equal(tb.load_leaf(str(path), "big").numpy(), big)
        got = tb.load_pytree(str(path), device="cpu", strategy="records")
        assert np.array_equal(got["big"].numpy(), big)


@pytest.mark.parametrize("shuffle,tail", [("SHUFFLE", 0), ("SHUFFLE", 123), ("BITSHUFFLE", 77),
                                          ("NOSHUFFLE", 5)])
def test_the_mesh_frame_with_a_registered_codec_is_the_host_frame(registered, shuffle, tail):
    """One rank on the CPU: compress_chunked_mesh gives the host frame
    (as tests/test_torch_dist.py holds it), decompress_chunked_mesh the
    bytes, and the multihost pair the same."""
    cid, _ = registered
    data = _ramp((1 << 20) + tail, seed=tail)
    opts = _opts(tb, cid, shuffle=getattr(tb.Shuffle, shuffle), block_size=131072)
    host = tb.compress_with_options(data, opts)
    for stats in (False, True):
        got = tmesh.compress_chunked_mesh(data, opts, device="cpu", return_stats=stats)
        assert (got[0] if stats else got) == host
    assert tmesh.decompress_chunked_mesh(host, device="cpu") == data
    assert tmh.compress_chunked_multihost(len(data), data, opts) == host
    assert tmh.decompress_chunked_multihost(host) == (data, 0, len(data))
    jopts = _opts(jb, cid, shuffle=getattr(jb.Shuffle, shuffle), block_size=131072)
    assert jmh.compress_chunked_multihost(len(data), data, jopts) == host


def test_the_registries_are_restored_after_each_case():
    assert tb.list_codecs() == jb.list_codecs()
    for cid in range(6):
        assert tstd.is_builtin(cid) and jstd.is_builtin(cid)
    assert tb.get_codec(42) is None and jb.get_codec(42) is None
    assert treg.registry_version() > 0 and jreg.registry_version() > 0
