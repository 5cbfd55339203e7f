"""The port's TPBS streams against the JAX package's, on the CPU.

After tests/test_stream.py: the same records give byte-identical files
from both packages (checksums on and off, appended, written one by one or
in a batch), each package reads the other's files, and the port's reader
keeps the footer-less scan, the crc checks and the range reads.  Tensors
go in through write_array and come out through read_array on ``device=``
("cpu" here).  The dictionary mode needs ``zstandard``; its tests skip
where that is missing.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import pytest
import torch
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc import stream as jstream
from tpu_blosc.options import Options as JOptions
from tpu_blosc_torch import stream as tstream
from tpu_blosc_torch.stream import FOOTER_MAGIC, StreamReader, StreamWriter


@pytest.fixture
def zstandard():
    """The dictionary mode's package; the test skips where it is missing."""
    return pytest.importorskip("zstandard", reason="the dictionary mode needs zstandard")


def _chunks():
    rng = np.random.default_rng(42)
    return [
        np.arange(30_000, dtype=np.float32).tobytes(),
        rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes(),
        (np.arange(50_000, dtype=np.int16) % 100).tobytes(),
    ]


def _write(mod, path, chunks, opts=None, **kw):
    with mod.StreamWriter(path, opts, **kw) as w:
        for c in chunks:
            w.write(c)


@pytest.mark.parametrize("checksum", [False, True])
def test_same_file_and_cross_read(tmp_path, checksum):
    chunks = _chunks()
    mine, theirs = tmp_path / "t.tpbs", tmp_path / "j.tpbs"
    _write(tstream, mine, chunks, checksum=checksum)
    _write(jstream, theirs, chunks, checksum=checksum)
    assert mine.read_bytes() == theirs.read_bytes()
    with StreamReader(theirs) as r:
        assert list(r) == chunks and r.read_many() == chunks
    with jstream.StreamReader(mine) as r:
        assert list(r) == chunks


def test_appended_stream_same_file_and_cross_append(tmp_path):
    chunks = _chunks()
    mine, theirs = tmp_path / "t.tpbs", tmp_path / "j.tpbs"
    for mod, path in ((tstream, mine), (jstream, theirs)):
        _write(mod, path, chunks[:1], checksum=True)
        with mod.StreamWriter(path, append=True) as w:
            assert len(w) == 1
            w.write(chunks[1])
            w.write(chunks[2])
    assert mine.read_bytes() == theirs.read_bytes()
    # each package appends to the other's file
    with StreamWriter(theirs, append=True) as w:
        w.write(b"tail" * 300)
    with jstream.StreamWriter(mine, append=True) as w:
        w.write(b"tail" * 300)
    assert mine.read_bytes() == theirs.read_bytes()
    with StreamReader(mine) as r:
        assert r._crc and list(r) == chunks + [b"tail" * 300]


def test_stream_roundtrip_and_sizes(tmp_path):
    path = tmp_path / "s.tpbs"
    chunks = _chunks()
    with StreamWriter(path) as w:
        for i, c in enumerate(chunks):
            assert w.write(c) == i
        assert len(w) == len(chunks)
    with StreamReader(path) as r:
        assert len(r) == len(chunks) and r[1] == chunks[1]
        assert [o for _, o in r.sizes()] == [len(c) for c in chunks]
        assert [r.peek_size(i) for i in range(3)] == [len(c) for c in chunks]
        with pytest.raises(IndexError):
            r.read(5)
    with pytest.raises(ValueError):
        w.write(b"after close")


def test_stream_footer_recovery_and_torn_record(tmp_path):
    path = tmp_path / "s.tpbs"
    chunks = _chunks()
    _write(tstream, path, chunks, checksum=True)
    raw = path.read_bytes()
    assert raw.endswith(FOOTER_MAGIC)
    (index_size,) = struct.unpack("<Q", raw[-12:-4])
    data = raw[: len(raw) - index_size]
    path.write_bytes(data)  # a writer that crashed before close
    with StreamReader(path) as r:
        assert list(r) == chunks
    path.write_bytes(data[:-7])  # and tore its last record
    with StreamReader(path) as r:
        assert len(r) == len(chunks) - 1 and r.read(0) == chunks[0]
    path.write_bytes(data)
    with StreamWriter(path, append=True) as w:
        w.write(b"tail-record-data" * 100)
    with jstream.StreamReader(path) as r:
        assert len(r) == len(chunks) + 1


def test_stream_not_a_stream_and_bad_version(tmp_path):
    for blob in (b"not a stream at all", b"TPBS\x09\x00\x00\x00"):
        path = tmp_path / "x.bin"
        path.write_bytes(blob)
        with pytest.raises(tb.InvalidHeaderError):
            StreamReader(path)


def test_stream_checksum_detects_a_flipped_byte(tmp_path):
    path = tmp_path / "crc.tpbs"
    recs = [np.arange(2000 + i, dtype=np.int32).tobytes() for i in range(5)]
    _write(tstream, path, recs, checksum=True)
    with StreamReader(path) as r:
        assert r.verify() == 5 and r.verify(deep=True) == 5
        off = r._offsets[2]
    blob = bytearray(path.read_bytes())
    blob[off + 8 + 20] ^= 0xFF
    path.write_bytes(bytes(blob))
    with StreamReader(path) as r:
        with pytest.raises(tb.BloscError, match="checksum"):
            r.read(2)
        assert r.read(1) == recs[1]
        with pytest.raises(tb.BloscError):
            r.verify()


def test_stream_verify_deep_catches_a_bad_payload(tmp_path):
    path = tmp_path / "v.tpbs"
    chunks = [np.arange(4000 + i, dtype=np.float32).tobytes() for i in range(6)]
    with StreamWriter(path, checksum=True) as w:
        w.write_many(chunks)
    with StreamReader(path) as r:
        off = r._offsets[2]
    raw = bytearray(path.read_bytes())
    (flen,) = struct.unpack_from("<Q", raw, off)
    raw[off + 8 + 30] ^= 0xFF
    struct.pack_into("<I", raw, off + 8 + flen, zlib.crc32(bytes(raw[off + 8 : off + 8 + flen])))
    path.write_bytes(bytes(raw))
    with StreamReader(path) as r:
        assert r.verify() == 6
        with pytest.raises(tb.BloscError):
            r.verify(deep=True)


def test_stream_write_many_same_file_as_write(tmp_path):
    chunks = _chunks() + [b"small" * 10, bytes(400_000), np.arange(3000, dtype=np.float64)]
    a, b, c = tmp_path / "a.tpbs", tmp_path / "b.tpbs", tmp_path / "c.tpbs"
    with StreamWriter(a, checksum=True) as w:
        assert w.write_many(chunks) == list(range(len(chunks)))
    _write(tstream, b, chunks, checksum=True)
    with jstream.StreamWriter(c, checksum=True) as w:
        w.write_many(chunks)
    assert a.read_bytes() == b.read_bytes() == c.read_bytes()
    want = [bytes(x) if not isinstance(x, np.ndarray) else x.tobytes() for x in chunks]
    with StreamReader(a) as r:
        assert r.read_many() == want
        assert r.read_many([2, 0]) == [want[2], want[0]]
        outs = [bytearray(len(x)) for x in want]
        assert r.read_many_into(range(len(want)), outs) == [len(x) for x in want]
        assert [bytes(o) for o in outs] == want


def test_stream_read_range(tmp_path):
    path = tmp_path / "rr.tpbs"
    data = np.arange(200_000, dtype=np.int32).tobytes()
    with StreamWriter(path, tb.Options(block_size=16384, type_size=4)) as w:
        w.write(data)
    with StreamReader(path) as r:
        assert r.read_range(0, 100_000, 5000) == data[100_000:105_000]
        assert r.read_range(0, 0, 0) == b""


def test_stream_container_records(tmp_path):
    path = tmp_path / "big.tpbs"
    data = np.arange(200_000, dtype=np.float32).tobytes()
    frame = tb.container.compress_container(data, tb.Options(block_size=65536),
                                            frame_limit=131072)
    with StreamWriter(path) as w:
        w.write_frame(frame)
    with StreamReader(path) as r:
        assert r.read(0) == data and r.peek_size(0) == len(data)


def test_stream_arrays_same_file_and_read_array(tmp_path):
    arr = np.linspace(0, 1, 500_000, dtype=np.float32)
    mine, theirs = tmp_path / "t.tpbs", tmp_path / "j.tpbs"
    with StreamWriter(mine, tb.Options(block_size=262144)) as w:
        w.write_array(torch.from_numpy(arr))
        w.write_array(torch.from_numpy(arr), tb.Options(shuffle=tb.Shuffle.BITSHUFFLE,
                                                         block_size=131072))
    import jax.numpy as jnp

    with jstream.StreamWriter(theirs, JOptions(block_size=262144)) as w:
        w.write_array(jnp.asarray(arr))
        w.write_array(jnp.asarray(arr), JOptions(shuffle=jb.BITSHUFFLE, block_size=131072))
    assert mine.read_bytes() == theirs.read_bytes()
    with StreamReader(theirs) as r:
        for i in range(2):
            for strategy in ("auto", "device"):
                out = r.read_array(i, torch.float32, shape=(1000, 500), device="cpu",
                                   strategy=strategy)
                assert out.shape == (1000, 500)
                assert np.array_equal(out.numpy().reshape(-1), arr)


def test_stream_read_array_forwards_strategy(tmp_path, monkeypatch):
    path = tmp_path / "s.tpbs"
    arr = np.arange(10_000, dtype=np.float32)
    with StreamWriter(path) as w:
        w.write_array(torch.from_numpy(arr))
    seen = {}
    real = tb.device.decompress_array

    def spy(data, dtype, shape=None, device=None, sharding=None, strategy="auto"):
        seen["strategy"] = strategy
        return real(data, dtype, shape=shape, device=device, sharding=sharding,
                    strategy=strategy)

    monkeypatch.setattr(tb.device, "decompress_array", spy)
    with StreamReader(path) as r:
        out = r.read_array(0, torch.float32, device="cpu", strategy="transfer")
    assert seen["strategy"] == "transfer"
    assert np.array_equal(out.numpy(), arr)


def test_stream_save_load_convenience(tmp_path):
    data = os.urandom(5000)
    tb.save(tmp_path / "c.tpbs", data)
    assert tb.load(tmp_path / "c.tpbs") == data
    assert jb.load(tmp_path / "c.tpbs") == data
    arr = np.arange(100_000, dtype=np.float64)
    tb.save_array(tmp_path / "d.tpbs", torch.from_numpy(arr), tb.Options(type_size=8))
    out = tb.load_array(tmp_path / "d.tpbs", torch.float64, device="cpu")
    assert np.array_equal(out.numpy(), arr)
    assert np.array_equal(np.asarray(jb.load_array(tmp_path / "d.tpbs", np.float64)), arr)


def test_stream_iter_arrays_prefetch(tmp_path):
    path = tmp_path / "it.tpbs"
    batches = [np.arange(i * 100, i * 100 + 25_000, dtype=np.float32) for i in range(6)]
    with StreamWriter(path, tb.Options(block_size=32768)) as w:
        for b in batches:
            w.write(b.tobytes())
    with StreamReader(path) as r:
        it = r.iter_arrays(torch.float32, device="cpu", prefetch=3)
        assert len(it) == 6
        for got, want in zip(list(it), batches):
            assert np.array_equal(got.numpy(), want)
        assert len(list(it)) == 6


def test_stream_iter_arrays_error_propagates(tmp_path):
    path = tmp_path / "bad.tpbs"
    with StreamWriter(path) as w:
        w.write(b"ok" * 5000)
    raw = bytearray(path.read_bytes())
    raw[40] ^= 0xFF
    path.write_bytes(bytes(raw))
    with StreamReader(path) as r:
        with pytest.raises(Exception):
            for _ in r.iter_arrays(torch.uint8, device="cpu"):
                pass


def test_iter_prefetch_abandoned_consumer_stops_producer():
    import threading
    import time

    before = set(threading.enumerate())
    it = tstream._iter_prefetch(lambda i: i, 1000, prefetch=1)
    next(it)
    time.sleep(0.2)
    it.close()
    deadline = time.monotonic() + 5
    leaked = []
    while time.monotonic() < deadline:
        leaked = [t for t in threading.enumerate() if t not in before and t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked


def test_stream_corruption_never_crashes(tmp_path):
    """Byte flips, truncations and garbage tails: a read raises a
    BloscError or IndexError, or returns data of a bounded size."""
    rng = np.random.default_rng(12)
    path = tmp_path / "f.tpbs"
    _write(tstream, path, [b"alpha" * 200, b"beta" * 500, bytes(range(256)) * 8])
    good = path.read_bytes()
    for trial in range(60):
        raw = bytearray(good)
        mode = trial % 3
        if mode == 0:
            raw[int(rng.integers(len(raw)))] ^= int(rng.integers(1, 256))
        elif mode == 1:
            raw = raw[: int(rng.integers(len(raw) + 1))]
        else:
            raw += rng.integers(0, 256, int(rng.integers(65)), dtype=np.uint8).tobytes()
        path.write_bytes(bytes(raw))
        try:
            with StreamReader(path) as r:
                for i in range(len(r)):
                    try:
                        assert len(r.read(i)) < 10_000_000
                    except tb.BloscError:
                        continue
        except (tb.BloscError, IndexError):
            pass


def _jsonish_records(n=40):
    rng = np.random.default_rng(13)
    return [
        (b'{"user_id": %d, "event": "click", "ts": 1700000%03d, '
         b'"session": "abcdef%04d", "payload": {"x": %d, "y": %d}}'
         % (int(rng.integers(1e6)), i, i, int(rng.integers(1920)), int(rng.integers(1080))))
        * 8
        for i in range(n)
    ]


def test_stream_dict_training_same_file_and_cross_read(tmp_path, zstandard):
    recs = _jsonish_records()
    mine, theirs = tmp_path / "t.tpbs", tmp_path / "j.tpbs"
    _write(tstream, mine, recs, train_dict=16, checksum=True)
    _write(jstream, theirs, recs, train_dict=16, checksum=True)
    assert mine.read_bytes() == theirs.read_bytes()
    with StreamReader(theirs) as r:
        assert list(r) == recs and r.read_many() == recs
        assert r.read_range(3, 5, 20) == recs[3][5:25]
        with pytest.raises(tb.BloscError):
            r.read_range(3, len(recs[3]) - 1, 2)
    plain = tmp_path / "p.tpbs"
    _write(tstream, plain, recs)
    assert mine.stat().st_size < plain.stat().st_size


def test_stream_dict_append_and_mixed_records(tmp_path, zstandard):
    recs = _jsonish_records(12)
    arr = np.arange(30_000, dtype=np.float32)
    path = tmp_path / "m.tpbs"
    with StreamWriter(path, train_dict=8) as w:
        for r in recs[:6]:
            w.write(r)
        w.write_array(torch.from_numpy(arr))
        for r in recs[6:10]:
            w.write(r)
    with StreamWriter(path, append=True) as w:
        for r in recs[10:]:
            w.write(r)
    with StreamReader(path) as r:
        assert len(r) == 13
        assert [r.read(i) for i in range(6)] == recs[:6]
        assert np.array_equal(r.read_array(6, torch.float32, device="cpu").numpy(), arr)
        assert [r.read(i + 1) for i in range(6, 12)] == recs[6:]
        assert r.sizes()[6][1] == arr.nbytes
        assert np.array_equal(r.read_array(0, torch.uint8, device="cpu").numpy(),
                              np.frombuffer(recs[0], np.uint8))


def test_stream_dict_few_samples_and_forged_size(tmp_path, zstandard):
    path = tmp_path / "few.tpbs"
    _write(tstream, path, [b"only" * 100, b"three" * 100, b"records" * 100], train_dict=100)
    with StreamReader(path) as r:
        assert len(r) == 3 and r.read(2) == b"records" * 100
    samples = [bytes([i] * 50) + b"shared-structure" * 20 for i in range(16)]
    path = tmp_path / "forge.tpbs"
    _write(tstream, path, samples, train_dict=8)
    blob = bytearray(path.read_bytes())
    with StreamReader(path) as r:
        off = r._offsets[3]
    assert blob[off + 8 : off + 12] == tstream.DICT_MAGIC
    blob[off + 8 + 5 : off + 8 + 13] = struct.pack("<Q", 1 << 50)
    path.write_bytes(bytes(blob))
    with StreamReader(path) as r:
        with pytest.raises(tb.BloscError):
            r.read(3)
        assert r.read(4) == samples[4]
