"""The plain reference reads the port's frames back byte for byte, and
refuses or misreads a frame that is not what the options state.

The frames come from ``tpu_blosc_torch.compress_array`` of CPU tensors,
the same bytes as from a CUDA tensor (the port's byte contract), so the
reference is held here to every layout the cells' frames can take."""

import numpy as np
import pytest
import torch

import tpu_blosc_torch as tbt
from benchmark import harness

MIB = 1 << 20


def _ref(name):
    return harness.Cell("c", harness.ROOT, 1, {}, {}, [], []).module("reference", name)


FRAME = _ref("blosc_frame")
CODECS = {"LZ4": ("lz4", 1), "LZ4HC": ("lz4", 2), "ZSTD": ("zstd", 5)}


def _data(nbytes: int, dtype: torch.dtype, raw_block: bool) -> torch.Tensor:
    g = torch.Generator().manual_seed(nbytes)
    n = nbytes // dtype.itemsize
    x = (torch.arange(n, dtype=torch.float64) * 0.25 + torch.randn(n, generator=g)).to(dtype)
    if raw_block:
        x.view(torch.uint8)[MIB : 2 * MIB] = torch.randint(0, 256, (MIB,), dtype=torch.uint8,
                                                           generator=g)
    return x


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("shuffle", ["SHUFFLE", "BITSHUFFLE"])
@pytest.mark.parametrize("nbytes, dtype, raw_block", [
    (MIB, torch.float32, False),              # one block: the host route
    (8 * MIB, torch.float32, True),           # full blocks, one stored raw
    (5 * MIB + 8 * 4608, torch.float64, True),  # full blocks and a ragged tail
    (6 * MIB + 10, torch.int16, False),       # a tail past the last group of 8
])
def test_reference_reads_the_port_frames(codec, shuffle, nbytes, dtype, raw_block):
    x = _data(nbytes, dtype, raw_block)
    opts = tbt.Options(codec=tbt.Codec[codec], level=5, shuffle=tbt.Shuffle[shuffle],
                       type_size=dtype.itemsize)
    frame = tbt.compress_array(x, opts)
    mod, codec_id = CODECS[codec]
    got = FRAME.decode(frame, codec_id, shuffle, dtype.itemsize, _ref(mod).decompress)
    assert np.array_equal(got, x.view(torch.uint8).numpy())


@pytest.mark.parametrize("cell", ["ramp-f32-lz4.1mib", "signal-f64-zstd.64mb"])
def test_each_config_makes_its_own_reference(cell):
    """``make(config)`` of the module a configuration names reads the
    configuration's frames; the harness knows nothing of their format."""
    c = harness.load_cell(cell)
    o = c.config["options"]
    dtype = getattr(torch, c.config["dtype"])
    x = _data(3 * MIB + 8 * 4608, dtype, True)
    frame = tbt.compress_array(x, tbt.Options(codec=tbt.Codec[o["codec"]], level=o["level"],
                                              shuffle=tbt.Shuffle[o["shuffle"]],
                                              type_size=o["type_size"]))
    assert np.array_equal(c.reference()(frame), x.view(torch.uint8).numpy())
    with pytest.raises(ValueError):
        c.reference()(frame[:-1])


def _ramp_frame(nbytes=8 * MIB):
    x = torch.arange(nbytes // 4, dtype=torch.float32)
    return x, tbt.compress_array(x, tbt.Options(codec=tbt.Codec.LZ4, level=5))


def _read(frame, codec_id=1, shuffle="SHUFFLE", ts=4):
    return FRAME.decode(frame, codec_id, shuffle, ts, _ref("lz4").decompress)


def test_a_byte_changed_in_a_payload_is_seen():
    x, frame = _ramp_frame()
    want = x.view(torch.uint8).numpy()
    for at in (len(frame) // 2, len(frame) - 3, 16 + 4 + 4 * 8 + 7):
        bad = bytearray(frame)
        bad[at] ^= 1
        try:
            got = _read(bytes(bad))
        except FRAME.FrameError:
            continue
        assert not np.array_equal(got, want)


@pytest.mark.parametrize("field", ["codec", "shuffle", "type size", "length", "table"])
def test_a_frame_that_states_other_options_is_refused(field):
    _, frame = _ramp_frame()
    with pytest.raises(FRAME.FrameError):
        if field == "codec":
            _read(frame, codec_id=5)
        elif field == "shuffle":
            _read(frame, shuffle="BITSHUFFLE")
        elif field == "type size":
            _read(frame, ts=8)
        elif field == "length":
            _read(frame + b"\0")
        else:
            bad = bytearray(frame)
            bad[16] += 1  # one block more than the sizes hold
            _read(bytes(bad))


def test_lz4_refuses_a_truncated_block():
    lz4 = _ref("lz4")
    _, frame = _ramp_frame(MIB)
    with pytest.raises(ValueError):
        lz4.decompress(frame[16:-5], MIB)
    with pytest.raises(ValueError):
        lz4.decompress(frame[16:], MIB + 1)
