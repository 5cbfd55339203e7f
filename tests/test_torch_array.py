"""The port's pack_array envelopes against the JAX package's, on the CPU.

After tests/test_array.py, for the element types torch has (datetimes and
strings have no torch meaning).  The same array gives the same envelope
from both packages, whether the port is handed a NumPy array or a CPU
tensor; each package unpacks the other's, bfloat16 included.
"""

from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc.options import Options as JOptions


_UINT = {1: (np.uint8, torch.uint8), 2: (np.uint16, torch.int16)}


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor of the array's element type and bytes (ml_dtypes'
    types, which torch.from_numpy refuses, through an integer view)."""
    a = np.array(a, order="C")  # keeps 0-d arrays 0-d
    if a.dtype.kind == "V":
        np_int, torch_int = _UINT[a.dtype.itemsize]
        return torch.from_numpy(a.view(np_int)).view(torch_int).view(tb.dtypes.from_numpy(a.dtype))
    return torch.from_numpy(a)


def _same(t: torch.Tensor, a: np.ndarray) -> bool:
    """A tensor equals an array: element type, shape and bytes."""
    a = np.asarray(a)
    return (t.dtype == tb.dtypes.from_numpy(a.dtype) and tuple(t.shape) == a.shape
            and tb.device.tensor_bytes(t).numpy().tobytes() == a.tobytes())


def _array(dtype) -> np.ndarray:
    rng = np.random.default_rng(0)
    dt = np.dtype(dtype)
    if dt == np.bool_:
        return rng.integers(0, 2, 1000).astype(dt)
    if dt.kind == "c":
        return (rng.random(1000) + 1j * rng.random(1000)).astype(dt)
    return (rng.random(1000) * 100).astype(dt)


DTYPES = [np.uint8, np.int8, np.int16, np.int32, np.int64, np.uint16, np.float16,
          np.float32, np.float64, np.complex64, np.complex128, np.bool_,
          ml_dtypes.bfloat16, ml_dtypes.float8_e4m3fn]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_same_envelope_and_cross_unpack(dtype):
    arr = _array(dtype)
    theirs = jb.pack_array(arr)
    assert tb.pack_array(arr) == theirs
    assert tb.pack_array(_tensor(arr)) == theirs
    assert _same(tb.unpack_array(theirs), arr)
    back = jb.unpack_array(tb.pack_array(_tensor(arr)))
    assert back.dtype == arr.dtype and back.tobytes() == arr.tobytes()


@pytest.mark.parametrize("shape", [(), (0,), (1,), (7, 11), (2, 3, 4, 5), (1000,), (0, 5)])
def test_roundtrip_shapes(shape):
    arr = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    packed = tb.pack_array(_tensor(arr))
    assert packed == jb.pack_array(arr)
    out = tb.unpack_array(packed)
    assert tuple(out.shape) == shape and np.array_equal(out.numpy(), arr)


def test_fortran_order_preserved():
    arr = np.asfortranarray(np.arange(35, dtype=np.int32).reshape(5, 7))
    packed = tb.pack_array(arr)
    assert packed == jb.pack_array(arr)
    out = tb.unpack_array(packed)
    assert out.stride() == (1, 5) and np.array_equal(out.numpy(), arr)
    # a tensor packs in its logical C order, as a jax.Array does
    assert tb.pack_array(torch.from_numpy(arr)) == jb.pack_array(np.ascontiguousarray(arr))


def test_custom_options_and_big_itemsize():
    arr = np.arange(4096, dtype=np.float64)
    kw = dict(level=3, type_size=8)
    packed = tb.pack_array(_tensor(arr), tb.Options(codec=tb.Codec.ZSTD,
                                                    shuffle=tb.Shuffle.BITSHUFFLE, **kw))
    assert packed == jb.pack_array(arr, JOptions(codec=jb.ZSTD, shuffle=jb.BITSHUFFLE, **kw))
    assert np.array_equal(tb.unpack_array(packed).numpy(), arr)


def test_list_input_accepted():
    out = tb.unpack_array(tb.pack_array([[1, 2], [3, 4]]))
    assert np.array_equal(out.numpy(), np.array([[1, 2], [3, 4]]))


@pytest.mark.parametrize(
    "bad", [np.array([object()], dtype=object), np.zeros(3, dtype=[("a", "<i4"), ("b", "<f8")]),
            np.arange(4).astype("<M8[ns]"), np.array(["ab", "c"]), np.arange(4, dtype=">f4")],
    ids=["object", "structured", "datetime", "string", "big-endian"],
)
def test_element_types_without_a_torch_type_rejected(bad):
    with pytest.raises(TypeError):
        tb.pack_array(bad)


def test_unpack_rejects_garbage():
    for blob in (b"", b"not an envelope at all", b"TPBA\xff\x00\x00\x00"):
        with pytest.raises(tb.InvalidHeaderError):
            tb.unpack_array(blob)
    # an envelope of an element type torch lacks
    with pytest.raises(tb.InvalidDataError):
        tb.unpack_array(jb.pack_array(np.arange(4).astype("<M8[ns]")))


def test_unpack_rejects_truncation_and_mismatch():
    packed = tb.pack_array(np.arange(100, dtype=np.int32))
    with pytest.raises((tb.InvalidDataError, tb.InvalidHeaderError)):
        tb.unpack_array(packed[: len(packed) // 2])
    mut = bytearray(packed)
    mut[11] ^= 0x01  # the first shape byte
    with pytest.raises(tb.InvalidDataError):
        tb.unpack_array(bytes(mut))


def test_envelope_mutations_raise_typed_errors_or_decode():
    base = tb.pack_array(np.arange(200, dtype=np.int16))
    rng = np.random.default_rng(4)
    for pos in range(len(base)):
        mut = bytearray(base)
        mut[pos] = int(rng.integers(0, 256))
        try:
            out = tb.unpack_array(bytes(mut))
        except (tb.BloscError, TypeError):
            continue
        assert isinstance(out, torch.Tensor)


def test_envelope_is_not_a_plain_frame():
    with pytest.raises(tb.BloscError):
        tb.decompress(tb.pack_array(np.arange(64, dtype=np.float32)))


def test_unpack_array_onto_a_device():
    """``device`` decodes through decompress_array (a torch.device or
    string here; True is the current CUDA device)."""
    x = (np.arange(4096) % 31).astype(np.int32).reshape(64, 64)
    out = tb.unpack_array(jb.pack_array(x), device="cpu")
    assert out.shape == (64, 64) and out.dtype == torch.int32
    assert np.array_equal(out.numpy(), x)
    b = (np.arange(300) % 7).astype(ml_dtypes.bfloat16)
    assert _same(tb.unpack_array(jb.pack_array(b), device=torch.device("cpu")), b)
    e = tb.unpack_array(jb.pack_array(np.zeros((0, 3), np.float32)), device="cpu")
    assert e.shape == (0, 3)
    f = np.asfortranarray(np.arange(12, dtype=np.int32).reshape(3, 4))
    assert np.array_equal(tb.unpack_array(jb.pack_array(f), device="cpu").numpy(), f)


def test_unpack_array_device_true_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=True is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.unpack_array(tb.pack_array(np.arange(10, dtype=np.float32)), device=True)


def test_pack_array_routes_cuda_tensors_through_compress_array(monkeypatch):
    """Only a CUDA tensor goes to compress_array (seen here through a
    stand-in device type on a CPU tensor)."""
    from tpu_blosc_torch import array as tarray

    x = torch.arange(5000, dtype=torch.float32).reshape(50, 100)
    seen = []

    def fake(t, opts):
        seen.append(opts.type_size)
        return tb.compress_array(x, opts)

    class FakeDevice:
        type = "cuda"

    class CudaLike(torch.Tensor):
        @property
        def device(self):
            return FakeDevice()

    monkeypatch.setattr(tarray, "compress_array", fake)
    assert tb.pack_array(x.as_subclass(CudaLike)) == jb.pack_array(x.numpy())
    assert seen == [4]


def test_unpack_array_rows():
    arr = np.arange(600_000, dtype=np.float32).reshape(6000, 100)
    packed = tb.pack_array(_tensor(arr), tb.Options(block_size=16384, type_size=4))
    assert packed == jb.pack_array(arr, JOptions(block_size=16384, type_size=4))
    assert np.array_equal(tb.unpack_array_rows(packed, 1234, 2345).numpy(), arr[1234:2345])
    assert tb.unpack_array_rows(packed, 5, 5).shape == (0, 100)
    assert np.array_equal(tb.unpack_array_rows(packed, 0, 6000).numpy(), arr)
    for start, stop in ((0, 6001), (-1, 5)):
        with pytest.raises(tb.BloscError):
            tb.unpack_array_rows(packed, start, stop)


def test_unpack_array_rows_fortran_and_1d():
    f = np.asfortranarray(np.arange(20_000, dtype=np.int32).reshape(200, 100))
    assert np.array_equal(tb.unpack_array_rows(jb.pack_array(f), 10, 20).numpy(), f[10:20])
    one = np.arange(50_000, dtype=np.int16)
    assert np.array_equal(tb.unpack_array_rows(jb.pack_array(one), 100, 200).numpy(),
                          one[100:200])
    with pytest.raises(tb.BloscError):
        tb.unpack_array_rows(tb.pack_array(np.array(3.0)), 0, 1)
