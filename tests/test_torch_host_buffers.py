"""Page-locked, reused host buffers for the device round trip's bulk copies.

compress_array's device route copies the filtered stream of a CUDA tensor
into a page-locked host buffer, decompress_array(strategy="device")
decodes the codec stage into one before copying it to a CUDA target, the
host route of single-block tensors copies a CUDA tensor into one and
decodes a frame straight into one for a CUDA target, and load_pytree's
prefetch pipeline reads and decodes each window of leaves into them
before copying the leaves to a CUDA target; these buffers come from
torch's caching host allocator.  Every other caller, every CPU tensor or
target, and a sharded decode keep pageable buffers.  One function
decides: ``device._host_buffer(n, device)``.

The CPU cases check that decision, that the records and mesh decoders ask
for pageable buffers even for a CUDA target, that a CPU tensor's bytes
reach the codec uncopied, and that repeated calls keep writing
tpu_blosc's frames.  The CUDA cases (``cuda`` in their names; they skip
without a card) hold reuse to the CPU route: back-to-back and overlapping
round trips of multi-block and single-block frames, four threads
compressing at once, a checkpoint of same-size leaves, and checkpoint
loads behind a busy stream, one of them of many windows, whose slabs must
not be written again before the copies out of them have run.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import pytest
import torch
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc_torch import checkpoint
from tpu_blosc_torch import device as tdev
from tpu_blosc_torch import stream
from tpu_blosc_torch.dist import mesh

BLOCK = 65536


class _Stop(Exception):
    """Raised by a spy once it has seen what it asks about, before any
    CUDA work that this machine cannot do."""


def _signal(n: int, seed: int, raw_block: int | None = 1) -> np.ndarray:
    """A smooth float32 array of ``n`` elements with one block of random
    bytes (stored raw by the codec) at ``raw_block``."""
    rng = np.random.default_rng(seed)
    a = (1000 * np.sin(np.arange(n) / 300.0) + rng.normal(0, 1e-3, n)).astype(np.float32)
    if raw_block is not None:
        lo = raw_block * BLOCK
        a.view(np.uint8)[lo:lo + BLOCK] = rng.integers(0, 256, BLOCK, dtype=np.uint8)
    return a


def _opts(codec: str, shuffle: str):
    """The same options for both packages."""
    kw = dict(type_size=4, block_size=BLOCK)
    return (jb.Options(codec=jb.Codec[codec], shuffle=jb.Shuffle[shuffle], **kw),
            tb.Options(codec=tb.Codec[codec], shuffle=tb.Shuffle[shuffle], **kw))


def _buffer_spy(monkeypatch, stop: bool) -> list:
    """Record, for every host buffer asked of ``device._host_buffer``,
    whether it decided on page-locked memory: the ``pin_memory`` it gives
    ``torch.empty``, which is patched for the test (the loaders ask from
    worker threads) to allocate pageable memory all the same, as this
    machine can.  With ``stop`` raise _Stop at the first one."""
    seen: list = []
    empty = torch.empty

    def pageable(*args, **kwargs):
        if "pin_memory" in kwargs:
            seen.append(kwargs.pop("pin_memory"))
            if stop:
                raise _Stop
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", pageable)
    return seen


@pytest.mark.parametrize("dev, pinned", [
    (torch.device("cuda", 0), True),
    (torch.device("cuda", 1), True),
    (torch.device("cpu"), False),
    (None, False),
], ids=["cuda0", "cuda1", "cpu", "host"])
def test_copies_pin_on_a_cuda_device_only(monkeypatch, dev, pinned):
    """The one decision: a buffer for a CUDA device is page-locked, one for
    the CPU or for no device (the host keeps it) is pageable."""
    seen = _buffer_spy(monkeypatch, stop=False)
    buf = tdev._host_buffer(1000, dev)
    assert seen == [pinned]
    assert buf.shape == (1000,) and buf.dtype == torch.uint8 and buf.device.type == "cpu"


@pytest.mark.parametrize("route, pinned", [("device", True), ("records", False),
                                           ("mesh", False)])
def test_only_the_device_decode_asks_for_a_pinned_buffer(monkeypatch, route, pinned):
    """For a CUDA target the "device" strategy decodes into page-locked
    memory; the records and mesh decoders, which keep the stream on the
    host, decode into pageable memory."""
    data = _signal(4 * BLOCK // 4, 3, raw_block=None)  # whole blocks: records takes it
    _, to = _opts("LZ4", "SHUFFLE")
    frame = tb.compress_array(torch.from_numpy(data), to)
    seen = _buffer_spy(monkeypatch, stop=True)
    target = torch.device("cuda", 0)
    with pytest.raises(_Stop):
        if route == "mesh":
            mesh.decompress_chunked_mesh(frame, device=target)
        else:
            tb.decompress_array(frame, torch.float32, device=target, strategy=route)
    assert seen == [pinned]


RAMP = np.arange(262144, dtype=np.float32)  # one 1 MiB block: the host route


def _ramp_opts():
    """LZ4 5 over byte-shuffled float32, automatic blocks, for both
    packages."""
    kw = dict(level=5, type_size=4)
    return (jb.Options(codec=jb.Codec.LZ4, shuffle=jb.Shuffle.SHUFFLE, **kw),
            tb.Options(codec=tb.Codec.LZ4, shuffle=tb.Shuffle.SHUFFLE, **kw))


class _OnCard:
    """What ``tensor_bytes`` gives for a tensor on a CUDA device, as far as
    the host route reads it before it asks for a host buffer."""

    device = torch.device("cuda", 0)

    def __init__(self, flat: torch.Tensor):
        self.flat = flat

    def numel(self) -> int:
        return self.flat.numel()


@pytest.mark.parametrize("on_card", [True, False], ids=["cuda", "cpu"])
def test_a_single_block_compress_pins_for_a_cuda_tensor_only(monkeypatch, on_card):
    """The host route copies a CUDA tensor into one page-locked buffer; a
    CPU tensor's bytes go to the codec as they are, with no buffer and no
    copy, into tpu_blosc's frame."""
    jo, to = _ramp_opts()
    x = torch.from_numpy(RAMP.copy())
    if on_card:
        tensor_bytes = tdev.tensor_bytes
        monkeypatch.setattr(tdev, "tensor_bytes", lambda t: _OnCard(tensor_bytes(t)))
    seen = _buffer_spy(monkeypatch, stop=on_card)
    if on_card:
        with pytest.raises(_Stop):
            tb.compress_array(x, to)
        assert seen == [True]
        return
    handed = []
    compress_with_options = tdev.compress_with_options
    monkeypatch.setattr(tdev, "compress_with_options",
                        lambda host, opts: handed.append(host) or compress_with_options(host, opts))
    assert tb.compress_array(x, to) == jb.compress_with_options(RAMP.tobytes(), jo)
    assert seen == [] and len(handed) == 1 and np.shares_memory(handed[0], x.numpy())


@pytest.mark.parametrize("strategy", ["device", "transfer", "auto", "records"])
@pytest.mark.parametrize("target", ["cuda", "cpu", "sharded"])
def test_a_single_block_decode_pins_for_a_cuda_target_only(monkeypatch, strategy, target):
    """Every strategy decodes a single-block frame on the host, into one
    buffer: page-locked for a CUDA target, pageable for the CPU and for a
    sharded decode (onto a CUDA mesh here), whose result is placed
    later."""
    from tpu_blosc_torch.dist import _sharded

    _, to = _ramp_opts()
    frame = tb.compress_array(torch.from_numpy(RAMP), to)
    assert not tb.format.parse_header(frame).is_split
    kw = {"device": "cpu"} if target == "cpu" else {"device": torch.device("cuda", 0)}
    if target == "sharded":
        monkeypatch.setattr(_sharded, "sharding_device", lambda sharding, device: device)
        kw["sharding"] = "a CUDA mesh"
    seen = _buffer_spy(monkeypatch, stop=target != "cpu")
    if target == "cpu":
        y = tb.decompress_array(frame, torch.float32, strategy=strategy, **kw)
        assert y.numpy().tobytes() == RAMP.tobytes() and seen == [False]
        return
    with pytest.raises(_Stop):
        tb.decompress_array(frame, torch.float32, strategy=strategy, **kw)
    assert seen == [target == "cuda"]


def _tree() -> dict:
    """Leaves of three sizes, two of them of one size, one a multi-block
    frame."""
    return {"a": torch.from_numpy(_signal(CUDA_N, 50)), "b": torch.arange(1000),
            "c": [torch.from_numpy(_signal(5000, 51, raw_block=None)),
                  torch.from_numpy(_signal(5000, 52, raw_block=None))], "step": 7}


@pytest.mark.parametrize("target, pinned", [(torch.device("cuda", 0), True),
                                            (torch.device("cpu"), False),
                                            (False, False)],
                         ids=["cuda", "cpu", "host"])
def test_a_checkpoint_load_pins_its_leaves_for_a_cuda_target(monkeypatch, tmp_path, target,
                                                             pinned):
    """load_pytree's pipeline reads a window of leaves into one buffer and
    decodes them into another, both page-locked for a CUDA target, both
    pageable for the CPU and for a load onto the host (here the four
    leaves make one window)."""
    path = tmp_path / "t.tpbs"
    checkpoint.save_pytree(path, _tree())
    seen = _buffer_spy(monkeypatch, stop=pinned)
    if pinned:
        with pytest.raises(_Stop):
            checkpoint.load_pytree(path, device=target)
        assert seen == [True]
    else:
        back = checkpoint.load_pytree(path, device=target)
        assert _same(back["a"], _tree()["a"]) and seen == [False] * 2


@pytest.mark.parametrize("codec", ["LZ4", "ZSTD"])
@pytest.mark.parametrize("shuffle", ["SHUFFLE", "BITSHUFFLE"])
def test_repeated_cpu_round_trips_keep_tpu_blosc_frames(monkeypatch, codec, shuffle):
    """A raw block and a ragged tail, three calls in a row: every frame is
    tpu_blosc's, every decode gives the data back, and no buffer of a CPU
    tensor or target is pinned."""
    data = _signal(4 * BLOCK // 4 + 4465, 7)  # 4 blocks, then a 17,860-byte tail
    jo, to = _opts(codec, shuffle)
    want = jb.compress_with_options(data.tobytes(), jo)
    seen = _buffer_spy(monkeypatch, stop=False)
    x = torch.from_numpy(data)
    for _ in range(3):
        frame = tb.compress_array(x, to)
        assert frame == want
        y = tb.decompress_array(frame, torch.float32, device="cpu", strategy="device")
        assert y.numpy().tobytes() == data.tobytes()
    entries, _ = tb.chunk.parse_block_table(want, tb.format.parse_header(want))
    assert [m for _, m in entries] == [False, True, False, False, False]
    assert seen == [False, False, False]


# ---------------------------------------------------------------- on the card

CUDA_N = 64 * BLOCK // 4 + 4465  # 64 blocks of 64 KiB and a tail


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: page-locked buffers need one")
    return torch.device("cuda", 0)


def _same(y: torch.Tensor, x: torch.Tensor) -> bool:
    """Byte for byte: the raw blocks' random bytes hold NaNs."""
    return y.shape == x.shape and torch.equal(y.view(torch.uint8), x.view(torch.uint8))


def _cuda_opts(codec: str = "ZSTD") -> tb.Options:
    return tb.Options(codec=tb.Codec[codec], level=5, shuffle=tb.Shuffle.SHUFFLE,
                      type_size=4, block_size=BLOCK)


def test_cuda_stage_buffers_are_pinned(monkeypatch, card):
    x = torch.from_numpy(_signal(CUDA_N, 11)).to(card)
    staged = tdev._compress_array_stage1(x, _cuda_opts(), "transfer")
    assert torch.from_numpy(staged[0]).is_pinned()
    frame = tdev._compress_array_stage2(staged)
    made = []
    real = tdev._host_buffer
    monkeypatch.setattr(tdev, "_host_buffer",
                        lambda n, device: made.append(real(n, device)) or made[-1])
    y = tb.decompress_array(frame, torch.float32, device=card, strategy="device")
    assert [b.is_pinned() for b in made] == [True]
    assert _same(y, x)


def _made_buffers(monkeypatch) -> list:
    """Every buffer ``device._host_buffer`` hands out."""
    made = []
    real = tdev._host_buffer
    monkeypatch.setattr(tdev, "_host_buffer",
                        lambda n, device: made.append(real(n, device)) or made[-1])
    return made


def test_cuda_single_block_round_trips_back_to_back(monkeypatch, card):
    """200 round trips of the 1 MiB ramp on the host route: each frame is
    the CPU route's (tpu_blosc's, by the CPU test above), each decode the
    ramp, through two page-locked buffers a round trip."""
    _, opts = _ramp_opts()
    want = tb.compress_array(torch.from_numpy(RAMP), opts)
    x = torch.from_numpy(RAMP).to(card)
    made = _made_buffers(monkeypatch)
    for _ in range(200):
        frame = tb.compress_array(x, opts)
        assert frame == want
        y = tb.decompress_array(frame, torch.float32, device=card, strategy="device")
        assert _same(y, x)
    assert len(made) == 400 and all(b.is_pinned() for b in made)


@pytest.mark.parametrize("strategy", ["device", "transfer"])
def test_cuda_single_block_decodes_without_a_synchronise(card, strategy):
    """Two decodes of one size issued back to back while the stream is held,
    so that the first copy has not run when the second decode asks for a
    buffer: the first tensor is its own frame's, not the second's."""
    _, opts = _ramp_opts()
    a, b = RAMP, (RAMP[::-1] * 3).copy()
    fa = tb.compress_array(torch.from_numpy(a), opts)
    fb = tb.compress_array(torch.from_numpy(b), opts)
    for _ in range(3):
        torch.cuda._sleep(20_000_000)  # hold the stream: the copies wait
        ya = tb.decompress_array(fa, torch.float32, device=card, strategy=strategy)
        yb = tb.decompress_array(fb, torch.float32, device=card, strategy=strategy)
        torch.cuda.synchronize(card)
        assert _same(ya.cpu(), torch.from_numpy(a)) and _same(yb.cpu(), torch.from_numpy(b))


@pytest.mark.parametrize("codec", ["LZ4", "ZSTD"])
def test_cuda_back_to_back_round_trips_of_one_size(card, codec):
    """Two tensors of one size, in turns: each frame is the CPU route's, and
    each decode gives its tensor back, also when B's decode starts while
    A's copy waits behind a busy stream."""
    a, b = _signal(CUDA_N, 21), _signal(CUDA_N, 22, raw_block=5)
    opts = _cuda_opts(codec)
    want = {k: tb.compress_array(torch.from_numpy(v), opts) for k, v in (("a", a), ("b", b))}
    xa, xb = torch.from_numpy(a).to(card), torch.from_numpy(b).to(card)
    for _ in range(3):
        fa = tb.compress_array(xa, opts)
        fb = tb.compress_array(xb, opts)
        assert fa == want["a"] and fb == want["b"]
        ys = []
        for frame in (fb, fa, fb, fa):
            torch.cuda._sleep(20_000_000)  # hold the stream: the copy waits
            ys.append(tb.decompress_array(frame, torch.float32, device=card,
                                          strategy="device"))
        torch.cuda.synchronize(card)
        for y, x in zip(ys, (xb, xa, xb, xa)):
            assert _same(y, x)


def test_cuda_four_threads_compress_at_once(card):
    arrays = [_signal(CUDA_N, 30 + i, raw_block=i % 4) for i in range(8)]
    opts = _cuda_opts("LZ4")
    want = [tb.compress_array(torch.from_numpy(a), opts) for a in arrays]
    xs = [torch.from_numpy(a).to(card) for a in arrays]
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        for _ in range(2):
            got = list(pool.map(lambda x: tb.compress_array(x, opts), xs))
            assert got == want


def test_cuda_checkpoint_of_same_size_leaves_is_the_cpu_file(card, tmp_path):
    leaves = {f"w{i}": torch.from_numpy(_signal(CUDA_N, 40 + i, raw_block=i)) for i in range(4)}
    opts = _cuda_opts("LZ4")
    checkpoint.save_pytree(tmp_path / "cpu.tpbs", leaves, opts)
    checkpoint.save_pytree(tmp_path / "cuda.tpbs", {k: v.to(card) for k, v in leaves.items()},
                           opts)
    with open(tmp_path / "cpu.tpbs", "rb") as f1, open(tmp_path / "cuda.tpbs", "rb") as f2:
        assert f1.read() == f2.read()
    back = checkpoint.load_pytree(os.fspath(tmp_path / "cuda.tpbs"), device=card,
                                  strategy="device")
    for k, v in leaves.items():
        assert _same(back[k].cpu(), v)


def test_cuda_checkpoint_loads_back_to_back_behind_a_busy_stream(monkeypatch, card,
                                                                  tmp_path):
    """Three loads onto the card, each started while the stream is held, so
    their copies queue behind it: every leaf comes back as saved, from
    page-locked buffers that the next load may be handed only once the
    copies out of them have run."""
    path = tmp_path / "t.tpbs"
    tree = _tree()
    checkpoint.save_pytree(path, tree)
    made = []
    real = tdev._host_buffer
    monkeypatch.setattr(tdev, "_host_buffer",
                        lambda n, device: made.append(real(n, device)) or made[-1])
    loads = []
    for _ in range(3):
        torch.cuda._sleep(20_000_000)  # hold the stream: the copies wait
        loads.append(checkpoint.load_pytree(path, device=True))
    torch.cuda.synchronize(card)
    assert made and all(b.is_pinned() for b in made)
    for back in loads:
        assert back["step"] == 7 and back["a"].device == card
        assert _same(back["a"].cpu(), tree["a"]) and torch.equal(back["b"].cpu(), tree["b"])
        assert all(_same(y.cpu(), x) for y, x in zip(back["c"], tree["c"]))


def test_cuda_a_load_of_many_windows_behind_a_held_stream_rewrites_no_slab(
        monkeypatch, card, tmp_path):
    """Windows of 512 KiB: 48 multi-block leaves, of whole blocks and of a
    short last block, take 12 windows a load.  Three loads, each
    started while the stream is held, so that the copies out of every slab
    wait behind it while the worker goes on reading and decoding the next
    windows: every leaf comes back as saved, so no slab (nor a read buffer,
    which only the worker reads) was written again before its copies ran.
    A load onto the CPU, or onto the host, asks for pageable buffers only."""
    monkeypatch.setattr(stream, "_BATCH_WINDOW_BYTES", 512 << 10)
    tree = {f"w{i}": torch.from_numpy(_signal(2 * BLOCK // 4 if i % 3 else 20_000, 60 + i,
                                              raw_block=None))
            for i in range(48)}
    path = tmp_path / "windows.tpbs"
    checkpoint.save_pytree(path, tree, _cuda_opts("LZ4"))
    made = []
    real = tdev._host_buffer
    monkeypatch.setattr(tdev, "_host_buffer",
                        lambda n, device: made.append(real(n, device)) or made[-1])
    loads = []
    checkpoint.reset_restored()
    for _ in range(3):
        torch.cuda._sleep(1_000_000_000)  # hold the stream: the copies wait
        loads.append(checkpoint.load_pytree(path, device=True))
    torch.cuda.synchronize(card)
    assert checkpoint.restored["windows"] == 3 * 12
    assert checkpoint.restored["multi_block_leaves"] == 3 * 48
    assert made and all(b.is_pinned() for b in made)
    for back in loads:
        assert all(back[k].device == card and _same(back[k].cpu(), v) for k, v in tree.items())
    for device in ("cpu", False):
        made.clear()
        back = checkpoint.load_pytree(path, device=device)
        assert made and not any(b.is_pinned() for b in made)
        assert all(_same(back[k], v) for k, v in tree.items())
