"""The port's sharded block pipeline against the JAX package's, on the CPU.

After tests/test_dist.py.  The same NumPy bytes, made from a seed, go
through ``tpu_blosc.dist.mesh`` (on the virtual CPU devices conftest.py
forces) and ``tpu_blosc_torch.dist.mesh`` (``device="cpu"``: the block
kernels' plain versions).  Frames, decoded bytes and MeshStats must be
equal: the tolerance is 0 throughout.

Three ways to a world size: one rank with no process group; the rank step
as a plain function, called on each rank's rows in this process for W up
to 8; and real groups of 2, 3 and 4 processes over Gloo
(tests/torch_dist_worker.py, spawned once per world size; the
parametrised tests read what the ranks wrote).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker as worker
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)
import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc.dist import mesh as jm
from tpu_blosc.filters import reference as ref
from tpu_blosc_torch.chunk import choose_block_size
from tpu_blosc_torch.dist import mesh as tm
from tpu_blosc_torch.dist.multihost import process_slice

pytestmark = pytest.mark.skipif(
    not (dist.is_available() and dist.is_gloo_available()),
    reason="torch.distributed with the Gloo backend is not available",
)

WORLDS = (2, 3, 4)
CASES = worker.cases()


def jax_opts(opts: tb.Options) -> jb.Options:
    return jb.Options(codec=jb.Codec(int(opts.codec)), level=opts.level,
                      shuffle=jb.Shuffle(int(opts.shuffle)), type_size=opts.type_size,
                      block_size=opts.block_size)


def _bytes(n: int, seed: int = 0) -> bytes:
    """Compressible words with a sprinkle of random bytes."""
    rng = np.random.default_rng(seed)
    a = (np.arange(-(-n // 4), dtype=np.uint32) * 3 % 4099).view(np.uint8)[:n].copy()
    hits = rng.integers(0, n, n // 50)
    a[hits] = rng.integers(0, 256, hits.size, dtype=np.uint8)
    return a.tobytes()


def same_stats(a, b) -> bool:
    return (np.array_equal(a.histogram, b.histogram) and a.histogram.dtype == b.histogram.dtype
            and np.array_equal(a.block_diffs, b.block_diffs)
            and int(a.sample_bytes) == int(b.sample_bytes))


# ---------------------------------------------------------------------------
# one rank, no process group
# ---------------------------------------------------------------------------

TAILS = {"no_tail": 0, "ragged_tail": 777, "tail_under_one_element": 1}


@pytest.mark.parametrize("tail", list(TAILS))
@pytest.mark.parametrize("ts", [2, 4, 8])
@pytest.mark.parametrize("shuffle", list(tb.Shuffle), ids=lambda s: s.name)
@pytest.mark.parametrize("codec", list(tb.Codec), ids=lambda c: c.name)
def test_mesh_frame_equals_the_host_frame_and_the_jax_package(codec, shuffle, ts, tail):
    data = _bytes(3 * 8192 + TAILS[tail], seed=ts)
    opts = tb.Options(codec=codec, shuffle=shuffle, type_size=ts, block_size=8192)
    frame, stats = tm.compress_chunked_mesh(data, opts, device="cpu", return_stats=True)
    assert frame == tb.compress_with_options(data, opts)
    assert frame == jb.compress_with_options(data, jax_opts(opts))
    jframe, jstats = jm.compress_chunked_mesh(data, jax_opts(opts), jm.block_mesh(1),
                                              return_stats=True)
    if jframe == jb.compress_with_options(data, jax_opts(opts)):
        assert frame == jframe
    else:
        # the JAX package's mesh path compresses with its registry codec,
        # whose ZSTD stream under a filter is not its own host frame's; the
        # port holds to the host frame, and decodes the other
        assert codec == tb.Codec.ZSTD and shuffle != tb.Shuffle.NOSHUFFLE
        assert tm.decompress_chunked_mesh(jframe, device="cpu") == data
    assert same_stats(stats, jstats)
    assert int(stats.histogram.sum()) == stats.sample_bytes == 3 * 8192
    assert tm.decompress_chunked_mesh(frame, device="cpu") == data


@pytest.mark.parametrize("ts", [2, 4, 8])
@pytest.mark.parametrize("shuffle", [tb.Shuffle.SHUFFLE, tb.Shuffle.BITSHUFFLE],
                         ids=lambda s: s.name)
def test_each_package_decodes_the_others_mesh_frame(shuffle, ts):
    data = _bytes(5 * 4096 + 123, seed=10 + ts)
    # one block of random bytes: stored raw, and must stay untouched
    data = data[:4096] + np.random.default_rng(ts).integers(
        0, 256, 4096, dtype=np.uint8).tobytes() + data[8192:]
    opts = tb.Options(shuffle=shuffle, type_size=ts, block_size=4096)
    jframe = jm.compress_chunked_mesh(data, jax_opts(opts), jm.block_mesh(4))
    tframe = tm.compress_chunked_mesh(data, opts, device="cpu")
    assert jframe == tframe
    assert any(m for _, m in tb.chunk.parse_block_table(tframe, tb.parse_header(tframe))[0])
    assert tm.decompress_chunked_mesh(jframe, device="cpu") == data
    assert jm.decompress_chunked_mesh(tframe, jm.block_mesh(2)) == data
    # the type size the caller gives overrides the header's, as on the host
    assert (tm.decompress_chunked_mesh(tframe, device="cpu", type_size=2 * ts)
            == tb.decompress_with_size(tframe, 2 * ts))


def test_mesh_decompress_of_a_single_block_frame_delegates():
    data = b"plain single block frame" * 10
    comp = tb.compress(data, tb.LZ4, 5, tb.NOSHUFFLE, 1)
    assert tm.decompress_chunked_mesh(comp, device="cpu") == data
    shuffled = tb.compress(data, tb.LZ4, 5, tb.SHUFFLE, 4)
    assert tm.decompress_chunked_mesh(shuffled, device="cpu") == data


def test_mesh_decompress_of_blocks_the_kernels_do_not_take_goes_to_the_host():
    data = _bytes(4 * 4096 + 5)
    frame = tb.compress_with_options(data, tb.Options(type_size=4, block_size=4096))
    # type size 3 does not divide the block: the host decode's answer
    assert (tm.decompress_chunked_mesh(frame, device="cpu", type_size=3)
            == tb.decompress_with_size(frame, 3))


def test_mesh_decompress_of_a_damaged_frame_raises_as_the_host_does():
    frame = bytearray(tm.compress_chunked_mesh(_bytes(4 * 4096), tb.Options(block_size=4096),
                                               device="cpu"))
    with pytest.raises(tb.BloscError):
        tm.decompress_chunked_mesh(bytes(frame[:-7]), device="cpu")


def test_mesh_compress_refuses_empty_input_and_unknown_codecs():
    with pytest.raises(tb.InvalidDataError):
        tm.compress_chunked_mesh(b"", tb.Options(), device="cpu")
    with pytest.raises(tb.InvalidCodecError):
        tm.compress_chunked_mesh(b"abcd" * 100, tb.Options(codec=17), device="cpu")


def test_mesh_entry_points_need_a_device_or_the_cpu_by_name():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.compress_chunked_mesh(b"abcd" * 100, tb.Options())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.filter_blocks_sharded(np.zeros((2, 64), np.uint8), 4, tb.Shuffle.SHUFFLE)


def test_mesh_compress_takes_an_array():
    a = np.arange(30_000, dtype=np.float32)
    opts = tb.Options(block_size=32768)
    assert tm.compress_chunked_mesh(a, opts, device="cpu") == tb.compress_with_options(
        a.tobytes(), opts)


def test_no_group_means_one_rank():
    from tpu_blosc_torch import dist as tdist

    assert (tdist.rank(), tdist.world_size()) == (0, 1)
    assert tm.initialize_distributed is tdist.initialize_distributed


@pytest.mark.parametrize("ts", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("mode", [tb.Shuffle.SHUFFLE, tb.Shuffle.BITSHUFFLE],
                         ids=lambda s: s.name)
def test_filter_blocks_sharded_equals_the_oracle_and_the_jax_package(mode, ts):
    arr = np.random.default_rng(ts).integers(0, 256, (6, 64 * ts), dtype=np.uint8)
    got = tm.filter_blocks_sharded(arr, ts, mode, device="cpu")
    oracle = ref.shuffle_bytes if mode == tb.Shuffle.SHUFFLE else ref.bit_shuffle
    for i in range(arr.shape[0]):
        assert np.array_equal(got[i], oracle(arr[i].tobytes(), ts)), i
    if ts != 3:  # the JAX package's sharded bit shuffle takes no odd type size
        assert np.array_equal(
            got, jm.filter_blocks_sharded(arr, ts, jb.Shuffle(int(mode)), jm.block_mesh(4)))
    assert np.array_equal(tm.unfilter_blocks_sharded(got, ts, mode, device="cpu"), arr)


def test_filter_blocks_sharded_passes_unfiltered_modes_through():
    arr = np.arange(512, dtype=np.uint8).reshape(2, 256)
    assert tm.filter_blocks_sharded(arr, 4, tb.Shuffle.NOSHUFFLE, device="cpu") is arr
    assert tm.unfilter_blocks_sharded(arr, 1, tb.Shuffle.SHUFFLE, device="cpu") is arr


# ---------------------------------------------------------------------------
# the rank step as a plain function, for W ranks in one process
# ---------------------------------------------------------------------------


def simulated_stats(data: bytes, opts: tb.Options, world: int):
    """MeshStats as ``world`` ranks would make them: rank_step on each
    rank's rows, the histograms summed (all_reduce), the diffs
    concatenated in rank order (all_gather)."""
    opts = opts.clamped()
    bs = choose_block_size(len(data), opts.type_size, opts.block_size)
    nb_full = len(data) // bs
    blocks = np.frombuffer(data, np.uint8)[: nb_full * bs].reshape(nb_full, bs)
    per = tm._pad_batch(nb_full, world)
    hist = np.zeros(256, np.int64)
    diffs = []
    for r in range(world):
        x = torch.from_numpy(np.array(tm._rank_rows(blocks, r, per)))
        _, h, d = tm.rank_step(x, opts.type_size, opts.shuffle)
        assert h.dtype == torch.int32 and d.dtype == torch.int32 and d.shape == (per,)
        hist += h.numpy()
        diffs.append(d.numpy())
    return tm.mesh_stats(hist, np.concatenate(diffs), world, per, bs, nb_full)


STEP_DATA = {
    # 96 KiB in 16 KiB blocks (tests/test_dist.py:172-193): the sample is the stream
    "96KiB": (np.arange(24_576, dtype=np.float32).tobytes(), dict(block_size=16384)),
    # 6 MiB in 1 MiB blocks (:196-213): sampling engages, the last shard is padded
    "6MiB": ((np.arange((6 << 20) // 4, dtype=np.uint32) % 65536).tobytes(),
             dict(block_size=1 << 20)),
    # blocks that are no multiple of 512 bytes: the whole shard is counted
    "odd_geometry": (_bytes(7 * 4112 + 9, seed=3), dict(block_size=4112, type_size=2)),
    "6MiB_bit": ((np.arange((6 << 20) // 4, dtype=np.uint32) % 65536).tobytes(),
                 dict(block_size=1 << 20, shuffle=2)),
    "unfiltered": (_bytes(5 * 8192, seed=4), dict(block_size=8192, shuffle=0)),
}


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", list(STEP_DATA))
def test_simulated_rank_steps_give_the_jax_packages_mesh_stats(name, world):
    data, kw = STEP_DATA[name]
    opts = tb.Options(**kw)
    got = simulated_stats(data, opts, world)
    _, want = jm.compress_chunked_mesh(data, jax_opts(opts), jm.block_mesh(world),
                                       return_stats=True)
    assert same_stats(got, want)
    assert int(got.histogram.sum()) == got.sample_bytes
    assert (got.histogram >= 0).all()
    if name.startswith("6MiB"):
        assert 0 < got.sample_bytes < len(data)
    else:
        assert got.sample_bytes == len(got.block_diffs) * opts.block_size


def test_hist_sample_accounting_is_the_jax_packages():
    for args in [(4, 2, 1 << 20, 6), (8, 1, 1 << 20, 6), (3, 3, 4112, 7), (1, 64, 1 << 20, 64),
                 (4, 1, 16384, 2), (2, 4, 1000, 7)]:
        assert tm._hist_sample_accounting(*args) == jm._hist_sample_accounting(*args)
    for n in (1, 511, 512, 513, 4096, 131072):
        assert tm._hist_stride(n) == jm._hist_stride(n)


# ---------------------------------------------------------------------------
# real groups over Gloo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """world size -> the directory its ranks wrote to; each group is
    spawned once, the first time a test asks for it."""
    return worker.group_cache(tmp_path_factory, worker.__file__, "mesh")


_read = worker.read_output


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_spawned_ranks_all_return_the_single_process_frame(spawned, world, case):
    data, kw = CASES[case]
    opts = tb.Options(**kw)
    frames = [_read(spawned(world), case, r, "mesh") for r in range(world)]
    single = tb.compress_with_options(data, opts)
    assert all(f == single for f in frames)
    assert single == tb.chunk.compress_chunked(data, opts.clamped())
    assert tb.decompress(single) == data
    if not (opts.codec == tb.Codec.ZSTD and opts.shuffle != tb.Shuffle.NOSHUFFLE):
        assert single == jm.compress_chunked_mesh(data, jax_opts(opts), jm.block_mesh(world))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_spawned_ranks_return_the_same_frame_without_statistics(spawned, world, case):
    """Without return_stats a rank filters its codec slice only and the
    statistics' collectives are left out; the frame is the same."""
    for r in range(world):
        assert _read(spawned(world), case, r, "meshplain") == _read(
            spawned(world), case, r, "mesh")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_spawned_ranks_all_decode_the_whole_data(spawned, world, case):
    data, _ = CASES[case]
    for r in range(world):
        assert _read(spawned(world), case, r, "meshdec") == data


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_spawned_ranks_all_hold_the_jax_packages_mesh_stats(spawned, world, case):
    data, kw = CASES[case]
    opts = tb.Options(**kw)
    _, want = jm.compress_chunked_mesh(data, jax_opts(opts), jm.block_mesh(world),
                                       return_stats=True)
    for r in range(world):
        with np.load(os.path.join(spawned(world), f"{case}.r{r}.stats.npz")) as got:
            assert np.array_equal(got["histogram"], want.histogram), r
            assert got["histogram"].dtype == np.int32
            assert np.array_equal(got["block_diffs"], want.block_diffs), r
            assert int(got["sample_bytes"]) == want.sample_bytes
            assert int(got["histogram"].sum()) == want.sample_bytes
    assert same_stats(simulated_stats(data, opts, world), want)


@pytest.mark.parametrize("world, case", [(2, "four_and_tail"), (3, "seven_blocks"),
                                         (4, "five_blocks")])
def test_the_cases_where_the_two_partitions_differ_do_differ(world, case):
    """The filter stage gives rank d rows [d*per, (d+1)*per) of the full
    blocks; the codec stage gives it process_slice's blocks of all of
    them.  These cases are there because some rank must filter a block
    the filter stage gave to another."""
    data, kw = CASES[case]
    bs = kw["block_size"]
    nb_full = len(data) // bs
    per = tm._pad_batch(nb_full, world)
    differ = False
    for r in range(world):
        lo, hi = process_slice(len(data), bs, r, world)
        codec = set(range(lo // bs, min(hi, nb_full * bs) // bs))
        differ |= not codec <= set(range(r * per, min((r + 1) * per, nb_full)))
    assert differ


@pytest.mark.parametrize("first, held", [(0, None), (0, 0), (0, 3), (2, 3), (3, 4), (0, 8),
                                         (5, 3), (8, 2)])
def test_codec_rows_are_the_filtered_blocks_whatever_the_step_left(first, held):
    """_codec_rows takes what it can from the filter step's rows (blocks
    first .. first+held, the rows past the last block zero padding) and
    filters the run before and the run after."""
    blocks = np.random.default_rng(11).integers(0, 256, (8, 256), dtype=np.uint8)
    want = tm.filter_blocks_sharded(blocks, 4, tb.Shuffle.SHUFFLE, device="cpu")
    y = None
    if held is not None:
        y = torch.zeros((held, 256), dtype=torch.uint8)
        n = max(0, min(held, 8 - first))
        y[:n] = torch.from_numpy(want[first : first + n])
    for lo, hi in [(0, 8), (0, 3), (2, 6), (3, 4), (5, 8), (7, 8)]:
        got = tm._codec_rows(blocks, y, first, lo, hi, 4, tb.Shuffle.SHUFFLE,
                             torch.device("cpu"))
        assert np.array_equal(got.numpy(), want[lo:hi]), (lo, hi)


def test_all_gather_rows_takes_the_name_this_torch_keeps(tmp_path):
    """torch 2.13 renames all_gather_into_tensor to all_gather_single and
    warns on the old name; the helper calls whichever this torch keeps, and
    without a warning."""
    import warnings

    from tpu_blosc_torch.dist import _group

    newer = getattr(dist, "all_gather_single", None)
    assert _group._all_gather_into is (newer or dist.all_gather_into_tensor)
    tm.initialize_distributed("cpu", store=dist.FileStore(str(tmp_path / "store"), 1),
                              rank=0, world_size=1)
    try:
        local = torch.arange(6, dtype=torch.int32).view(2, 3)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert torch.equal(_group.all_gather_rows(local), local)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", WORLDS)
def test_one_block_leaves_ranks_without_any(world):
    data, kw = CASES["one_block"]
    assert [process_slice(len(data), kw["block_size"], r, world) for r in range(1, world)] == [
        (len(data), len(data))] * (world - 1)


def test_dryrun_torch_at_two_ranks():
    """dryrun_torch.py, the port's dryrun_multichip: two ranks over Gloo
    run the step and a frame of 8 MiB and a tail against their oracles."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, os.path.join(repo, "dryrun_torch.py"), "2",
                          "--device", "cpu"],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("dryrun_torch ok: 2 ranks on cpu over gloo")
    source = open(os.path.join(repo, "dryrun_torch.py")).read()
    assert "import jax" not in source and "tpu_blosc " not in source
