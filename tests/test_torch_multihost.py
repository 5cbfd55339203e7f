"""The port's multi-process frames against the JAX package's, on the CPU.

After tests/test_multihost.py and the multihost part of
tests/test_dist.py.  With one process (no group) the port's
``compress_chunked_multihost`` must write the frame ``tpu_blosc``'s does;
groups of 2, 3 and 4 processes over Gloo (tests/torch_dist_worker.py,
spawned once per world size) must all assemble the single-process frame,
decode slices that concatenate to the input, and divide the work as
``process_slice`` says.  Byte equality: the tolerance is 0.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch.distributed as dist

import torch_dist_worker as worker
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)
import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc.dist import multihost as jmh
from tpu_blosc_torch.dist import multihost as tmh

pytestmark = pytest.mark.skipif(
    not (dist.is_available() and dist.is_gloo_available()),
    reason="torch.distributed with the Gloo backend is not available",
)

WORLDS = (2, 3, 4)
CASES = worker.cases()
MH_KEYS = {"process", "num_processes", "local_bytes", "global_bytes", "local_blocks",
           "local_compress_s", "gather_s"}


def jax_opts(opts: tb.Options) -> jb.Options:
    return jb.Options(codec=jb.Codec(int(opts.codec)), level=opts.level,
                      shuffle=jb.Shuffle(int(opts.shuffle)), type_size=opts.type_size,
                      block_size=opts.block_size)


@pytest.mark.parametrize("procs", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [100_001, 4 * 65536, 65536 - 1, 7 * 65536 + 3, 5])
def test_process_slices_partition_exactly_and_are_the_jax_packages(n, procs):
    bs = 16384
    covered = [tmh.process_slice(n, bs, p, procs) for p in range(procs)]
    assert covered == [jmh.process_slice(n, bs, p, procs) for p in range(procs)]
    for s, e in covered:
        if e > s:  # empty trailing slices sit at n
            assert s % bs == 0
    assert covered[0][0] == 0 and covered[-1][1] == n
    for (_, e0), (s1, _) in zip(covered, covered[1:]):
        assert e0 == s1


@pytest.mark.parametrize("shuffle", list(tb.Shuffle), ids=lambda s: s.name)
@pytest.mark.parametrize("codec", list(tb.Codec), ids=lambda c: c.name)
def test_one_process_frame_is_the_host_frame_and_the_jax_packages(codec, shuffle):
    data = np.arange(100_000, dtype=np.float32).tobytes() + b"tail!"
    opts = tb.Options(codec=codec, shuffle=shuffle, block_size=32768)
    stats: dict = {}
    frame = tmh.compress_chunked_multihost(len(data), data, opts, stats=stats)
    assert frame == tb.compress_with_options(data, opts)
    assert frame == jmh.compress_chunked_multihost(len(data), data, jax_opts(opts))
    assert tb.decompress(frame) == data
    assert set(stats) == MH_KEYS
    assert (stats["process"], stats["num_processes"]) == (0, 1)
    assert stats["local_bytes"] == stats["global_bytes"] == len(data)
    assert stats["local_blocks"] == 13


def test_a_wrong_slice_is_refused():
    data = np.arange(10_000, dtype=np.float32).tobytes()
    with pytest.raises(tb.InvalidDataError):
        tmh.compress_chunked_multihost(len(data), data[:100], tb.Options(block_size=4096))
    with pytest.raises(tb.InvalidDataError):
        tmh.compress_chunked_multihost(0, b"", tb.Options())
    with pytest.raises(tb.InvalidCodecError):
        tmh.compress_chunked_multihost(len(data), data, tb.Options(codec=9, block_size=4096))


def test_one_process_decodes_the_whole_frame():
    data, kw = CASES["ramp_noise"]
    frame = jb.compress_with_options(data, jb.Options(**kw))
    assert tmh.decompress_chunked_multihost(frame) == (data, 0, len(data))
    assert tmh.decompress_chunked_multihost(frame) == jmh.decompress_chunked_multihost(frame)
    small = tb.compress(b"hello" * 100, tb.LZ4, 5, tb.NOSHUFFLE, 1)  # not split
    assert tmh.decompress_chunked_multihost(small) == (b"hello" * 100, 0, 500)


def test_one_process_gathers_its_own_payloads():
    payloads, memf = [b"abc", b"", b"defg"], [False, True, False]
    got = tmh.allgather_payloads(payloads, memf)
    assert got == (payloads, memf)
    assert got[0] is not payloads  # a copy, as in the JAX package


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """world size -> the directory its ranks wrote to; each group is
    spawned once, the first time a test asks for it."""
    return worker.group_cache(tmp_path_factory, worker.__file__, "mh")


_read = worker.read_output


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_spawned_processes_all_assemble_the_single_process_frame(spawned, world, case):
    data, kw = CASES[case]
    single = tb.compress_with_options(data, tb.Options(**kw))
    assert single == jb.compress_with_options(data, jax_opts(tb.Options(**kw)))
    for r in range(world):
        assert _read(spawned(world), case, r, "mh") == single
    assert tb.decompress(single) == data


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_spawned_processes_decoded_slices_concatenate_to_the_input(spawned, world, case):
    data, _ = CASES[case]
    slices = [_read(spawned(world), case, r, "mhdec") for r in range(world)]
    assert b"".join(slices) == data
    for r, piece in enumerate(slices):
        record = json.loads(_read(spawned(world), case, r, "mh.json"))
        assert record["decoded"] == record["slice"]
        assert piece == data[record["slice"][0] : record["slice"][1]]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_spawned_processes_divide_the_work(spawned, world, case):
    data, kw = CASES[case]
    bs = kw["block_size"]
    n = len(data)
    stats = [json.loads(_read(spawned(world), case, r, "mh.json")) for r in range(world)]
    for r, s in enumerate(stats):
        assert MH_KEYS <= set(s)
        assert (s["process"], s["num_processes"], s["global_bytes"]) == (r, world, n)
        # whole blocks, one more or less than a neighbour, the last one short
        assert abs(s["local_bytes"] - n / world) <= 2 * bs, s
        assert s["local_compress_s"] >= 0.0 and s["gather_s"] >= 0.0
        assert tuple(s["slice"]) == tmh.process_slice(n, bs, r, world)
    assert sum(s["local_bytes"] for s in stats) == n
    total_blocks = sum(s["local_blocks"] for s in stats)
    assert total_blocks == -(-n // bs)
    assert max(s["local_blocks"] for s in stats) <= total_blocks // world + 1


@pytest.mark.parametrize("world", WORLDS)
def test_the_mixed_case_has_raw_and_compressed_blocks(spawned, world):
    frame = _read(spawned(world), "ramp_noise", 0, "mh")
    entries, _ = tb.chunk.parse_block_table(frame, tb.parse_header(frame))
    assert {m for _, m in entries} == {True, False}
