"""The port's multi-process sharded checkpoints against the JAX package's.

After the sharded part of tests/test_checkpoint.py (:112-160, :250-289).
Groups of 2, 3 and 4 processes over Gloo on the CPU
(tests/torch_ckpt_worker.py, spawned once per world size) write the trees
of ``torch_ckpt_worker.trees``; the tests here read the files with both
packages' loaders and hold them to the full tensors.  At two processes
tests/ckpt_worker.py writes the same tree with the JAX package, and each
``p{r}.tpbs`` must be byte-identical.  A group of one process in this
process covers the replicated route, refusals and the read counts.
Byte equality: the tolerance is 0.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ckpt_worker as ckpt_worker
import torch_dist_worker as worker
from tpu_blosc import checkpoint as jc
from tpu_blosc_torch import checkpoint as tc
from tpu_blosc_torch.errors import BloscError, InvalidDataError
from tpu_blosc_torch.options import Options
from tpu_blosc_torch.stream import StreamReader

pytestmark = pytest.mark.skipif(
    not (dist.is_available() and dist.is_gloo_available()),
    reason="torch.distributed with the Gloo backend is not available",
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 3, 4)
CASES = [(w, case) for w in WORLDS for case in ckpt_worker.trees(w)]


def to_numpy(x):
    """A leaf's bytes as NumPy sees them (bfloat16 as its uint16 bits)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_same_tree(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_tree(g, w)
    elif isinstance(want, (torch.Tensor, np.ndarray)):
        g, w = to_numpy(got), to_numpy(want)
        assert g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w)
    else:
        assert got == want and type(got) is type(want)


def leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def manifests(prefix: str, world: int) -> list[dict]:
    out = []
    for p in range(world):
        with StreamReader(f"{prefix}.p{p}.tpbs") as r:
            out.append(json.loads(r.read(0)))
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """world size -> the directory its ranks wrote to; each group is
    spawned once, the first time a test asks for it."""
    return worker.group_cache(tmp_path_factory, ckpt_worker.__file__, "ckpt")


@pytest.mark.parametrize("world, case", CASES)
def test_the_port_loads_its_set_back(spawned, world, case):
    _, tree, _, _ = ckpt_worker.trees(world)[case]
    prefix = os.path.join(spawned(world), case)
    got = tc.load_pytree_sharded(prefix, world)
    assert_same_tree(got, tree)
    for path, want in leaf_paths(tree):
        leaf = tc.load_leaf_sharded(prefix, world, path)
        assert_same_tree(leaf, want)
        if isinstance(want, (torch.Tensor, np.ndarray)):
            assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"


@pytest.mark.parametrize("world, case", CASES)
def test_the_jax_package_loads_the_ports_set(spawned, world, case):
    _, tree, _, _ = ckpt_worker.trees(world)[case]
    prefix = os.path.join(spawned(world), case)
    assert_same_tree(jc.load_pytree_sharded(prefix, world), _as_arrays(tree))
    for path, want in leaf_paths(tree):
        assert_same_tree(jc.load_leaf_sharded(prefix, world, path), _as_arrays(want))


def _as_arrays(tree):
    """The tree as the JAX package returns it: NumPy arrays for tensors."""
    if isinstance(tree, dict):
        return {k: _as_arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_arrays(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        import ml_dtypes

        if tree.dtype == torch.bfloat16:
            return tree.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return tree.numpy()
    return tree


@pytest.mark.parametrize("world, case", CASES)
def test_manifests_have_the_jax_packages_layout(spawned, world, case):
    """Key order, "process", and one span and one record for each shard a
    process writes: every element of a sharded leaf is written once."""
    _, tree, sharded, _ = ckpt_worker.trees(world)[case]
    prefix = os.path.join(spawned(world), case)
    metas = manifests(prefix, world)
    for p, meta in enumerate(metas):
        assert list(meta) == ["version", "tree", "leaf_records", "process"]
        assert meta["process"] == p and meta["tree"] == metas[0]["tree"]
        with StreamReader(f"{prefix}.p{p}.tpbs") as r:
            assert len(r) == 1 + sum(x["n"] for x in meta["leaf_records"])
    leaves = dict(leaf_paths(tree))
    for path in sharded:
        node = tc._walk_manifest(metas[0]["tree"], path)
        full = leaves[path]
        if full.numel() == 0:
            assert node == {"t": "array0", "dtype": "float32", "shape": list(full.shape)}
            continue
        if sharded[path] == ["R"]:  # a DTensor every rank holds whole
            assert node["t"] == "array"
            assert [m["leaf_records"][node["i"]] for m in metas] == [
                {"k": "replicated", "n": 1}] + [{"k": "replicated", "n": 0}] * (world - 1)
            continue
        assert list(node) == ["t", "i", "dtype", "shape"] and node["t"] == "sharded_array"
        covered = np.zeros(tuple(full.shape), dtype=np.int32)
        for meta in metas:
            info = meta["leaf_records"][node["i"]]
            assert list(info) == ["k", "n", "spans"] and info["k"] == "sharded"
            assert info["n"] == len(info["spans"]) <= 1
            for span in info["spans"]:
                assert all(b > a for a, b in span)  # an empty shard is no span
                covered[tuple(slice(a, b) for a, b in span)] += 1
        assert (covered == 1).all()


def test_uneven_rows_split_as_torch_chunk_does(spawned):
    """10 rows over 3 ranks are 4, 4 and 2; 2 rows over 3 leave the last
    rank with an empty shard, which is no record and no span."""
    metas = manifests(os.path.join(spawned(3), "uneven"), 3)
    ten = tc._walk_manifest(metas[0]["tree"], "ten")["i"]
    short = tc._walk_manifest(metas[0]["tree"], "short/0")["i"]
    assert [m["leaf_records"][ten]["spans"] for m in metas] == [
        [[[0, 4], [0, 7]]], [[[4, 8], [0, 7]]], [[[8, 10], [0, 7]]]]
    assert [m["leaf_records"][short] for m in metas] == [
        {"k": "sharded", "n": 1, "spans": [[[0, 1], [0, 5]]]},
        {"k": "sharded", "n": 1, "spans": [[[1, 2], [0, 5]]]},
        {"k": "sharded", "n": 0, "spans": []}]


def test_a_replicated_mesh_dimension_writes_each_shard_once(spawned):
    """On a (2, 2) mesh [Replicate(), Shard(0)] gives ranks 0 and 2 the
    same rows: rank 0 writes them, rank 2 writes nothing."""
    metas = manifests(os.path.join(spawned(4), "mesh2d"), 4)
    a = tc._walk_manifest(metas[0]["tree"], "a")["i"]
    assert [m["leaf_records"][a]["spans"] for m in metas] == [
        [[[0, 3], [0, 5]]], [[[3, 6], [0, 5]]], [], []]
    c = tc._walk_manifest(metas[0]["tree"], "c")["i"]
    assert [m["leaf_records"][c]["n"] for m in metas] == [1, 0, 1, 0]
    d = tc._walk_manifest(metas[0]["tree"], "d")["i"]  # sharded twice on one axis
    assert [m["leaf_records"][d]["spans"][0][0] for m in metas] == [
        [0, 3], [3, 5], [5, 7], [7, 9]]


def test_a_set_with_a_hole_raises(spawned):
    prefix = os.path.join(spawned(2), "ref")
    with pytest.raises(InvalidDataError, match="holes"):
        tc.load_pytree_sharded(prefix, 1)  # process 1's rows are missing
    with pytest.raises(InvalidDataError, match="holes"):
        tc.load_leaf_sharded(prefix, 1, "w")
    with pytest.raises(FileNotFoundError):
        tc.load_pytree_sharded(prefix, 3)


def test_a_checksummed_set_refuses_a_flipped_bit(spawned, tmp_path):
    src = os.path.join(spawned(2), "checksum_zstd")
    prefix = str(tmp_path / "crc")
    for p in range(2):
        with open(f"{src}.p{p}.tpbs", "rb") as f:
            blob = bytearray(f.read())
        if p == 1:
            with StreamReader(f"{src}.p1.tpbs") as r:
                off = r._offsets[1]
            blob[off + 8 + 40] ^= 0x01
        with open(f"{prefix}.p{p}.tpbs", "wb") as f:
            f.write(blob)
    with pytest.raises(BloscError):
        tc.load_pytree_sharded(prefix, 2)


def test_load_leaf_sharded_reads_the_manifests_and_that_leafs_records_only(spawned, monkeypatch):
    prefix = os.path.join(spawned(2), "dtypes")
    reads = []
    orig = StreamReader.read

    def counting(self, i):
        reads.append(i)
        return orig(self, i)

    monkeypatch.setattr(StreamReader, "read", counting)
    tc.load_leaf_sharded(prefix, 2, "i16")  # leaf 1: one record after bf16's in each file
    assert reads == [0, 0, 2, 2]
    reads.clear()
    tc.load_leaf_sharded(prefix, 2, "plain/b")  # replicated: process 0's file alone
    assert reads == [0, 0, 3]
    reads.clear()
    assert tc.load_leaf_sharded(prefix, 2, "plain/name") == "run-7"
    assert reads == [0, 0]
    with pytest.raises(KeyError):
        tc.load_leaf_sharded(prefix, 2, "nope")
    with pytest.raises(KeyError, match="subtree"):
        tc.load_leaf_sharded(prefix, 2, "plain")


# ---------------------------------------------------------------------------
# against the JAX package's own workers, at two processes
# ---------------------------------------------------------------------------


def _run_jax_workers(prefix: str) -> str:
    """One run of tests/ckpt_worker.py at two processes, as
    tests/test_checkpoint.py runs it; "" when both exit with 0, else what
    the failing one wrote to its standard error."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "ckpt_worker.py"), str(p), "2",
             str(port), prefix],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for p in range(2)
    ]
    try:
        for proc in procs:
            try:
                _, err = proc.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                return "a worker timed out"
            if proc.returncode != 0:
                return err.decode(errors="replace")[-2000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return ""


@pytest.fixture(scope="module")
def jax_set(tmp_path_factory):
    """The set tests/ckpt_worker.py writes with the JAX package.  Its
    coordinator takes a port that was free a moment before; another
    process may take it first, so a failed run is tried once more."""
    failure = ""
    for attempt in range(2):
        prefix = str(tmp_path_factory.mktemp(f"jax_ckpt{attempt}") / "mh")
        failure = _run_jax_workers(prefix)
        if not failure:
            assert os.path.exists(prefix + ".ok")
            return prefix
    pytest.fail(f"tests/ckpt_worker.py failed twice: {failure}")


@pytest.mark.parametrize("p", [0, 1])
def test_each_process_file_is_the_jax_packages_byte_for_byte(spawned, jax_set, p):
    with open(f"{jax_set}.p{p}.tpbs", "rb") as a, open(
            os.path.join(spawned(2), f"ref.p{p}.tpbs"), "rb") as b:
        assert a.read() == b.read()


def test_the_port_loads_the_jax_packages_set(jax_set):
    _, tree, _, _ = ckpt_worker.trees(2)["ref"]
    assert_same_tree(tc.load_pytree_sharded(jax_set, 2),
                     {**tree, "bias": torch.from_numpy(tree["bias"])})
    assert_same_tree(tc.load_leaf_sharded(jax_set, 2, "w"), tree["w"])
    assert tc.load_leaf_sharded(jax_set, 2, "step") == 42


# ---------------------------------------------------------------------------
# a group of one process, in this process
# ---------------------------------------------------------------------------


@pytest.fixture
def solo_group(tmp_path):
    """A Gloo group of this process alone: a DTensor needs a device mesh,
    and a device mesh a process group."""
    from torch.distributed.tensor import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", (1,))
    finally:
        dist.destroy_process_group()


def test_one_rank_shard_is_the_jax_packages_one_device_file(solo_group, tmp_path):
    """A jax array sharded over a one-device mesh is fully replicated and
    is written as an "array" node; so is a DTensor whose Shard placement
    lies on a mesh dimension of one rank."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from torch.distributed.tensor import DTensor, Shard

    data = np.arange(8 * 500, dtype=np.float32).reshape(8, 500)
    extra = np.linspace(0, 1, 300, dtype=np.float64)
    arr = jax.device_put(data, NamedSharding(Mesh(np.array(jax.devices()[:1]), ("x",)),
                                             P("x", None)))
    jc.save_pytree_sharded(str(tmp_path / "j"), {"w": arr, "extra": extra, "k": 5})
    w = DTensor.from_local(torch.from_numpy(data), solo_group, [Shard(0)])
    tc.save_pytree_sharded(str(tmp_path / "t"), {"w": w, "extra": extra, "k": 5})
    assert (tmp_path / "t.p0.tpbs").read_bytes() == (tmp_path / "j.p0.tpbs").read_bytes()
    meta = manifests(str(tmp_path / "t"), 1)[0]
    assert tc._walk_manifest(meta["tree"], "w")["t"] == "array"
    got = tc.load_pytree_sharded(str(tmp_path / "t"), 1)
    assert_same_tree(got, {"w": torch.from_numpy(data), "extra": torch.from_numpy(extra), "k": 5})


def test_the_jax_packages_one_process_sharded_set_loads(tmp_path):
    """Four shards in one process's file (tests/test_checkpoint.py:112-124):
    four spans and four records in p0."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    data = np.arange(8 * 500, dtype=np.float32).reshape(8, 500)
    arr = jax.device_put(data, NamedSharding(Mesh(np.array(jax.devices()[:4]), ("x",)),
                                             P("x", None)))
    prefix = str(tmp_path / "sh")
    jc.save_pytree_sharded(prefix, {"w": arr, "k": 5})
    assert_same_tree(tc.load_pytree_sharded(prefix, 1), {"w": torch.from_numpy(data), "k": 5})
    assert_same_tree(tc.load_leaf_sharded(prefix, 1, "w"), torch.from_numpy(data))


def test_a_partial_placement_is_refused(solo_group, tmp_path):
    from torch.distributed.tensor import DTensor, Partial

    x = DTensor.from_local(torch.ones(4, 4), solo_group, [Partial()])
    with pytest.raises(TypeError, match="placement"):
        tc.save_pytree_sharded(str(tmp_path / "p"), {"x": x})


def test_unsupported_leaves_and_keys_are_refused_without_a_group(tmp_path):
    with pytest.raises(TypeError):
        tc.save_pytree_sharded(str(tmp_path / "a"), {"x": object()})
    with pytest.raises(TypeError):
        tc.save_pytree_sharded(str(tmp_path / "b"), {1: torch.ones(3)})


def test_without_a_group_process_0_writes_everything(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4), "n": np.int32(7), "t": (1, "x")}
    prefix = str(tmp_path / "solo")
    tc.save_pytree_sharded(prefix, tree, Options(codec=2), checksum=True)
    assert os.listdir(tmp_path) == ["solo.p0.tpbs"]
    assert_same_tree(tc.load_pytree_sharded(prefix, 1),
                     {"w": tree["w"], "n": torch.tensor(7, dtype=torch.int32), "t": (1, "x")})
    jc_tree = jc.load_pytree_sharded(prefix, 1)
    assert np.array_equal(jc_tree["w"], tree["w"].numpy()) and jc_tree["t"] == (1, "x")


def test_importing_the_port_does_not_import_dtensor():
    code = ("import sys, tpu_blosc_torch, tpu_blosc_torch.checkpoint, tpu_blosc_torch.dist; "
            "assert 'torch.distributed.tensor' not in sys.modules; "
            "assert 'jax' not in sys.modules and 'tpu_blosc' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_cuda_shards_are_device_records_with_the_same_bytes(solo_group, tmp_path, monkeypatch):
    """A CUDA shard goes through compress_array's two stages; here CPU
    tensors are handed to that route, and the file must not change."""
    from torch.distributed.tensor import DTensor, Replicate

    big = torch.arange(1_500_000, dtype=torch.float32).reshape(1500, 1000)  # multi-block
    tree = {"w": DTensor.from_local(big, solo_group, [Replicate()]), "b": torch.ones(5)}
    tc.save_pytree_sharded(str(tmp_path / "host"), tree)
    kinds = []
    orig = tc._write_leaf_records

    def spy(w, records, opts, strategy="transfer"):
        records = list(records)
        kinds.extend(k for k, _ in records)
        return orig(w, records, opts, strategy)

    monkeypatch.setattr(tc, "_on_cuda", lambda leaf: isinstance(leaf, torch.Tensor))
    monkeypatch.setattr(tc, "_write_leaf_records", spy)
    tc.save_pytree_sharded(str(tmp_path / "dev"), tree)
    assert kinds == ["device", "device"]
    assert (tmp_path / "dev.p0.tpbs").read_bytes() == (tmp_path / "host.p0.tpbs").read_bytes()
