"""Sharded tensors at the port's single-frame entry points, against the JAX
package's sharded ``jax.Array``s, on the CPU.

After tests/test_device_api.py:98-124, tests/test_array.py:236-245 and
tests/test_checkpoint.py:115.  Groups of 2, 3 and 4 processes over Gloo
(tests/torch_sharded_worker.py, spawned once per world size) put the
tensors of ``torch_sharded_worker.cases`` through compress_array,
pack_array, StreamWriter.write_array, save_array and save_pytree as
DTensors, and decode the frames with ``sharding=(mesh, placements)``.
Here each rank's frame, envelope, record and file is held to what
tpu_blosc writes for the same data as a sharded ``jax.Array`` (over the
test process's CPU devices), and each decoder's local tensor to its span
of tpu_blosc's decode, cut with ``torch.chunk``.  A group of one process
in this process covers the refusals, empty and Fortran-ordered
envelopes, dictionary records and the fault this closes.  Byte equality:
the tolerance is 0.
"""

from __future__ import annotations

import datetime
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import torch_dist_worker as worker
import torch_sharded_worker as sw
import tpu_blosc as jb
from tpu_blosc import checkpoint as jc
from tpu_blosc.options import Options as JOptions
import tpu_blosc_torch as tb
from tpu_blosc_torch.dist import _sharded

pytestmark = pytest.mark.skipif(
    not (dist.is_available() and dist.is_gloo_available()),
    reason="torch.distributed with the Gloo backend is not available",
)

WORLDS = (2, 3, 4)
CASES = [(w, case) for w in WORLDS for case in sw.cases(w)]
RANKED = [(w, case, r) for w, case in CASES for r in range(w)]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """world size -> the directory its ranks wrote to."""
    return worker.group_cache(tmp_path_factory, sw.__file__, "sharded")


def _np_full(dtype: str, arr: np.ndarray) -> np.ndarray:
    return arr.view(ml_dtypes.bfloat16) if dtype == "bfloat16" else arr


def _jax_sharding(mesh_shape, spec, shape) -> NamedSharding:
    """The jax counterpart of a case's placements over the test process's
    CPU devices; a dimension the mesh does not divide evenly (jax refuses
    it) is split over one device."""
    if len(mesh_shape) == 2:
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("a", "b"))
        axes = [None] * len(shape)
        for m, p in enumerate(spec):
            if p != "R":
                axes[p[1]] = "ab"[m]
        return NamedSharding(mesh, P(*axes))
    (dim,) = [p[1] for p in spec]
    n = mesh_shape[0] if shape[dim] % mesh_shape[0] == 0 else 1
    axes = [None] * len(shape)
    axes[dim] = "d"
    return NamedSharding(Mesh(np.array(jax.devices()[:n]), ("d",)), P(*axes))


class Reference:
    """tpu_blosc's outputs for one case, written once into ``tmp``."""

    def __init__(self, world: int, case: str, tmp):
        mesh_shape, dtype, arr, spec, kw, strategy = sw.cases(world)[case]
        self.mesh_shape, self.spec, self.dtype = mesh_shape, spec, dtype
        self.full = _np_full(dtype, arr)
        opts = JOptions(**kw)
        # tpu_blosc's device route cannot bitcast complex values: its host
        # frame (the transfer frame) stands for it
        self.complex = dtype == "complex64"
        leaf = self.full
        if self.complex:
            opts = JOptions(**kw, type_size=8)
            self.frame = jb.compress_with_options(self.full.tobytes(), opts)
        else:
            self.sharding = _jax_sharding(mesh_shape, spec, self.full.shape)
            leaf = jax.device_put(self.full, self.sharding)
            self.frame = jb.compress_array(leaf, opts, strategy=strategy)
        self.env = jb.pack_array(leaf, opts)
        self.record = self._file(tmp / "rec.tpbs",
                                 lambda p: self._write_record(p, leaf, opts, strategy))
        if self.complex:
            self.saved = self.record
        else:
            self.saved = self._file(tmp / "save.tpbs", lambda p: jb.save_array(p, leaf, opts))
        self.tree = self._file(tmp / "tree.tpbs", lambda p: jc.save_pytree(
            p, {"x": leaf, "b": np.arange(5, dtype=np.int32), "step": 7}, opts))
        if self.complex:
            self.decoded = np.frombuffer(jb.decompress(self.frame), np.complex64)
        else:
            self.decoded = np.asarray(jb.decompress_array(
                self.frame, self.full.dtype, shape=self.full.shape, sharding=self.sharding))
        self.decoded = self.decoded.reshape(self.full.shape)
        assert np.array_equal(self.decoded.view(np.uint8), self.full.view(np.uint8))

    def _write_record(self, path, leaf, opts, strategy):
        with jb.StreamWriter(path, opts) as w:
            if self.complex:
                w.write_frame(self.frame)
            else:
                w.write_array(leaf, strategy=strategy)

    @staticmethod
    def _file(path, write) -> bytes:
        write(str(path))
        with open(path, "rb") as f:
            return f.read()

    def span_bytes(self, rank: int, placements_spec) -> tuple[bytes, tuple]:
        """(bytes, shape) of rank ``rank``'s piece of the decoded tensor,
        cut with torch.chunk mesh dimension by mesh dimension."""
        coord = np.unravel_index(rank, self.mesh_shape)
        local = torch.from_numpy(self.decoded.view(np.uint8).reshape(
            *self.full.shape, self.full.dtype.itemsize).copy())
        for m, p in enumerate(placements_spec):
            if p != "R":
                pieces = torch.chunk(local, self.mesh_shape[m], dim=p[1])
                local = (pieces[coord[m]] if coord[m] < len(pieces)
                         else local.narrow(p[1], 0, 0))
        return local.contiguous().numpy().tobytes(), tuple(local.shape[:-1])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    done: dict = {}

    def get(world: int, case: str) -> Reference:
        if (world, case) not in done:
            done[world, case] = Reference(world, case, tmp_path_factory.mktemp(
                f"ref_{case}_w{world}"))
        return done[world, case]

    return get


def _read(out_dir: str, name: str) -> bytes:
    with open(os.path.join(out_dir, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("world, case, rank", RANKED)
def test_each_ranks_frame_is_tpu_blosc_s(spawned, reference, world, case, rank):
    """compress_array of the DTensor on every rank: tpu_blosc's frame of the
    sharded jax.Array (the match and rle strategies' frames too)."""
    assert _read(spawned(world), f"{case}.r{rank}.frame") == reference(world, case).frame


@pytest.mark.parametrize("world, case, rank", RANKED)
def test_each_ranks_envelope_is_tpu_blosc_s(spawned, reference, world, case, rank):
    assert _read(spawned(world), f"{case}.r{rank}.env") == reference(world, case).env


@pytest.mark.parametrize("world, case, rank", RANKED)
def test_each_ranks_stream_record_is_tpu_blosc_s(spawned, reference, world, case, rank):
    """StreamWriter.write_array of the DTensor into each rank's own stream."""
    assert _read(spawned(world), f"{case}.r{rank}.rec.tpbs") == reference(world, case).record


@pytest.mark.parametrize("world, case", CASES)
def test_save_array_is_written_by_process_0_alone(spawned, reference, world, case):
    out = spawned(world)
    assert _read(out, f"{case}.save.r0.tpbs") == reference(world, case).saved
    for r in range(1, world):
        assert not os.path.exists(os.path.join(out, f"{case}.save.r{r}.tpbs"))


@pytest.mark.parametrize("world, case", CASES)
def test_save_pytree_is_tpu_blosc_s_file_written_by_process_0_alone(spawned, reference, world,
                                                                    case):
    """A DTensor leaf is the plain "array" node of its full tensor, as
    tpu_blosc writes a sharded jax.Array leaf; both packages load it."""
    out = spawned(world)
    ref = reference(world, case)
    path = os.path.join(out, f"{case}.tree.r0.tpbs")
    assert _read(out, f"{case}.tree.r0.tpbs") == ref.tree
    for r in range(1, world):
        assert not os.path.exists(os.path.join(out, f"{case}.tree.r{r}.tpbs"))
    got = tb.load_pytree(path)
    assert got["step"] == 7 and got["b"].tolist() == list(range(5))
    raw = got["x"].view(torch.uint16) if got["x"].dtype == torch.bfloat16 else got["x"]
    assert raw.numpy().tobytes() == ref.full.tobytes()
    assert np.asarray(jc.load_pytree(path)["x"]).tobytes() == ref.full.tobytes()


@pytest.mark.parametrize("decoder", sw.DECODERS)
@pytest.mark.parametrize("world, case, rank", RANKED)
def test_each_decoder_gives_the_ranks_span(spawned, reference, world, case, rank, decoder):
    """A DTensor with the requested placements and the global shape, whose
    local tensor is the rank's span of tpu_blosc's decode."""
    ref = reference(world, case)
    out = spawned(world)
    meta = json.loads(_read(out, f"{case}.r{rank}.dec.json"))[decoder]
    spec = ["R"] * len(ref.mesh_shape) if decoder.endswith("replicate") else ref.spec
    want, shape = ref.span_bytes(rank, spec)
    with np.load(os.path.join(out, f"{case}.r{rank}.dec.npz")) as got:
        assert got[decoder].tobytes() == want
    placements = sw.placements_of(spec)
    assert meta == {"type": "DTensor", "placements": [repr(p) for p in placements],
                    "shape": list(ref.full.shape), "local_shape": list(shape),
                    "device": "cpu", "dtype": f"torch.{ref.dtype}"}


@pytest.mark.parametrize("world, case, rank", [
    (w, case, r) for w, case, r in RANKED if sw.cases(w)[case][1] == "float32"])
def test_the_span_rule_is_dtensor_s_own(spawned, reference, world, case, rank):
    """distribute_tensor (DTensor's own split) gives each rank the piece
    the span rule and torch.chunk give it."""
    ref = reference(world, case)
    want, _ = ref.span_bytes(rank, ref.spec)
    assert _read(spawned(world), f"{case}.r{rank}.dist") == want


# ---------------------------------------------------------------------------
# a group of one process, in this process
# ---------------------------------------------------------------------------


@pytest.fixture
def solo_mesh(tmp_path):
    """A Gloo group of this process alone and its one-rank CPU mesh."""
    from torch.distributed.tensor import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", (1,))
    finally:
        dist.destroy_process_group()


def test_the_fault_reproduction_gives_the_frame_envelope_and_file(solo_mesh, tmp_path):
    """A 4 MiB float32 Shard(0) DTensor through compress_array, pack_array
    and save_pytree (each raised ``.numpy() is not supported for tensor
    subclasses`` before): the host frame, tpu_blosc's envelope, and the
    file tpu_blosc writes for the array sharded over one device."""
    from torch.distributed.tensor import DTensor, Shard

    data = np.arange(1 << 20, dtype=np.float32)
    w = DTensor.from_local(torch.from_numpy(data), solo_mesh, [Shard(0)])
    opts, jopts = tb.Options(block_size=1 << 18), JOptions(block_size=1 << 18)
    assert tb.compress_array(w, opts) == jb.compress_with_options(data.tobytes(), jopts)
    assert tb.pack_array(w) == jb.pack_array(data)
    tb.save_pytree(tmp_path / "t.tpbs", {"w": w})
    leaf = jax.device_put(data, NamedSharding(Mesh(np.array(jax.devices()[:1]), ("d",)),
                                              P("d")))
    jc.save_pytree(str(tmp_path / "j.tpbs"), {"w": leaf})
    assert (tmp_path / "t.tpbs").read_bytes() == (tmp_path / "j.tpbs").read_bytes()


def test_a_partial_placement_is_refused_by_every_entry_point(solo_mesh, tmp_path):
    from torch.distributed.tensor import DTensor, Partial

    x = DTensor.from_local(torch.ones(1000), solo_mesh, [Partial()])
    frame = tb.compress_array(torch.ones(1000))
    calls = [lambda: tb.compress_array(x), lambda: tb.pack_array(x),
             lambda: tb.save_array(tmp_path / "a.tpbs", x),
             lambda: tb.save_pytree(tmp_path / "t.tpbs", {"x": x}),
             lambda: tb.decompress_array(frame, torch.float32, sharding=(solo_mesh, [Partial()])),
             lambda: tb.unpack_array(tb.pack_array(torch.ones(3)),
                                     sharding=(solo_mesh, [Partial()]))]
    for call in calls:
        with pytest.raises(TypeError, match="placement"):
            call()
    with tb.StreamWriter(tmp_path / "w.tpbs") as w, pytest.raises(TypeError, match="placement"):
        w.write_array(x)


def test_a_device_that_disagrees_with_the_mesh_is_refused(solo_mesh, tmp_path):
    from torch.distributed.tensor import Shard

    sharding = (solo_mesh, [Shard(0)])
    frame = tb.compress_array(torch.arange(1000.0))
    tb.save_array(tmp_path / "a.tpbs", torch.arange(1000.0))
    with tb.StreamReader(tmp_path / "a.tpbs") as r:
        calls = [lambda: tb.decompress_array(frame, torch.float32, device="cuda",
                                             sharding=sharding),
                 lambda: tb.unpack_array(tb.pack_array(torch.ones(3)), device="cuda:0",
                                         sharding=sharding),
                 lambda: r.read_array(0, torch.float32, device="meta", sharding=sharding),
                 lambda: list(r.iter_arrays(torch.float32, device="cuda", sharding=sharding)),
                 lambda: tb.load_array(tmp_path / "a.tpbs", torch.float32, device="cuda",
                                       sharding=sharding)]
        for call in calls:
            with pytest.raises(ValueError, match="disagrees"):
                call()
    # the mesh's own device type, and a flag of unpack_array, agree
    assert tb.decompress_array(frame, torch.float32, device="cpu",
                               sharding=sharding).to_local().equal(torch.arange(1000.0))
    assert tb.unpack_array(tb.pack_array(torch.ones(3)), device=True,
                           sharding=sharding).to_local().equal(torch.ones(3))


@pytest.mark.parametrize("bad", ["mesh", 3, (1, 2, 3)])
def test_a_sharding_that_is_no_pair_is_refused(solo_mesh, bad):
    frame = tb.compress_array(torch.arange(10.0))
    with pytest.raises(TypeError, match="pair"):
        tb.decompress_array(frame, torch.float32, sharding=bad)


def test_empty_dtensors_and_envelopes(solo_mesh):
    from torch.distributed.tensor import DTensor, Shard

    x = DTensor.from_local(torch.empty(0, 7), solo_mesh, [Shard(0)])
    env = tb.pack_array(x)
    assert env == jb.pack_array(np.empty((0, 7), np.float32))
    with pytest.raises(tb.InvalidDataError):
        tb.compress_array(x)
    y = tb.unpack_array(env, sharding=(solo_mesh, [Shard(1)]))
    assert isinstance(y, DTensor) and tuple(y.shape) == (0, 7)
    assert tuple(y.to_local().shape) == (0, 7) and y.placements == (Shard(1),)


def test_a_fortran_envelope_unpacks_to_the_span(solo_mesh):
    """tpu_blosc's Fortran-ordered envelope (decoded on the host first):
    the local tensor is C-contiguous and the global stride C order."""
    from torch.distributed.tensor import Shard

    f = np.asfortranarray(np.arange(12 * 50, dtype=np.int32).reshape(12, 50))
    y = tb.unpack_array(jb.pack_array(f), sharding=(solo_mesh, [Shard(1)]))
    assert np.array_equal(y.to_local().numpy(), f) and y.to_local().is_contiguous()
    assert y.stride() == (50, 1)


def test_a_dictionary_record_is_placed_after_its_host_decode(solo_mesh, tmp_path):
    pytest.importorskip("zstandard")
    from torch.distributed.tensor import DTensor, Shard

    rng = np.random.default_rng(3)
    items = [rng.integers(0, 4, 512, dtype=np.uint8) * 3 for _ in range(8)]
    with tb.StreamWriter(tmp_path / "d.tpbs", train_dict=8) as w:
        for item in items:
            w.write(item)
    with tb.StreamReader(tmp_path / "d.tpbs") as r:
        assert r.read_frame(0)[:4] == b"TPBD"
        y = r.read_array(2, torch.uint8, shape=(16, 32), sharding=(solo_mesh, [Shard(0)]))
        got = list(r.iter_arrays(torch.uint8, sharding=(solo_mesh, [Shard(0)])))
    assert isinstance(y, DTensor) and np.array_equal(y.to_local().numpy(),
                                                     items[2].reshape(16, 32))
    assert [g.to_local().numpy().tobytes() for g in got] == [i.tobytes() for i in items]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int16,
                                   torch.complex64, torch.bool])
def test_gather_full_of_one_rank_is_the_local_tensor(solo_mesh, dtype):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    full = torch.arange(60).reshape(6, 10).to(dtype)
    for placements in ([Shard(0)], [Shard(1)], [Replicate()]):
        x = DTensor.from_local(full, solo_mesh, placements)
        got = _sharded.gather_full(x)
        assert got.dtype == dtype and got.equal(full)
        back = _sharded.place(got, (solo_mesh, placements))
        assert back.to_local().equal(full) and back.placements == tuple(placements)


@pytest.mark.parametrize("shape, mesh_shape, spec, coord, span", [
    ((10, 7), (3,), [("S", 0)], (2,), [[8, 10], [0, 7]]),
    ((2, 5), (3,), [("S", 0)], (2,), [[2, 2], [0, 5]]),
    ((9, 1), (2, 2), [("S", 0), ("S", 0)], (1, 1), [[7, 9], [0, 1]]),
    ((6, 5), (2, 2), [("R"), ("S", 0)], (1, 1), [[3, 6], [0, 5]]),
    ((4, 6), (2, 2), [("S", 0), ("S", 1)], (1, 0), [[2, 4], [0, 3]]),
])
def test_span_at_any_coordinate(shape, mesh_shape, spec, coord, span):
    """Each rank's span without a collective: torch.chunk's split, what the
    mesh dimensions before it left of a dimension sharded twice."""
    assert _sharded.span_at(shape, mesh_shape, sw.placements_of(spec), coord) == span
