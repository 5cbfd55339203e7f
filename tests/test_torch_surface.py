"""The port's quick-start surface against the JAX package's, on the CPU.

``import tpu_blosc_torch as blosc; blosc.compress(data, blosc.LZ4, 5,
blosc.SHUFFLE, 4)`` must work as tpu_blosc's quick-start does
(tpu_blosc/__init__.py:11-16): compress and compress_batch give
tpu_blosc's frames byte for byte and each package decodes the other's,
the constants and aliases are equal, the in-place buffer filters give the
same bytes, and the port exports every name tpu_blosc exports.  Every
public function, class and method of tpu_blosc.__all__ and of the modules
the packages share takes the same parameter names in the port, but for
the differences ALLOWED and ABSENT list with their reasons.  Every
comparison is exact.
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc.codecs
import tpu_blosc_torch as tb

# names of tpu_blosc.__all__ whose modules the port does not have yet:
# none since stats.py and the codec registry were ported
QUEUED: set = set()

CODECS = ["LZ4", "LZ4HC", "ZSTD", "ZLIB", "BLOSCLZ", "SNAPPY"]
SHUFFLES = ["NOSHUFFLE", "SHUFFLE", "BITSHUFFLE"]


def _data(n: int, seed: int) -> bytes:
    """n bytes: a float32 random walk (compressible once shuffled), cut."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.integers(-3, 4, n // 4 + 1)).astype(np.float32)
    return walk.tobytes()[:n]


def test_the_quick_start_round_trips_and_equals_tpu_blosc():
    data = b"x" * 4096
    frame = tb.compress(data, tb.LZ4, 5, tb.SHUFFLE, 4)
    assert tb.decompress(frame) == data
    assert frame == jb.compress(data, jb.LZ4, 5, jb.SHUFFLE, 4)
    assert tb.compress(data) == jb.compress(data) == tb.compress_with_options(
        data, tb.default_options())


@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("n,type_size", [(1, 4), (4099, 4), (100_000, 8), (5 << 20, 2)])
def test_compress_equals_tpu_blosc(codec, shuffle, n, type_size):
    """Single-block frames, one with a ragged tail, and a multi-block one
    (above AUTO_BLOCK_THRESHOLD); level 11 is clamped to 9 by both."""
    data = _data(n, seed=n + type_size)
    level = 11 if n == 4099 else 5
    mine = tb.compress(data, tb.Codec[codec], level, tb.Shuffle[shuffle], type_size)
    theirs = jb.compress(data, jb.Codec[codec], level, jb.Shuffle[shuffle], type_size)
    assert mine == theirs
    assert jb.decompress(mine) == data
    assert tb.decompress(theirs) == data


@pytest.mark.parametrize("item", ["bytearray", "memoryview", "ndarray"])
def test_compress_takes_what_tpu_blosc_takes(item):
    arr = np.frombuffer(_data(40_000, 3), dtype=np.float32)
    data = {"bytearray": bytearray(arr.tobytes()), "memoryview": memoryview(arr.tobytes()),
            "ndarray": arr}[item]
    assert tb.compress(data, tb.ZSTD, 3, tb.BITSHUFFLE, 4) == jb.compress(
        data, jb.ZSTD, 3, jb.BITSHUFFLE, 4)


def test_compress_refuses_empty_input_as_tpu_blosc_does():
    with pytest.raises(tb.InvalidDataError):
        tb.compress(b"")
    with pytest.raises(jb.InvalidDataError):
        jb.compress(b"")
    with pytest.raises(tb.InvalidDataError, match="batch item 1"):
        tb.compress_batch([b"abcd", b""])


@pytest.mark.parametrize("codec,shuffle,type_size", [
    ("LZ4", "SHUFFLE", 4), ("ZSTD", "BITSHUFFLE", 8), ("LZ4HC", "NOSHUFFLE", 1),
    ("ZLIB", "SHUFFLE", 2),
])
def test_compress_batch_equals_tpu_blosc(codec, shuffle, type_size):
    """Small items, an ndarray, and one above AUTO_BLOCK_THRESHOLD: the
    frames of tpu_blosc.compress_batch and of compress, item by item."""
    items = [_data(n, seed=n) for n in (7, 1000, 65_536, 100_003)]
    items.append(np.frombuffer(_data(80_000, 9), dtype=np.float64))
    items.append(_data((4 << 20) + 4096, seed=1))
    args = (tb.Codec[codec], 5, tb.Shuffle[shuffle], type_size)
    mine = tb.compress_batch(items, *args)
    theirs = jb.compress_batch(items, jb.Codec[codec], 5, jb.Shuffle[shuffle], type_size)
    assert mine == theirs
    assert mine == [tb.compress(x, *args) for x in items]
    raw = [x.tobytes() if isinstance(x, np.ndarray) else x for x in items]
    assert tb.decompress_batch(theirs) == raw
    assert jb.decompress_batch(mine) == raw
    assert tb.compress_batch([], *args) == []


def test_constants_and_aliases_equal_tpu_blosc():
    for name in ("VERSION", "__version__", "FORMAT_VERSION", "HEADER_SIZE", "MIN_HEADER_SIZE",
                 "FLAG_SHUFFLE", "FLAG_MEMCPY", "FLAG_BITSHUFFLE", "FLAG_SPLIT",
                 "AUTO_BLOCK_THRESHOLD"):
        assert getattr(tb, name) == getattr(jb, name), name
    for name in CODECS:
        assert getattr(tb, name) is tb.Codec[name]
        assert int(getattr(tb, name)) == int(getattr(jb, name))
    for name in SHUFFLES:
        assert getattr(tb, name) is tb.Shuffle[name]
        assert int(getattr(tb, name)) == int(getattr(jb, name))
    mine, theirs = tb.default_options(), jb.default_options()
    assert isinstance(mine, tb.Options)
    for field in ("codec", "level", "shuffle", "type_size", "block_size", "num_threads"):
        assert getattr(mine, field) == getattr(theirs, field), field


def test_header_and_parse_header_equal_tpu_blosc():
    frame = tb.compress(_data(10_000, 5), tb.ZSTD, 7, tb.BITSHUFFLE, 8)
    mine, theirs = tb.parse_header(frame), jb.parse_header(frame)
    assert isinstance(mine, tb.Header) and mine == tb.get_info(frame)
    for field in ("version", "version_lz", "flags", "type_size", "nbytes_orig", "block_size",
                  "nbytes_comp"):
        assert getattr(mine, field) == getattr(theirs, field), field
    assert mine.flags & tb.FLAG_BITSHUFFLE and not mine.flags & tb.FLAG_SPLIT
    assert mine.to_bytes() == theirs.to_bytes() == frame[: tb.HEADER_SIZE]


@pytest.mark.parametrize("kind", ["bytearray", "ndarray"])
@pytest.mark.parametrize("mode", SHUFFLES)
@pytest.mark.parametrize("n,type_size", [(4096, 4), (1003, 8), (37, 2), (64, 1)])
def test_buffer_filters_equal_tpu_blosc(n, type_size, mode, kind):
    """shuffle_buffer and unshuffle_buffer change a bytearray or a uint8
    array in place, to tpu_blosc's bytes, and undo each other; NOSHUFFLE
    leaves the buffer as it is."""
    raw = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    make = (lambda: bytearray(raw.tobytes())) if kind == "bytearray" else raw.copy
    mine, theirs = make(), make()
    assert tb.shuffle_buffer(mine, type_size, tb.Shuffle[mode]) is None
    jb.shuffle_buffer(theirs, type_size, jb.Shuffle[mode])
    assert bytes(mine) == bytes(theirs)
    if mode == "NOSHUFFLE":
        assert bytes(mine) == raw.tobytes()
    else:
        whole = {"SHUFFLE": tb.shuffle_bytes, "BITSHUFFLE": tb.bit_shuffle}[mode]
        assert bytes(mine) == whole(raw, type_size).tobytes()
    tb.unshuffle_buffer(mine, type_size, tb.Shuffle[mode])
    jb.unshuffle_buffer(theirs, type_size, jb.Shuffle[mode])
    assert bytes(mine) == bytes(theirs) == raw.tobytes()


@pytest.mark.parametrize("name", ["shuffle_bytes", "unshuffle_bytes", "bit_shuffle",
                                  "bit_unshuffle"])
def test_whole_buffer_filters_are_exported_and_equal_tpu_blosc(name):
    raw = np.random.default_rng(8).integers(0, 256, 8 * 4 * 33 + 5, dtype=np.uint8)
    assert np.array_equal(getattr(tb, name)(raw, 4), getattr(jb, name)(raw, 4))


def test_the_names_still_missing_are_exactly_the_queued_modules():
    assert set(jb.__all__) - set(tb.__all__) == QUEUED
    for name in tb.__all__:
        assert hasattr(tb, name), name
    assert len(set(tb.__all__)) == len(tb.__all__)


# ---------------------------------------------------------------------------
# parameters: every public callable of the shared modules
# ---------------------------------------------------------------------------

SHARED_MODULES = ["api", "array", "stream", "checkpoint", "device", "container", "stats",
                  "chunk", "format", "options", "dist.mesh", "dist.multihost", "filters",
                  *(f"codecs.{m.name}" for m in pkgutil.iter_modules(tpu_blosc.codecs.__path__))]

_SHARDING = ("the port decodes onto a torch device: device= stands beside sharding= (a "
             "(DeviceMesh, placements) pair), where the JAX package takes a jax sharding alone")
_GROUP = ("dist/ runs over a torch.distributed process group, one device a rank: group= and "
          "device= stand where the JAX package takes a jax Mesh")

#: (module, qualified name) -> (parameters the port adds, parameters it lacks, why);
#: module "" is the package's top level
ALLOWED = {
    **{(mod, name): ({"device"}, set(), _SHARDING) for mod, name in [
        ("device", "decompress_array"), ("", "decompress_array"),
        ("stream", "StreamReader.read_array"), ("stream", "StreamReader.iter_arrays"),
        ("stream", "load_array"), ("", "load_array"), ("", "StreamReader.read_array"),
        ("", "StreamReader.iter_arrays")]},
    **{("dist.mesh", name): ({"group", "device"}, {"mesh"}, _GROUP) for name in [
        "compress_chunked_mesh", "decompress_chunked_mesh", "filter_blocks_sharded",
        "unfilter_blocks_sharded"]},
    ("dist.mesh", "initialize_distributed"): ({"device"}, set(), _GROUP),
    **{("dist.multihost", name): ({"group"}, set(), _GROUP) for name in [
        "allgather_payloads", "compress_chunked_multihost", "decompress_chunked_multihost"]},
}

#: (module, name) -> why the port has no such callable
ABSENT = {
    ("dist.mesh", "block_mesh"): "a jax Mesh of the local devices; a torch rank has one device",
    ("filters", "device_eligible"): ("the host-buffer device dispatch is not carried over: "
                                     "host buffers are filtered on the host, where no nvcc "
                                     "is needed"),
    ("api", "parse_block_table_checked"): "internal; the port's chunk.parse_block_table checks",
    ("chunk", "split_blocks"): "internal; the port's callers slice the buffer in place",
    ("filters", "apply_filter"): "internal; the port's filters.filter_bytes does its work",
    ("filters", "remove_filter"): "internal; the port's filters.unfilter_bytes does its work",
}


def _params(obj):
    try:
        return list(inspect.signature(obj).parameters)
    except (TypeError, ValueError):  # a builtin without a signature
        return None


def _public(module) -> list:
    """Public names a module defines (a package: its __all__)."""
    if hasattr(module, "__all__"):
        return list(module.__all__)
    return [n for n, v in vars(module).items()
            if not n.startswith("_") and getattr(v, "__module__", None) == module.__name__]


def signatures(package) -> dict:
    """(module, qualified name) -> parameter names of each public function
    and class (its constructor, and each public method) that tpu_blosc's
    module defines, looked up by the same name in ``package``'s module."""
    out = {}
    for mod in ["", *SHARED_MODULES]:
        suffix = f".{mod}" if mod else ""
        jmod = importlib.import_module("tpu_blosc" + suffix)
        home = importlib.import_module(package.__name__ + suffix)
        for name in _public(jmod):
            jobj, obj = getattr(jmod, name), getattr(home, name, None)
            if not callable(jobj) or obj is None:
                continue
            out[mod, name] = _params(obj)
            if inspect.isclass(jobj):
                for mname, member in vars(jobj).items():
                    if (not mname.startswith("_") and inspect.isfunction(member)
                            and hasattr(obj, mname)):
                        out[mod, f"{name}.{mname}"] = _params(getattr(obj, mname))
    return out


def differences(ref: dict, port: dict, allowed: dict = ALLOWED, absent: dict = ABSENT) -> list:
    """Every difference between the two packages' parameters that the
    allow-lists do not name, and every allow-list entry with no
    difference behind it."""
    out = []
    for key, params in ref.items():
        if key in absent:
            if key in port:
                out.append(f"{key}: listed as absent, but the port has it")
            continue
        if key not in port:
            out.append(f"{key}: absent from the port")
            continue
        adds, lacks, _ = allowed.get(key, (set(), set(), ""))
        mine = port[key]
        if params is None or mine is None:
            if params != mine:
                out.append(f"{key}: {params} against the port's {mine}")
            continue
        if key in allowed and not (set(mine) - set(params) == adds
                                   and set(params) - set(mine) == lacks):
            out.append(f"{key}: the allow-list says +{adds} -{lacks}, the port has {mine} "
                       f"against {params}")
        elif [p for p in mine if p not in adds] != [p for p in params if p not in lacks]:
            out.append(f"{key}: {params} against the port's {mine}")
    for key in set(allowed) | set(absent):
        if key not in ref:
            out.append(f"{key}: an allow-list entry for a name tpu_blosc does not have")
    return out


@pytest.fixture(scope="module")
def both_signatures():
    return signatures(jb), signatures(tb)


def test_every_public_callable_takes_tpu_blosc_s_parameters(both_signatures):
    """The parameter names of every public function, class and method of
    tpu_blosc.__all__ and of the modules the packages share, in order,
    against the port's; the allow-lists hold the deliberate differences
    and the reason for each."""
    ref, port = both_signatures
    assert len(ref) > 150
    assert differences(ref, port) == []
    assert all(reason for *_, reason in ALLOWED.values()) and all(ABSENT.values())


@pytest.mark.parametrize("key, edit", [
    (("device", "decompress_array"), lambda p: p.remove("sharding")),
    (("array", "unpack_array"), lambda p: p.remove("sharding")),
    (("stream", "StreamReader.iter_arrays"), lambda p: p.remove("sharding")),
    (("stream", "load_array"), lambda p: p.insert(0, "extra")),
    (("api", "compress"), lambda p: p.reverse()),
    (("dist.mesh", "compress_chunked_mesh"), lambda p: p.remove("group")),
    (("options", "Options"), lambda p: p.pop()),
])
def test_the_parity_check_fails_on_any_other_difference(both_signatures, key, edit):
    """A copy of the port's signatures with one parameter deleted, added or
    moved: the check names that callable."""
    ref, port = both_signatures
    mutated = {k: list(v) if v is not None else None for k, v in port.items()}
    edit(mutated[key])
    found = differences(ref, mutated)
    assert len(found) == 1 and found[0].startswith(str(key))


def test_the_parity_check_fails_on_a_missing_callable_and_a_stale_entry(both_signatures):
    ref, port = both_signatures
    mutated = dict(port)
    del mutated[("stream", "save_array")]
    assert differences(ref, mutated) == [f"{('stream', 'save_array')}: absent from the port"]
    stale = {**ALLOWED, ("api", "compress"): ({"device"}, set(), "none")}
    assert len(differences(ref, port, allowed=stale)) == 1
