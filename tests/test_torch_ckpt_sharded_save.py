"""The benchmark's sharded training-state save (cell ``nemotron-3-nano-fsdp4.save``), on the CPU.

At the published widths the generator ``benchmark/data/nemotron_3_nano_train.py``
is counted from the configuration alone, without allocating: 54
parameter tensors of 1,510,737,216 values, and at 4 ranks 162 shards and
3,021,474,432 bytes a rank.  At small widths
(``tests/torch_sharded_save_worker.py``) four Gloo processes, spawned
once, save their shards with ``save_pytree_sharded`` through the
pipeline CUDA leaves take; the plain reference
``benchmark/reference/sharded_train_state_file.py`` and
``load_pytree_sharded`` put every leaf back together from the four files,
byte for byte the full state, and each rank's trace holds the save's
spans on its calling thread.  The loop ``benchmark/loops/save_sharded.py``
runs a fixed number of saves over four Gloo ranks, the check is correct,
its control and each planted fault read not correct, and no rank's
process outlives it, whichever way it ends.  One case needs two CUDA
devices and skips without them: two ranks on two cards save, and neither
process holds a context on the other's card.
"""

from __future__ import annotations

import gc
import json
import math
import os

import pytest
import torch
import torch.distributed as dist

import torch_dist_worker as worker
import torch_sharded_save_worker as save_worker
from benchmark import harness
from benchmark import trace as bench_trace
from tpu_blosc_torch import api, checkpoint

pytestmark = pytest.mark.skipif(
    not (dist.is_available() and dist.is_gloo_available()),
    reason="torch.distributed with the Gloo backend is not available",
)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_sharded_save_worker.py")
WORLD = 4
CPU = torch.device("cpu")
SEED = save_worker.SEED
TOP = "tpbt.save_pytree_sharded"
STAGES = ("tpbt.save_pytree_sharded.manifest", "tpbt.save_pytree.wait",
          "tpbt.save_pytree.codec", "tpbt.save_pytree.write")
SPAN_METRICS = ["sharded_save_self_ms", "sharded_save_wait_ms", "sharded_save_codec_ms",
                "sharded_save_write_ms"]


def _published():
    cell = harness.load_cell(save_worker.CELL)
    return cell, save_worker.generator(cell)


def test_the_generator_gives_the_published_shards_without_allocating():
    cell, gen = _published()
    cfg = cell.config
    assert gen.layer_kinds(cfg) == ["mamba", "moe", "mamba", "moe", "mamba", "attention", "moe"]
    params = gen.parameter_shapes(cfg)
    assert len(params) == 54 and sum(math.prod(s) for s in params.values()) == 1_510_737_216
    assert params["backbone.embeddings.weight"] == (131072, 2688)
    assert params["backbone.layers.0.mixer.in_proj.weight"] == (10304, 2688)
    assert params["backbone.layers.0.mixer.conv1d.weight"] == (6144, 1, 4)
    assert params["backbone.layers.2.mixer.dt_bias"] == (64,)
    assert params["backbone.layers.4.mixer.out_proj.weight"] == (2688, 4096)
    assert params["backbone.layers.1.mixer.experts.up_proj"] == (32, 1856, 2688)
    assert params["backbone.layers.6.mixer.experts.down_proj"] == (32, 2688, 1856)
    assert params["backbone.layers.3.mixer.gate.weight"] == (128, 2688)  # the published router
    assert params["backbone.layers.3.mixer.shared_experts.up_proj.weight"] == (3712, 2688)
    assert params["backbone.layers.5.mixer.q_proj.weight"] == (4096, 2688)
    assert params["backbone.layers.5.mixer.k_proj.weight"] == (256, 2688)
    state = gen.shapes(cfg)
    tensors = [t for g in ("master", "exp_avg", "exp_avg_sq") for t in state[g].values()]
    assert all(t.device.type == "meta" for t in tensors) and len(tensors) == 162
    assert state["step"] == 1000 and state["rng"].shape == (2,)
    specs = gen.leaf_specs(cfg)
    assert all(s[0] % WORLD == 0 for _, _, s, _ in specs)
    for rank in range(WORLD):
        sizes = []
        for _, _, shape, dtype in specs:
            a, b = gen.rows(shape[0], WORLD, rank)
            sizes.append((b - a) * math.prod(shape[1:]) * dtype.itemsize)
        assert len(sizes) == 162 and sum(sizes) == 3_021_474_432
        assert sum(n > api.AUTO_BLOCK_THRESHOLD for n in sizes) == 63
        assert max(sizes) == 352_321_536 and min(sizes) == 32
    total = gen.state_bytes(cfg)
    assert total == 4 * 3_021_474_432 + 16 == 12_085_897_744
    assert total == cell.traffic["tensor_bytes"] == cfg["published_size_bytes"]


def test_the_configuration_keeps_every_published_key():
    cell, _ = _published()
    cfg = cell.config
    assert cfg["reduced"] == ["num_hidden_layers", "n_routed_experts"]
    assert (cfg["num_hidden_layers"], cfg["n_routed_experts"]) == (7, 32)
    assert (cfg["n_routed_experts_published"], cfg["expert_parallel"], cfg["shard_ranks"],
            cfg["pipeline_layers"]) == (128, 16, 4, 7)
    assert cfg["hybrid_override_pattern"].startswith("MEMEM*E")
    assert len(cfg["hybrid_override_pattern"]) == 52
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    (entry,) = [c for c in bench["configs"] if c["name"] == cfg["name"]]
    assert entry["source"] == cfg["source"] and entry["reduced"] == cfg["reduced"]
    (cell_entry,) = [w for w in bench["workloads"] if w["name"] == save_worker.CELL]
    assert cell_entry["chips"] == 4


def test_a_shard_is_drawn_from_the_seed_the_leaf_and_the_rank():
    cell = save_worker.small_cell()
    gen, cfg = save_worker.generator(cell), cell.config
    a = gen.local_state(SEED, 1, WORLD, CPU, cfg)
    b = gen.local_state(SEED, 1, WORLD, CPU, cfg)
    other_rank = gen.local_state(SEED, 2, WORLD, CPU, cfg)
    other_seed = gen.local_state(SEED + 1, 1, WORLD, CPU, cfg)
    for leaf, (group, name, shape, dtype) in enumerate(gen.leaf_specs(cfg)):
        got = a[group][name]
        assert got.dtype == dtype and got.shape == (shape[0] // WORLD, *shape[1:])
        assert torch.equal(got, b[group][name])
        assert torch.equal(got, gen.draw(SEED, leaf, 1, WORLD, CPU, cfg))
        if got.numel() > 4:
            assert not torch.equal(got, other_rank[group][name])
            assert not torch.equal(got, other_seed[group][name])
    m = a["master"]
    assert abs(float(m["backbone.embeddings.weight"].std()) - 0.02) < 2e-3
    assert abs(float(m["backbone.layers.0.norm.weight"].mean()) - 1) < 0.05
    a_log = m["backbone.layers.0.mixer.A_log"]
    assert float(a_log.min()) >= 0 and float(a_log.max()) <= math.log(16)
    dt = torch.nn.functional.softplus(m["backbone.layers.0.mixer.dt_bias"])
    assert float(dt.min()) >= cfg["time_step_min"] * 0.999
    assert float(dt.max()) <= cfg["time_step_max"] * 1.001
    assert float(a["exp_avg_sq"]["backbone.layers.1.mixer.experts.up_proj"].min()) >= 0
    assert a["rng"].tolist() == [SEED, SEED + 1] and a["step"] == 1000
    with pytest.raises(ValueError):
        gen.make(cell.traffic["tensor_bytes"] + 2, SEED, CPU, cfg, None)


# ---------------------------------------------------- the program, four ranks


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    return worker.group_cache(tmp_path_factory, WORKER, "sharded_save")


@pytest.fixture(scope="module")
def saved(spawned):
    """(the directory of the four files, each rank's record)."""
    out = spawned(WORLD)
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return out, ranks


def _full(gen, cfg, leaf: int) -> torch.Tensor:
    return torch.cat([gen.draw(SEED, leaf, r, WORLD, CPU, cfg) for r in range(WORLD)])


def _u8(t: torch.Tensor):
    return t.contiguous().view(-1).view(torch.uint8).numpy()


def test_the_reference_puts_every_leaf_back_from_its_shards(saved):
    out, _ = saved
    cell = save_worker.small_cell()
    gen, cfg = save_worker.generator(cell), cell.config
    ref = cell.module("reference", cfg["reference"]["module"])
    # a budget that holds every record: each one decoded
    reading = ref.read(os.path.join(out, "state"), WORLD, SEED, 1, "SHUFFLE",
                       2 * cell.traffic["tensor_bytes"])
    specs = gen.leaf_specs(cfg)
    assert reading["values"] == {"step": 1000}
    assert reading["leaves"]["rng"] == ("int64", (2,))
    assert reading["decoded"][("rng", 0)].tobytes() == \
        torch.tensor([SEED, SEED + 1]).numpy().tobytes()
    assert len(reading["decoded"]) == WORLD * len(specs) + 1
    for leaf, (group, name, shape, dtype) in enumerate(specs):
        path = f"{group}/{name}"
        assert reading["leaves"][path] == (str(dtype).removeprefix("torch."), shape)
        size = dtype.itemsize
        whole = torch.zeros((*shape, size), dtype=torch.uint8)
        for p, spans in reading["spans"][path].items():
            (span,) = spans
            assert span[0] == list(gen.rows(shape[0], WORLD, p))
            whole[tuple(slice(a, b) for a, b in span)] = torch.from_numpy(
                reading["decoded"][(path, p)]).view(*(b - a for a, b in span), size)
        assert whole.view(-1).numpy().tobytes() == _u8(_full(gen, cfg, leaf)).tobytes(), path
    (path,) = reading["whole"]
    leaf = [f"{g}/{n}" for g, n, _, _ in specs].index(path)
    assert reading["whole"][path].tobytes() == _u8(_full(gen, cfg, leaf)).tobytes()
    assert set(reading["kinds"]) == set(cfg["reference"]["kinds"])


def test_load_pytree_sharded_gives_the_full_state(saved):
    out, _ = saved
    cell = save_worker.small_cell()
    gen, cfg = save_worker.generator(cell), cell.config
    got = checkpoint.load_pytree_sharded(os.path.join(out, "state"), WORLD)
    assert got["step"] == 1000 and got["rng"].tolist() == [SEED, SEED + 1]
    for leaf, (group, name, shape, dtype) in enumerate(gen.leaf_specs(cfg)):
        t = got[group][name]
        assert t.dtype == dtype and tuple(t.shape) == shape
        assert _u8(t).tobytes() == _u8(_full(gen, cfg, leaf)).tobytes()


def test_a_drawn_sample_covers_every_kind_and_matches(saved):
    out, _ = saved
    cell = save_worker.small_cell()
    gen, cfg = save_worker.generator(cell), cell.config
    reading = cell.reference()(os.path.join(out, "state"), SEED + 5)
    assert set(reading["kinds"]) == set(cfg["reference"]["kinds"])
    assert reading["kinds"]["multi_block/float32"] == "master/backbone.embeddings.weight"
    index = {f"{g}/{n}": leaf for leaf, (g, n, _, _) in enumerate(gen.leaf_specs(cfg))}
    assert sum(v.size for v in reading["decoded"].values()) >= cfg["reference"]["sample_bytes"]
    for (path, p), got in reading["decoded"].items():
        if path != "rng":
            assert got.tobytes() == _u8(gen.draw(SEED, index[path], p, WORLD, CPU, cfg)).tobytes()


def _marks(events) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("tpbt.")]


def _events(rank_record) -> list:
    with open(rank_record["trace_file"]) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.parametrize("rank", range(WORLD))
def test_each_rank_records_the_save_on_its_calling_thread(saved, rank):
    _, ranks = saved
    marks = _marks(_events(ranks[rank]))
    names = [e["name"] for e in marks]
    records = 162 + (rank == 0)  # process 0 also writes the rng pair
    assert names.count(TOP) == names.count("tpbt.save_pytree_sharded.manifest") == 1
    assert names.count("tpbt.save_pytree.wait") == records
    # a device record's stage 2: a single-block shard's frame came whole
    # from stage 1, and its codec span is still recorded
    assert names.count("tpbt.save_pytree.codec") == records
    # a hand-off a record, the manifest's too, and the drain at the end
    assert names.count("tpbt.save_pytree.write") == records + 2
    assert {n for n in names if not n.startswith("tpbt.compress")} == {TOP, *STAGES}
    (top,) = [e for e in marks if e["name"] == TOP]
    stages = [e for e in marks if e["name"] in STAGES]
    assert all(e["tid"] == top["tid"] and e["ts"] >= top["ts"]
               and e["ts"] + e["dur"] <= top["ts"] + top["dur"] + 2e-3 for e in stages)


@pytest.mark.parametrize("rank", range(WORLD))
def test_the_counters_count_each_ranks_shards(saved, rank):
    _, ranks = saved
    cell = save_worker.small_cell()
    gen = save_worker.generator(cell)
    nbytes = 0
    for _, _, shape, dtype in gen.leaf_specs(cell.config):
        a, b = gen.rows(shape[0], WORLD, rank)
        nbytes += (b - a) * math.prod(shape[1:]) * dtype.itemsize
    got = ranks[rank]["saved"]
    assert got["shard_records"] == 162
    assert got["leaves"] == got["device_leaves"] == 162 + (rank == 0)
    assert got["bytes"] == nbytes + 16 * (rank == 0)
    # the embedding's shards, fp32 and both bf16 moments, pass 4 MiB
    assert got["multi_block_leaves"] == 3
    assert got["write_stalls"] == 0 and got["writer_ns"] > 0


def _metric(name):
    return harness.load_cell(save_worker.CELL).module("metrics", name)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_the_metrics_read_the_spans_of_a_real_trace(saved, name):
    """Each reader gives the spans' own time on rank 0's trace, and None
    on the same trace without the program's spans."""
    _, ranks = saved
    events = _events(ranks[0])
    got = _metric(name).read(bench_trace.parse(events), {})
    marks = _marks(events)

    def covered(stage):
        return sum(b - a for a, b in bench_trace.merged(
            [(e["ts"], e["ts"] + e["dur"]) for e in marks if e["name"] == stage])) / 1e3

    top = next(e["dur"] for e in marks if e["name"] == TOP) / 1e3
    inner = bench_trace.merged([(e["ts"], e["ts"] + e["dur"]) for e in marks
                                if e["name"] in STAGES])
    want = {"sharded_save_wait_ms": covered("tpbt.save_pytree.wait"),
            "sharded_save_codec_ms": covered("tpbt.save_pytree.codec"),
            "sharded_save_write_ms": covered("tpbt.save_pytree.write"),
            "sharded_save_self_ms": top - sum(b - a for a, b in inner) / 1e3}[name]
    assert got == pytest.approx(want, abs=5e-3) and got >= 0
    bare = [e for e in events if not e.get("name", "").startswith("tpbt.")]
    assert _metric(name).read(bench_trace.parse(bare), {}) is None


def _x(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def test_the_skew_reader_takes_the_barrier_a_save():
    read = _metric("sharded_save_skew_ms").read
    events = [_x("bench.save_sharded", 0, 1000), _x("bench.save_sharded.barrier", 900, 100),
              _x("bench.save_sharded", 2000, 1000), _x("bench.save_sharded.barrier", 2700, 300)]
    assert read(bench_trace.parse(events), {}) == pytest.approx(0.2)
    assert read(bench_trace.parse(events[::2]), {}) is None


# ---------------------------------------------------------------- the loop


@pytest.fixture
def one_thread(monkeypatch):
    """Ranks 1-3 with one OpenMP thread each: on a small host four ranks'
    spinning thread pools make a small save take seconds."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _loop_cell(check_sample: int = 1):
    cell = save_worker.small_cell()
    cell.config["options"]["num_threads"] = 1
    cell.traffic.update(check_sample=check_sample, group_timeout_s=120)
    return cell


def _loop(cell, seed=SEED):
    return cell.module("loops", "save_sharded").Loop(cell, seed, CPU)


def _ended(loop) -> bool:
    return len(loop.procs) == WORLD - 1 and all(p.poll() is not None for p in loop.procs)


@pytest.fixture
def loops():
    """The loops a test makes; their ranks' processes and the group are
    gone after it, whatever it did."""
    made = []
    yield made
    for loop in made:
        loop._cleanup()
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("seed", [7, 2**31 + 7])
def test_a_clean_run_is_correct_and_ends_its_ranks(one_thread, loops, seed):
    cell = _loop_cell()
    loop = _loop(cell, seed)
    loops.append(loop)
    loop.warm(2)
    rec = loop.traced(3)
    assert rec["round_trips"] == 3 and rec["tensor_bytes"] == cell.traffic["tensor_bytes"]
    assert len(rec["ops"]["encode"]) == 3 and rec["ops"]["decode"] == []
    assert sorted(os.listdir(loop.dir)) == sorted(
        [f"{s}.p{p}.tpbs" for s in ("state", "sample0") for p in range(WORLD)]
        + [f"rank{r}.log" for r in range(1, WORLD)])
    checks, judged = loop.check(cell.reference())
    assert all(v <= lim for v, lim in checks.values()), checks
    assert judged["sampled"] == 2 and judged["bad"] == 0 and judged["frames_read"] > 0
    assert loop.attempted == 3 and loop.raised == 0
    assert _ended(loop) and not os.path.exists(loop.dir) and not dist.is_initialized()
    assert loop.cards == {r: [] for r in range(WORLD)}
    assert all(len(loop.rank_times[r]) == 5 for r in range(WORLD))


@pytest.mark.parametrize("fault", ["control", "stale_file", "swapped_files", "dropped_shard",
                                   "unshuffled_shard"])
def test_the_control_and_every_fault_are_not_correct(one_thread, loops, fault):
    cell = _loop_cell(check_sample=0)
    mod = cell.module("loops", "save_sharded")
    out = harness.execute(cell, SEED, 0.0, False, CPU, 0.0,
                          (mod.CONTROL if fault == "control" else mod.FAULTS[fault],))
    assert not out["correct"], out["checks"]
    checks = {k: v for k, (v, _) in out["checks"].items()}
    assert checks["state_bad_bytes"] == 0 and checks["failed_calls"] == 0
    # the set a file left from an earlier save or two files swapped make
    # is one the reference refuses; load_pytree_sharded reads the first
    # whole (the other ranks' manifests are never read) and refuses the
    # second only where the swap moves process 0's replicated leaf
    if fault in ("stale_file", "swapped_files", "dropped_shard", "control"):
        assert checks["frame_bad_bytes"] > 0
    if fault in ("dropped_shard", "unshuffled_shard", "control"):
        assert checks["decoded_bad_bytes"] > 0


def test_a_rank_that_raises_fails_its_saves_and_ends_with_the_check(one_thread, loops):
    cell = _loop_cell(check_sample=0)
    loop = _loop(cell)
    loops.append(loop)
    loop.variant = "no-such-variant"  # every rank's save raises KeyError
    loop.warm(1)
    rec = loop.traced(2)
    assert rec["round_trips"] == 0 and loop.raised == 3 and "KeyError" in loop.first_error
    checks, _ = loop.check(cell.reference())
    assert checks["failed_calls"] == (3, 0)
    assert _ended(loop) and not os.path.exists(loop.dir)


def test_a_killed_rank_fails_the_run_and_leaves_no_process(one_thread, loops):
    cell = _loop_cell(check_sample=0)
    loop = _loop(cell)
    loops.append(loop)
    loop.warm(1)
    loop.procs[1].kill()
    rec = loop.traced(3)
    # the first save finds rank 2 gone, and no save is tried after it
    assert rec["round_trips"] == 0 and loop.attempted == 1 and loop.raised == 1
    assert "rank 2's process ended" in loop.first_error
    checks, _ = loop.check(cell.reference())
    assert checks["failed_calls"][0] > 0
    assert _ended(loop) and not os.path.exists(loop.dir) and not dist.is_initialized()


def test_a_loop_dropped_without_a_check_ends_its_ranks(one_thread, loops):
    loop = _loop(_loop_cell(check_sample=0))
    procs, directory = loop.procs, loop.dir
    del loop
    gc.collect()
    assert all(p.poll() is not None for p in procs) and not os.path.exists(directory)


# ------------------------------------------------------------- on the cards


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("fewer than two CUDA devices: a rank a card needs two")
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def test_cuda_ranks_save_on_their_own_cards_only(two_cards, loops):
    """Two ranks, rank r on cuda:r under NCCL, save their shards through
    the loop; the set is correct, and each rank's process holds a CUDA
    context on its own card alone (its stage-1 worker and writer threads
    included)."""
    # at two ranks the embedding's fp32 shard is 17.8 MB: a sample of
    # 40 MiB may hold it, so every kind is covered
    cell = save_worker.small_cell(sample_bytes=40 << 20)
    cell.config["shard_ranks"] = 2
    cell.traffic.update(check_sample=1, group_timeout_s=300)
    loop = cell.module("loops", "save_sharded").Loop(cell, SEED, two_cards)
    loops.append(loop)
    loop.warm(2)
    assert loop.traced(2)["round_trips"] == 2
    checks, judged = loop.check(cell.reference())
    assert all(v <= lim for v, lim in checks.values()), checks
    assert judged == {"sampled": 2, "bad": 0, "frames_read": judged["frames_read"]}
    assert loop.cards == {0: [0], 1: [1]}
