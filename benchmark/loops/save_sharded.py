"""Saves of a training state sharded over the ranks of one node, every rank at once, in a closed loop.

Rank 0 is the benchmark's own process.  Set-up starts ranks 1 to n-1 as
processes of their own (this file run as a script, rank r on ``cuda:r``,
or on the CPU for a CPU device), forms the default process group over a
TCP store on this host (NCCL for CUDA, Gloo for the CPU) with the
traffic's ``group_timeout_s``, and each rank makes its shards of the
configuration's state on its device from the seed (its data generator,
DTensors with ``Shard(0)`` over a one-dimensional mesh of the n ranks)
and keeps a copy of them on the device that the program never sees.

One save: rank 0 tells every rank to save, and each rank calls
``tpu_blosc_torch.checkpoint.save_pytree_sharded(prefix, state, opts)`` then
synchronises its device, what every rank of a training job does at a
checkpoint while it waits.  The save ends when the last rank has
returned; the next starts then.  The state's ``step`` is the
configuration's plus the save's number, as a job's step advances between
checkpoints.  Every save truncates and rewrites each rank's file in a
temporary directory that the run removes at its end.  The window's record
counts saves as ``round_trips`` and all ranks' tensor bytes as
``tensor_bytes``, for ``tensor_gbps``; each save's time is in
``ops["encode"]`` (``ops["decode"]`` is empty).  Traced (``traced``),
each save is a ``bench.save_sharded`` span on rank 0, and inside it
``bench.save_sharded.barrier`` wraps rank 0's wait for the other ranks
once its own save has returned: how long the slowest rank outlasts rank
0.  Only rank 0 records.

A rank that raises in a save fails that save; a rank whose process ends,
or that does not answer within the group's timeout, fails the save and
every save after it.  The processes of ranks 1 to n-1 end with the
check, with rank 0's process (they are killed when it dies), or, where
the loop is dropped without a check, when it is collected or the
interpreter exits.

The check samples ``check_sample`` saves of the window from the seed, as
``save.py`` does, a set of the ranks' files at a time: a sampled set
trades places with the set its slot held, so every save truncates each
rank's file of a whole save and none pays for an unlink.  After the
window it holds

- (a) each rank's live state to its kept copy, byte for byte: the saves
  did not touch their input;
- (b) ``load_pytree_sharded`` of every set on disk, read on rank 0, to
  the full state, each rank's shards drawn again on rank 0's device:
  every leaf with its dtype and global shape, the step of the save that
  wrote the set, and the rng pair;
- (c) the plain reference's reading of the same sets (every file's
  layout, manifest and record headers, the spans' tiling, a seed-drawn
  sample of decoded shard records, which must cover each kind of record
  the configuration's reference names) to the same state.

``CONTROL`` and ``FAULTS`` at the end are this loop's control and planted
faults, in ``controls.py``'s form ``(loop, stack)``: each names a variant
of the save that the ranks run.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import datetime
import importlib.util
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
import weakref

import torch

NO_SPAN = contextlib.nullcontext()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
BARRIER = "bench.save_sharded.barrier"
# seconds between two looks at the store while rank 0 waits for the ranks
POLL_S = 0.002


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(config: dict):
    """The configuration's data generator, ``benchmark/data/<name>.py``."""
    name = config["data"]["generator"]
    return _module(os.path.join(ROOT, "benchmark", "data", name + ".py"),
                   f"benchmark_save_sharded_data_{name}")


def cards_in_use() -> list:
    """The CUDA devices on which this process holds a primary context, as
    libcuda's ``cuDevicePrimaryCtxGetState`` reports it (asking makes
    none)."""
    if not torch.cuda.is_available():
        return []
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return []
    found = []
    for i in range(torch.cuda.device_count()):
        dev, flags, active = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
        if (cuda.cuDeviceGet(ctypes.byref(dev), i) == 0
                and cuda.cuDevicePrimaryCtxGetState(dev, ctypes.byref(flags),
                                                    ctypes.byref(active)) == 0
                and active.value):
            found.append(i)
    return found


def _files(prefix: str, world: int) -> list:
    return [f"{prefix}.p{p}.tpbs" for p in range(world)]


class RankError(RuntimeError):
    """A rank failed a save, or can no longer save."""


class Rank:
    """One rank's part of the loop: its shards on its device, their kept
    copy, and its saves."""

    def __init__(self, setup: dict, rank: int, world: int, device: torch.device, mesh):
        import tpu_blosc_torch as tbt

        self.cfg, self.rank, self.world, self.device = setup["config"], rank, world, device
        o = self.cfg["options"]
        self.opts = tbt.Options(codec=tbt.Codec[o["codec"]], level=o["level"],
                                shuffle=tbt.Shuffle[o["shuffle"]], block_size=o["block_size"],
                                num_threads=o["num_threads"])
        self.state = generator(self.cfg).make(setup["tensor_bytes"], setup["seed"], device,
                                              self.cfg, mesh)
        self.kept = {p: t.clone() for p, t in self.locals(self.state).items()}

    @staticmethod
    def locals(state: dict) -> dict:
        """{path: this rank's tensor} of a state: each DTensor's local
        shard, and the rng pair."""
        out = {}
        for group, value in state.items():
            if isinstance(value, dict):
                out.update({f"{group}/{n}": d.to_local() for n, d in value.items()})
            elif isinstance(value, torch.Tensor):
                out[group] = value
        return out

    def save(self, prefix: str, number: int, variant: str) -> float:
        """Save number ``number`` under ``variant`` (``VARIANTS``; "" the
        plain save): its seconds."""
        from tpu_blosc_torch import checkpoint

        tree = {**self.state, "step": self.cfg["step"] + number}
        after = None
        if variant:
            tree, prefix, after = VARIANTS[variant](self, tree, prefix)
        t0 = time.perf_counter()
        checkpoint.save_pytree_sharded(prefix, tree, self.opts)
        _sync(self.device)
        seconds = time.perf_counter() - t0
        if after is not None:
            after()
        return seconds

    def state_bad(self) -> int:
        """Bytes of the kept copy that the live state no longer holds."""
        live = self.locals(self.state)
        return sum(int((_bytes(live[p]) != _bytes(t)).sum()) for p, t in self.kept.items())

    def release(self) -> None:
        self.state = self.kept = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _form(store, rank: int, world: int, device: torch.device, timeout: float):
    """Join the default process group over ``store`` and return the
    ranks' one-dimensional device mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.PrefixStore("group", store), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    return init_device_mesh(device.type, (world,))


def _end(procs: list, directory: str) -> None:
    """Stop the rank processes still running and remove the directory."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
    for proc in procs:
        with contextlib.suppress(subprocess.TimeoutExpired):
            proc.wait(timeout=30)
    shutil.rmtree(directory, ignore_errors=True)


class Loop:
    """The sharded save loop of one cell: the state from the
    configuration's data generator and the seed over its ``shard_ranks``
    ranks, options from the configuration, sizes and the group's timeout
    from the traffic file."""

    def __init__(self, cell, seed: int, device: torch.device):
        import torch.distributed as dist

        from tpu_blosc_torch import checkpoint

        self.cell, self.device, self.seed = cell, device, seed
        cfg, traffic = cell.config, cell.traffic
        self.world = cfg["shard_ranks"]
        self.nbytes = traffic["tensor_bytes"]
        self.timeout = traffic["group_timeout_s"]
        self.gen = generator(cfg)
        self.dir = tempfile.mkdtemp(prefix="bench_save_sharded_")
        self.prefix = os.path.join(self.dir, "state")
        self.k = traffic["check_sample"]
        self.sample = [os.path.join(self.dir, f"sample{i}") for i in range(self.k)]
        self.rng = random.Random(seed)
        self.seen = 0  # saves of the window so far
        # the save whose files each set of the directory holds, by prefix
        self.written: dict = {}
        self.saves = 0  # saves started, the next save's number
        self.commands = 0
        self.me = None  # rank 0's part, once the group has formed
        self.lost = ""  # why the ranks can save no more
        self.attempted = 0
        self.raised = 0
        self.first_error = ""
        self.frame_bytes = None
        self.rank_times = {r: [] for r in range(self.world)}
        self.variant = ""  # the save's variant, which controls and faults set
        self.cards: dict = {}  # {rank: CUDA devices it held a context on}, by the check
        self.load = checkpoint.load_pytree_sharded
        self.store = dist.TCPStore("127.0.0.1", 0, self.world, True,
                                   timeout=datetime.timedelta(seconds=self.timeout),
                                   wait_for_workers=False)
        self.store.set("setup", json.dumps({"config": cfg, "tensor_bytes": self.nbytes,
                                            "seed": seed}))
        self.procs = []
        self._cleanup = weakref.finalize(self, _end, self.procs, self.dir)
        for r in range(1, self.world):
            with open(os.path.join(self.dir, f"rank{r}.log"), "wb") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank", str(r),
                     "--world", str(self.world), "--port", str(self.store.port),
                     "--timeout", str(self.timeout), "--parent", str(os.getpid()),
                     "--device", device.type],
                    stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL, stderr=log))

    def _log(self, r: int) -> str:
        with contextlib.suppress(OSError), open(os.path.join(self.dir, f"rank{r}.log"),
                                                errors="replace") as f:
            return f.read()[-3000:]
        return ""

    def _wait(self, keys: list) -> list:
        """The values of ``keys`` in the store once every one is set;
        RankError once a rank's process has ended first or the group's
        timeout has passed."""
        deadline = time.monotonic() + self.timeout
        while not self.store.check(keys):
            ended = [r for r, proc in enumerate(self.procs, 1) if proc.poll() is not None]
            if ended:
                r = ended[0]
                raise RankError(f"rank {r}'s process ended (exit code "
                                f"{self.procs[r - 1].returncode}):\n{self._log(r)}")
            if time.monotonic() > deadline:
                raise RankError(f"the ranks did not answer within {self.timeout} s")
            time.sleep(POLL_S)
        return [json.loads(self.store.get(k)) for k in keys]

    def _command(self, cmd: dict) -> list:
        """Send ``cmd`` to ranks 1 to n-1; the keys of their answers."""
        n = self.commands
        self.commands += 1
        self.store.set(f"cmd/{n}", json.dumps(cmd))
        return [f"done/{n}/{r}" for r in range(1, self.world)]

    def _fail(self, why: str) -> None:
        self.raised += 1
        self.first_error = self.first_error or why

    def _start(self) -> None:
        """Form the group and make rank 0's state; every rank answers
        once its state is made."""
        try:
            self._wait([f"hello/{r}" for r in range(1, self.world)])
            mesh = _form(self.store, 0, self.world, self.device, self.timeout)
            self.me = Rank({"config": self.cell.config, "tensor_bytes": self.nbytes,
                            "seed": self.seed}, 0, self.world, self.device, mesh)
            errors = [a["error"] for a in self._wait([f"ready/{r}"
                                                      for r in range(1, self.world)])]
        except Exception:
            errors = [traceback.format_exc()]
        if any(errors):
            self.lost = next(e for e in errors if e)
            self._fail(self.lost)

    def _save(self, traced: bool = False) -> float:
        """One save on every rank: its seconds, from the command to the
        last rank's return."""
        if self.lost:
            raise RankError(self.lost)
        number = self.saves
        self.saves += 1
        t0 = time.perf_counter()
        keys = self._command({"op": "save", "prefix": self.prefix, "number": number,
                              "variant": self.variant})
        errors = []
        try:
            self.rank_times[0].append(self.me.save(self.prefix, number, self.variant))
        except Exception:
            errors.append(traceback.format_exc())
        if traced:
            from torch.profiler import record_function

            barrier = record_function(BARRIER)
        else:
            barrier = NO_SPAN
        try:
            with barrier:
                answers = self._wait(keys)
        except RankError as err:
            self.lost = str(err)
            raise
        seconds = time.perf_counter() - t0
        for r, a in enumerate(answers, 1):
            if a["error"]:
                errors.append(f"rank {r}:\n{a['error']}")
            else:
                self.rank_times[r].append(a["seconds"])
        if errors:
            raise RankError(errors[0])
        self.written[self.prefix] = number
        return seconds

    def _move(self, src: str, dst: str) -> None:
        """Rename the set at ``src`` to ``dst``, file by file (a file a
        fault left out stays missing)."""
        for a, b in zip(_files(src, self.world), _files(dst, self.world)):
            if os.path.exists(a):
                os.rename(a, b)
        self.written[dst] = self.written.pop(src)

    def _keep(self) -> None:
        """Reservoir sampling of the saves of the window: the set just
        written goes aside where the draw keeps it, and the set its slot
        held takes its place, for the next save to truncate."""
        slot = self.seen if self.seen < self.k else self.rng.randrange(self.seen + 1)
        if slot < self.k:
            kept = self.sample[slot]
            if kept in self.written:
                spare = os.path.join(self.dir, "spare")
                self._move(kept, spare)
                self._move(self.prefix, kept)
                self._move(spare, self.prefix)
            else:
                self._move(self.prefix, kept)
        self.seen += 1

    def _set_bytes(self) -> int:
        return sum(os.path.getsize(f) for f in _files(self.prefix, self.world)
                   if os.path.exists(f))

    def warm(self, rounds: int) -> None:
        """Set-up: the group and the states, then ``rounds`` saves; each
        but the last fills an empty slot of the sample with its set.  A
        save that fails is counted as in the window."""
        self._start()
        for r in range(rounds):
            if self.lost:
                break
            try:
                self._save()
            except Exception:
                self._fail(traceback.format_exc())
                continue
            self.frame_bytes = self._set_bytes()
            empty = [p for p in self.sample if p not in self.written]
            if r < rounds - 1 and empty:
                self._move(self.prefix, empty[0])
        _sync(self.device)

    def _run(self, stop, traced: bool = False) -> dict:
        """Saves until ``stop(seconds so far, saves so far)``, or until the
        ranks can save no more."""
        times = []
        t_begin = time.perf_counter()
        t_end = t_begin
        attempts = 0
        if traced:
            from torch.profiler import record_function

            span = lambda: record_function("bench.save_sharded")  # noqa: E731
        else:
            span = lambda: NO_SPAN  # noqa: E731
        while not self.lost and not stop(t_end - t_begin, attempts):
            attempts += 1
            self.attempted += 1
            try:
                with span():
                    seconds = self._save(traced)
            except Exception:  # an answer that never comes: counted, and the loop goes on
                self._fail(traceback.format_exc())
                t_end = time.perf_counter()
                continue
            t_end = time.perf_counter()
            times.append(seconds)
            self.frame_bytes = self._set_bytes()
            self._keep()
        return {"ops": {"encode": times, "decode": []}, "round_trips": len(times),
                "window_s": t_end - t_begin, "tensor_bytes": self.nbytes}

    def window(self, seconds: float) -> dict:
        """The timed window: saves until ``seconds`` have passed (the last
        one started before then runs to its end)."""
        return self._run(lambda elapsed, _: elapsed >= seconds)

    def traced(self, count: int) -> dict:
        """``count`` saves, each in a ``record_function`` span
        ("bench.save_sharded") holding the barrier's span."""
        return self._run(lambda _, attempts: attempts >= count, traced=True)

    def _stop(self) -> tuple[int, dict]:
        """Ask the ranks for (a) and their cards, then end their
        processes and the group: (bytes of the live states that differ
        from the kept copies, {rank: CUDA devices it holds a context on})."""
        import torch.distributed as dist

        bad, cards = 0, {}
        try:
            if self.me is not None:
                bad, cards[0] = self.me.state_bad(), cards_in_use()
            if self.me is not None and not self.lost:
                answers = self._wait(self._command({"op": "check"}))
                bad += sum(a["state_bad"] for a in answers)
                cards.update({r: a["cards"] for r, a in enumerate(answers, 1)})
            self._command({"op": "stop"})
            deadline = time.monotonic() + 30
            for proc in self.procs:
                with contextlib.suppress(subprocess.TimeoutExpired):
                    proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except RankError as err:
            self._fail(str(err))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return bad, cards

    def _expected(self) -> dict:
        """{path: (dtype name, global shape)} of the state's tensor
        leaves."""
        want = {f"{g}/{n}": (_dtype_name(d), tuple(s))
                for g, n, s, d in self.gen.leaf_specs(self.cell.config)}
        want["rng"] = ("int64", (2,))
        return want

    def _shard(self, leaf: int, rank: int) -> torch.Tensor:
        return self.gen.draw(self.seed, leaf, rank, self.world, self.device, self.cell.config)

    def _rng(self) -> torch.Tensor:
        return torch.tensor([self.seed, self.seed + 1], dtype=torch.int64)

    def _wrong(self, got, number: int) -> int:
        """Bytes of the state of save ``number`` that the tree ``got`` (CPU
        tensors) does not hold: a leaf of another dtype or shape, or
        missing, counts all its bytes; another value counts 1."""
        cfg = self.cell.config
        have = {}
        for group, value in (got.items() if isinstance(got, dict) else ()):
            if isinstance(value, dict):
                have.update({f"{group}/{n}": t for n, t in value.items()})
            else:
                have[group] = value
        want = self._expected()
        wrong = sum(1 for p in have if p not in want and p != "step")
        wrong += have.get("step") != cfg["step"] + number
        rng = have.get("rng")
        wrong += 16 if not isinstance(rng, torch.Tensor) or not torch.equal(rng, self._rng()) \
            else 0
        for leaf, (group, name, shape, dtype) in enumerate(self.gen.leaf_specs(cfg)):
            t = have.get(f"{group}/{name}")
            if (not isinstance(t, torch.Tensor) or t.dtype != dtype
                    or tuple(t.shape) != tuple(shape)):
                wrong += dtype.itemsize * int(torch.Size(shape).numel())
                continue
            for r in range(self.world):
                a, b = self.gen.rows(shape[0], self.world, r)
                piece = t[a:b].to(self.device)
                wrong += int((_bytes(piece) != _bytes(self._shard(leaf, r))).sum())
        return wrong

    def _file_wrong(self, reading: dict, number: int) -> int:
        """Bytes of the state of save ``number`` that the reference's
        reading of a set does not hold: the manifests' leaves, values and
        spans, and the decoded records' bytes."""
        cfg = self.cell.config
        specs = self.gen.leaf_specs(cfg)
        index = {f"{g}/{n}": leaf for leaf, (g, n, _, _) in enumerate(specs)}
        want = self._expected()
        wrong = sum(1 for p in reading["leaves"] if p not in want)
        wrong += reading["values"] != {"step": cfg["step"] + number}
        for p, (dtype, shape) in want.items():
            n = getattr(torch, dtype).itemsize * int(torch.Size(shape).numel())
            if reading["leaves"].get(p) != (dtype, shape):
                wrong += n
            elif p in index and reading["spans"].get(p) != {
                    r: [[list(self.gen.rows(shape[0], self.world, r))]
                        + [[0, d] for d in shape[1:]]] for r in range(self.world)}:
                wrong += n
        for (p, r), got in reading["decoded"].items():
            want_t = self._rng() if p == "rng" else self._shard(index[p], r) if p in index \
                else None
            wrong += self._differ(got, want_t)
        for p, got in reading["whole"].items():
            full = torch.cat([self._shard(index[p], r) for r in range(self.world)]) \
                if p in index else None
            wrong += self._differ(got, full)
        return wrong

    def _differ(self, got, want) -> int:
        """Bytes of ``want`` (None: nothing was to be read) that the
        uint8 array ``got`` does not hold."""
        if want is None:
            return got.size
        w = _bytes(want).cpu()
        if got.size != w.numel():
            return w.numel()
        return int((torch.from_numpy(got) != w).sum())

    def check(self, reference) -> tuple[dict, dict]:
        """Judge the live states and end the ranks' processes, then, with
        rank 0's state released, every set on disk (the last save's and
        the sampled ones) by ``load_pytree_sharded`` and by the plain
        reference, against the state each set's save held.
        ``reference`` is the configuration's reference, ``reference(prefix,
        seed)`` (ValueError for a set it cannot read).  Returns the
        numbers compared, {name: (value, limit)}, and {"sampled": sets
        judged, "bad": those with a wrong byte, "frames_read": shard
        records the reference decoded}."""
        state_bad, self.cards = self._stop()
        for r in range(self.world):
            t = sorted(self.rank_times[r])
            print(f"rank {r}: save_pytree_sharded over {len(t)} saves, s min "
                  f"{t[0] if t else 0:.4f} median {t[len(t) // 2] if t else 0:.4f} max "
                  f"{t[-1] if t else 0:.4f}; CUDA contexts on cards {self.cards.get(r)}")
        if self.me is not None:
            self.me.release()
        sets = [p for p in [self.prefix, *self.sample] if p in self.written]
        want_kinds = self.cell.config["reference"]["kinds"]
        decoded, frames, uncovered, frames_read = [], [], [], 0
        for i, prefix in enumerate(sets):
            number = self.written[prefix]
            try:
                got = self.load(prefix, self.world)
                decoded.append(self._wrong(got, number))
                del got
            except Exception:
                decoded.append(self.nbytes)
                self.first_error = self.first_error or traceback.format_exc()
            try:
                reading = reference(prefix, self.seed + i)
                frames.append(self._file_wrong(reading, number))
                frames_read += len(reading["decoded"])
                uncovered.append(sum(k not in reading["kinds"] for k in want_kinds))
            except (OSError, ValueError):
                frames.append(self.nbytes)
                uncovered.append(len(want_kinds))
                self.first_error = self.first_error or traceback.format_exc()
        self.load = None
        self._cleanup()
        return ({"state_bad_bytes": (state_bad, 0),
                 "decoded_bad_bytes": (max(decoded, default=self.nbytes), 0),
                 "frame_bad_bytes": (max(frames, default=self.nbytes), 0),
                 "uncovered_kinds": (max(uncovered, default=len(want_kinds)), 0),
                 "failed_calls": (self.raised, 0)},
                {"sampled": len(sets),
                 "bad": sum(bool(d or f) for d, f in zip(decoded, frames)),
                 "frames_read": frames_read})


# ---------------------------------------------------------------------------
# the variants of a save that the control and the faults set: each takes
# (rank, tree, prefix) and gives what that rank saves, where, and what it
# does once its save has returned (or None)
# ---------------------------------------------------------------------------


def _with_local(d, local: torch.Tensor):
    """The DTensor ``d`` with ``local`` as its local shard."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, d.device_mesh, d.placements, run_check=False,
                              shape=d.shape, stride=d.stride())


def _groups(tree: dict, fn) -> dict:
    """``tree`` with ``fn(name, DTensor)`` in place of each sharded leaf
    (a leaf where it gives None is left out)."""
    out = dict(tree)
    for group, value in tree.items():
        if isinstance(value, dict):
            out[group] = {n: v for n, v in ((n, fn(n, d)) for n, d in value.items())
                          if v is not None}
    return out


def _lower_precision(me: Rank, tree: dict, prefix: str):
    """Every rank saves each shard of a dtype that ``control_dtypes``
    names cast to the next precision below and back, what a lossy
    checkpoint would write."""
    lows = {getattr(torch, k): getattr(torch, v) for k, v in me.cfg["control_dtypes"].items()}

    def cast(_, d):
        local = d.to_local()
        return _with_local(d, local.to(lows[local.dtype]).to(local.dtype)) \
            if local.dtype in lows else d

    return _groups(tree, cast), prefix, None


def _stale_file(me: Rank, tree: dict, prefix: str):
    """Rank 1 writes its file elsewhere while one is at its path: the set
    holds rank 1's file of an earlier save."""
    if me.rank == 1 and os.path.exists(_files(prefix, me.world)[1]):
        prefix += ".elsewhere"
    return tree, prefix, None


def _swapped_files(me: Rank, tree: dict, prefix: str):
    """Ranks 1 and 2 each put their file at the other's path."""
    if me.rank not in (1, 2):
        return tree, prefix, None
    own = f"{prefix}.swap.p{me.rank}.tpbs"
    other = _files(prefix, me.world)[3 - me.rank]
    return tree, prefix + ".swap", lambda: os.rename(own, other)


def _dropped_shard(me: Rank, tree: dict, prefix: str):
    """The last rank leaves its shard of the smallest floating-point leaf
    out of its save."""
    if me.rank != me.world - 1:
        return tree, prefix, None
    flat = {(g, n): d for g, v in tree.items() if isinstance(v, dict) for n, d in v.items()}
    smallest = min(flat, key=lambda k: (flat[k].to_local().nbytes, k))
    return _groups(tree, lambda n, d: None if d is flat[smallest] else d), prefix, None


def _unshuffled(t: torch.Tensor, bs: int) -> torch.Tensor:
    """``t``'s bytes unshuffled block by block at block size ``bs`` (and
    the tail as the codec filters a tail)."""
    ts = t.element_size()
    b = _bytes(t).clone()
    body = b.numel() // bs * bs
    b[:body] = b[:body].view(-1, ts, bs // ts).transpose(1, 2).reshape(-1)
    m = (b.numel() - body) // ts
    b[body:body + m * ts] = b[body:body + m * ts].view(ts, m).t().reshape(-1)
    return b.view(t.dtype).view(t.shape)


def _unshuffled_shard(me: Rank, tree: dict, prefix: str):
    """Rank 2 writes its shard of the largest bfloat16 leaf unshuffled
    under the shuffle flag: the shard's bytes unshuffled block by block,
    at the block size the program chooses for them, are saved in its
    place, so the record's payload holds them as they are and a reader
    that unshuffles gets other bytes."""
    from tpu_blosc_torch.chunk import choose_block_size

    if me.rank != 2:
        return tree, prefix, None
    flat = {(g, n): d for g, v in tree.items() if isinstance(v, dict) for n, d in v.items()
            if d.dtype == torch.bfloat16}
    largest = max(flat, key=lambda k: (flat[k].to_local().nbytes, k))
    d = flat[largest]
    local = d.to_local()
    bs = choose_block_size(local.nbytes, local.element_size(), me.opts.block_size)
    changed = _with_local(d, _unshuffled(local, bs))
    return _groups(tree, lambda n, x: changed if x is d else x), prefix, None


VARIANTS = {"lower_precision": _lower_precision, "stale_file": _stale_file,
            "swapped_files": _swapped_files, "dropped_shard": _dropped_shard,
            "unshuffled_shard": _unshuffled_shard}


def _variant(name: str):
    def apply(loop, stack) -> None:
        loop.variant = name

    apply.__name__ = name
    apply.__doc__ = VARIANTS[name].__doc__
    return apply


CONTROL = _variant("lower_precision")
FAULTS = {name: _variant(name) for name in VARIANTS if name != "lower_precision"}


# ---------------------------------------------------------------------------
# ranks 1 to n-1: this file run as a script by the loop
# ---------------------------------------------------------------------------


def _die_with(parent: int) -> None:
    """Have the kernel kill this process when the loop's process ends."""
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(1)


def rank_main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one rank of benchmark/loops/save_sharded.py")
    for name in ("--rank", "--world", "--port", "--parent"):
        p.add_argument(name, type=int, required=True)
    p.add_argument("--timeout", type=float, required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), required=True)
    args = p.parse_args(argv)
    _die_with(args.parent)
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    device = torch.device(args.device, args.rank) if args.device == "cuda" \
        else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.TCPStore("127.0.0.1", args.port, args.world, False,
                          timeout=datetime.timedelta(seconds=args.timeout))
    store.set(f"hello/{args.rank}", str(os.getpid()))
    try:
        setup = json.loads(store.get("setup"))
        mesh = _form(store, args.rank, args.world, device, args.timeout)
        me = Rank(setup, args.rank, args.world, device, mesh)
    except Exception:
        store.set(f"ready/{args.rank}", json.dumps({"error": traceback.format_exc()}))
        raise
    store.set(f"ready/{args.rank}", json.dumps({"error": ""}))
    n = 0
    while True:
        cmd = json.loads(store.get(f"cmd/{n}"))
        if cmd["op"] == "stop":
            break
        if cmd["op"] == "save":
            try:
                answer = {"error": "", "seconds": me.save(cmd["prefix"], cmd["number"],
                                                          cmd["variant"])}
            except Exception:
                answer = {"error": traceback.format_exc()}
        else:  # "check"
            answer = {"state_bad": me.state_bad(), "cards": cards_in_use()}
            me.release()
        store.set(f"done/{n}/{args.rank}", json.dumps(answer))
        n += 1
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
