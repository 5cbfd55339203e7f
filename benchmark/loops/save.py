"""Saves of one training state from the device through the port, in a closed loop.

Set-up makes the configuration's state on the device from the seed (its
data generator) and keeps a copy of it on the device that the program
never sees.  One save is ``tpu_blosc_torch.save_pytree(path, state,
opts)`` then a synchronise: what a training job does at a checkpoint,
while it waits.  One caller; the next save starts when the last returns.
Every save truncates and rewrites one file in a temporary directory that
the run removes at its end.  The window's record counts saves as
``round_trips`` and the state's tensor bytes as ``tensor_bytes``, for
``tensor_gbps``; each save's time is in ``ops["encode"]``
(``ops["decode"]`` is empty: nothing is read back in the window).

The check samples ``check_sample`` saves of the window from the seed
(reservoir sampling): a sampled save's file is renamed aside, so at most
``check_sample`` + 1 files are on disk.  A sampled file trades places with
the file its slot held (three renames, none over a file), and set-up's
first save fills the slots, so every save of the window truncates a file
of a whole save and none pays for unlinking one: on a filesystem where a
truncate and an unlink of gigabytes cost seconds, and not the same, the
seed's draws would otherwise change the window's length.  After the
window it holds

- (a) the live state to the kept copy, byte for byte: the saves did not
  touch their input;
- (b) ``load_pytree(path, device=True)`` (on a CPU device, that device)
  of every file on disk (the last save's, or where the last save was
  drawn the file its slot held, and every sampled one) to the kept
  state: every leaf with its dtype, shape and device;
- (c) the plain reference's reading of the same files (the layout, the
  manifest, every record's header and a seed-drawn sample of decoded
  records, which must cover each kind of leaf record the configuration's
  reference names) to the kept state.

``CONTROL`` and ``FAULTS`` at the end are this loop's control and planted
faults, in ``controls.py``'s form ``(loop, stack)``.
"""

from __future__ import annotations

import contextlib
import os
import random
import shutil
import tempfile
import time
import traceback
import weakref

import torch

NO_SPAN = contextlib.nullcontext()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def leaves(tree, path: str = "") -> dict:
    """{path: leaf} of a state, keys and list positions joined by "/"."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(k), v) for k, v in enumerate(tree))
    else:
        return {path: tree}
    out = {}
    for key, value in items:
        out.update(leaves(value, f"{path}/{key}" if path else key))
    return out


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


def _worst(values: list, none):
    """The largest of the files' readings; ``none`` where no file was
    there to judge, an answer that never came."""
    return max(values) if values else none


def _replace(tree, path: str, leaf):
    """A copy of the dicts of ``tree`` along ``path`` with the leaf there
    replaced by ``leaf``, or taken out where ``leaf`` is None."""
    key, _, rest = path.partition("/")
    out = dict(tree)
    if rest:
        out[key] = _replace(tree[key], rest, leaf)
    elif leaf is None:
        del out[key]
    else:
        out[key] = leaf
    return out


class Loop:
    """The save loop of one cell: the state from the configuration's data
    generator and the seed, options from the configuration, sizes from
    the traffic file."""

    def __init__(self, cell, seed: int, device: torch.device):
        import tpu_blosc_torch as tbt

        self.cell, self.device, self.seed = cell, device, seed
        cfg, traffic = cell.config, cell.traffic
        o = cfg["options"]
        self.opts = tbt.Options(codec=tbt.Codec[o["codec"]], level=o["level"],
                                shuffle=tbt.Shuffle[o["shuffle"]], block_size=o["block_size"],
                                num_threads=o["num_threads"])
        self.nbytes = traffic["tensor_bytes"]
        make = cell.module("data", cfg["data"]["generator"]).make
        self.state = make(self.nbytes, seed, device, cfg)
        self.kept = {p: v.clone() if isinstance(v, torch.Tensor) else v
                     for p, v in leaves(self.state).items()}
        self.dir = tempfile.mkdtemp(prefix="bench_save_")
        self._cleanup = weakref.finalize(self, shutil.rmtree, self.dir, ignore_errors=True)
        self.path = os.path.join(self.dir, "state.tpbs")
        # the calls the timed path makes; controls and fault tests put
        # others in their place
        self.save = tbt.save_pytree
        self.load = tbt.load_pytree
        self.k = traffic["check_sample"]
        self.rng = random.Random(seed)
        # the files of the sample's slots; a slot holds a set-up save's
        # file until a save of the window is drawn into it
        self.sample = [os.path.join(self.dir, f"sample{i}.tpbs") for i in range(self.k)]
        self.seen = 0  # saves of the window so far
        self.attempted = 0
        self.raised = 0
        self.first_error = ""
        self.frame_bytes = None

    def _save(self, span=NO_SPAN) -> float:
        """One save: its seconds."""
        t0 = time.perf_counter()
        with span:
            self.save(self.path, self.state, self.opts)
            _sync(self.device)
        return time.perf_counter() - t0

    def warm(self, rounds: int) -> None:
        """Set-up: ``rounds`` saves; each but the last fills an empty slot
        of the sample with its file.  A save that raises is counted as in
        the window."""
        for r in range(rounds):
            try:
                self._save()
                self.frame_bytes = os.path.getsize(self.path)
            except Exception:
                self.raised += 1
                self.first_error = self.first_error or traceback.format_exc()
                continue
            empty = [p for p in self.sample if not os.path.exists(p)]
            if r < rounds - 1 and empty:
                os.rename(self.path, empty[0])
        _sync(self.device)

    def _keep(self) -> None:
        """Reservoir sampling of the saves of the window: the file just
        written goes aside where the draw keeps it, and the file its slot
        held takes its place, for the next save to truncate."""
        slot = self.seen if self.seen < self.k else self.rng.randrange(self.seen + 1)
        if slot < self.k:
            kept = self.sample[slot]
            if os.path.exists(kept):
                spare = os.path.join(self.dir, "spare.tpbs")
                os.rename(kept, spare)
                os.rename(self.path, kept)
                os.rename(spare, self.path)
            else:
                os.rename(self.path, kept)
        self.seen += 1

    def _run(self, stop, span=None) -> dict:
        """Saves until ``stop(seconds so far, saves so far)``."""
        times = []
        t_begin = time.perf_counter()
        t_end = t_begin
        attempts = 0
        while not stop(t_end - t_begin, attempts):
            attempts += 1
            self.attempted += 1
            try:
                seconds = self._save(span() if span else NO_SPAN)
            except Exception:  # an answer that never comes: counted, and the loop goes on
                self.raised += 1
                self.first_error = self.first_error or traceback.format_exc()
                t_end = time.perf_counter()
                continue
            t_end = time.perf_counter()
            times.append(seconds)
            self.frame_bytes = os.path.getsize(self.path)
            self._keep()
        return {"ops": {"encode": times, "decode": []}, "round_trips": len(times),
                "window_s": t_end - t_begin, "tensor_bytes": self.nbytes}

    def window(self, seconds: float) -> dict:
        """The timed window: saves until ``seconds`` have passed (the last
        one started before then runs to its end)."""
        return self._run(lambda elapsed, _: elapsed >= seconds)

    def traced(self, count: int) -> dict:
        """``count`` saves, each in a ``record_function`` span
        ("bench.save")."""
        from torch.profiler import record_function

        return self._run(lambda _, attempts: attempts >= count,
                         lambda: record_function("bench.save"))

    def _wrong(self, got) -> int:
        """Bytes of the kept state that the tree ``got`` does not hold: a
        tensor leaf of another dtype, shape or device, or missing, counts
        all its bytes; another value counts 1."""
        have_all = leaves(got)
        wrong = sum(1 for p in have_all if p not in self.kept)
        for p, want in self.kept.items():
            have = have_all.get(p)
            if not isinstance(want, torch.Tensor):
                wrong += isinstance(have, torch.Tensor) or have != want
            elif (not isinstance(have, torch.Tensor) or have.dtype != want.dtype
                  or have.shape != want.shape or have.device != want.device):
                wrong += want.nbytes
            else:
                wrong += int((_bytes(have) != _bytes(want)).sum())
        return wrong

    def _file_wrong(self, reading) -> int:
        """Bytes of the kept state that the reference's reading of a file
        does not hold: the manifest's leaves and values, and the decoded
        records' bytes."""
        wrong = sum(1 for p in set(reading["leaves"]) | set(reading["values"])
                    if p not in self.kept)
        for p, want in self.kept.items():
            if not isinstance(want, torch.Tensor):
                wrong += p not in reading["values"] or reading["values"][p] != want
                continue
            n = want.nbytes
            dtype, shape = reading["leaves"].get(p, (None, None))
            if dtype != str(want.dtype).removeprefix("torch.") or shape != tuple(want.shape):
                wrong += n
            elif p in reading["decoded"]:
                got = reading["decoded"][p]
                wrong += n if got.size != n else int(
                    (torch.from_numpy(got) != _bytes(want).cpu()).sum())
        return wrong

    def check(self, reference) -> tuple[dict, dict]:
        """Judge the live state, then, with it released, the file at the
        save's path and the sampled files, by ``load_pytree`` and by the plain reference,
        against the kept state.  ``reference`` is the configuration's
        reference, ``reference(path, seed)`` (ValueError for a file it
        cannot read).  Returns the numbers compared, {name: (value,
        limit)}, and {"sampled": files judged, "bad": those with a wrong
        byte, "frames_read": leaf records the reference decoded}."""
        state_bad = self._wrong(self.state)
        self.state = None
        self.save = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        files = ([self.path] if os.path.exists(self.path) else []) + [
            p for p in self.sample if os.path.exists(p)]
        target = True if self.device.type == "cuda" else self.device
        want_kinds = self.cell.config["reference"]["kinds"]
        decoded, frames, uncovered, frames_read = [], [], [], 0
        for i, path in enumerate(files):
            try:
                got = self.load(path, device=target)
                decoded.append(self._wrong(got))
                del got
            except Exception:
                decoded.append(self.nbytes)
                self.first_error = self.first_error or traceback.format_exc()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            try:
                reading = reference(path, self.seed + i)
                frames.append(self._file_wrong(reading))
                frames_read += len(reading["decoded"])
                uncovered.append(sum(reading["kinds"].get(k) not in reading["decoded"]
                                     for k in want_kinds))
            except (OSError, ValueError):
                frames.append(self.nbytes)
                uncovered.append(len(want_kinds))
        self.load = None
        self.kept = None
        self._cleanup()
        return ({"state_bad_bytes": (state_bad, 0),
                 "decoded_bad_bytes": (_worst(decoded, self.nbytes), 0),
                 "frame_bad_bytes": (_worst(frames, self.nbytes), 0),
                 "uncovered_kinds": (_worst(uncovered, len(want_kinds)), 0),
                 "failed_calls": (self.raised, 0)},
                {"sampled": len(files), "bad": sum(bool(d or f) for d, f in zip(decoded, frames)),
                 "frames_read": frames_read})


def lower_precision(loop, stack) -> None:
    """The control: the configuration states a lossless save; the control
    saves every leaf of a dtype that ``control_dtypes`` names cast to the
    next precision below and back, what a lossy checkpoint would write."""
    lows = {getattr(torch, k): getattr(torch, v)
            for k, v in loop.cell.config["control_dtypes"].items()}
    save = loop.save

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        if isinstance(node, list):
            return [cast(v) for v in node]
        if isinstance(node, torch.Tensor) and node.dtype in lows:
            return node.to(lows[node.dtype]).to(node.dtype)
        return node

    loop.save = lambda path, state, opts: save(path, cast(state), opts)


def flipped_byte(loop, stack) -> None:
    """One byte changed in the middle of the file once it is written,
    which lies inside a leaf's record."""
    save = loop.save

    def flipped(path, state, opts):
        save(path, state, opts)
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x10]))

    loop.save = flipped


def dropped_leaf(loop, stack) -> None:
    """The smallest floating-point leaf left out of every save."""
    save = loop.save

    def dropped(path, state, opts):
        flat = {p: v for p, v in leaves(state).items()
                if isinstance(v, torch.Tensor) and v.is_floating_point()}
        smallest = min(flat, key=lambda p: (flat[p].nbytes, p))
        return save(path, _replace(state, smallest, None), opts)

    loop.save = dropped


def unshuffled_leaf(loop, stack) -> None:
    """The largest bfloat16 leaf written unshuffled under the shuffle
    flag: its bytes unshuffled block by block, at the block size the
    program chooses for it, are saved in its place, so the shuffle gives
    back the leaf's own bytes and the record's payload holds them as they
    are, and a reader that unshuffles gets other bytes."""
    from tpu_blosc_torch.chunk import choose_block_size

    save = loop.save

    def unshuffle(t: torch.Tensor, bs: int) -> torch.Tensor:
        ts = t.element_size()
        b = _bytes(t).clone()
        body = b.numel() // bs * bs
        b[:body] = b[:body].view(-1, ts, bs // ts).transpose(1, 2).reshape(-1)
        m = (b.numel() - body) // ts
        b[body:body + m * ts] = b[body:body + m * ts].view(ts, m).t().reshape(-1)
        return b.view(t.dtype).view(t.shape)

    def unshuffled(path, state, opts):
        flat = {p: v for p, v in leaves(state).items()
                if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16}
        largest = max(flat, key=lambda p: (flat[p].nbytes, p))
        t = flat[largest]
        bs = choose_block_size(t.nbytes, t.element_size(), opts.block_size)
        return save(path, _replace(state, largest, unshuffle(t, bs)), opts)

    loop.save = unshuffled


CONTROL = lower_precision
FAULTS = {"flipped_byte": flipped_byte, "dropped_leaf": dropped_leaf,
          "unshuffled_leaf": unshuffled_leaf}
