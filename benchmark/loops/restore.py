"""Restores of one checkpoint onto the device through the port, in a closed loop.

Set-up makes the configuration's state on the device from the seed (its
data generator), keeps a copy of it that the program never sees, and
writes it once with ``tpu_blosc_torch.save_pytree(path, state, opts)``
into a temporary directory that the run removes at its end.  One restore
is ``load_pytree(path, device=True, strategy=<load_strategy>)`` (on a
CPU device, ``device=`` that device), then a synchronise: what a
training job does when it resumes.  One caller; the next restore starts
when the last returns.  The window's record counts restores as
``round_trips`` and the state's tensor bytes as ``tensor_bytes``, for
``tensor_gbps``; each restore's time is in ``ops["decode"]``
(``ops["encode"]`` is empty: the file is written once, in set-up).

The check samples restores from the seed (reservoir sampling) and keeps
them until the window has closed.  It then holds every leaf of each to
the kept state byte for byte, on the device, with its dtype, shape and
device, and the plain reference's reading of the file (its layout,
manifest and a seed-drawn sample of leaf records) to the kept state too.

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


class Loop:
    """The restore loop of one cell: the state from the configuration's
    data generator and the seed, options from the configuration, sizes
    from the traffic file."""

    def __init__(self, cell, seed: int, device: torch.device):
        import tpu_blosc_torch as tbt

        self.cell, self.device, self.seed = cell, device, seed
        cfg, traffic = cell.config, cell.traffic
        o = cfg["options"]
        self.opts = tbt.Options(codec=tbt.Codec[o["codec"]], level=o["level"],
                                shuffle=tbt.Shuffle[o["shuffle"]], block_size=o["block_size"],
                                num_threads=o["num_threads"])
        self.dtype = getattr(torch, cfg["dtype"])
        self.nbytes = traffic["tensor_bytes"]
        self.strategy = traffic["load_strategy"]
        make = cell.module("data", cfg["data"]["generator"]).make
        self.state = make(self.nbytes, self.dtype, seed, device, cfg["data"])
        self.kept = {p: v.clone() if isinstance(v, torch.Tensor) else v
                     for p, v in leaves(self.state).items()}
        self.dir = tempfile.mkdtemp(prefix="bench_restore_")
        self._cleanup = weakref.finalize(self, shutil.rmtree, self.dir, ignore_errors=True)
        self.path = os.path.join(self.dir, "state.tpbs")
        # the calls the timed path makes; controls and fault tests put
        # others in their place
        self.save = tbt.save_pytree
        self.load = tbt.load_pytree
        self.k = traffic["check_sample"]
        self.rng = random.Random(seed)
        self.sample: list = []
        self.seen = 0
        self.attempted = 0
        self.raised = 0
        self.first_error = ""
        self.frame_bytes = None

    def _restore(self, span=NO_SPAN):
        """One restore: (the restored state, seconds)."""
        target = True if self.device.type == "cuda" else self.device
        t0 = time.perf_counter()
        with span:
            out = self.load(self.path, device=target, strategy=self.strategy)
            _sync(self.device)
        return out, time.perf_counter() - t0

    def warm(self, rounds: int) -> None:
        """Set-up: write the file, then ``rounds`` restores and as many
        more as the sample keeps, held at once, so the window's
        allocations are cached.  A save or a restore that raises is
        counted as in the window."""
        try:
            self.save(self.path, self.state, self.opts)
            self.frame_bytes = os.path.getsize(self.path)
        except Exception:
            self.raised += 1
            self.first_error = traceback.format_exc()
            return
        held = []
        for _ in range(rounds + self.k):
            try:
                held.append(self._restore()[0])
            except Exception:
                self.raised += 1
                self.first_error = self.first_error or traceback.format_exc()
        del held
        _sync(self.device)

    def _keep(self, out) -> None:
        """Reservoir sampling of the restores."""
        if len(self.sample) < self.k:
            self.sample.append(out)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.sample[j] = out
        self.seen += 1

    def _run(self, stop, span=None) -> dict:
        """Restores until ``stop(seconds so far, restores so far)``."""
        times = []
        t_begin = time.perf_counter()
        t_end = t_begin
        attempts = 0
        while not stop(t_end - t_begin, attempts):
            attempts += 1
            self.attempted += 1
            try:
                out, seconds = self._restore(span() if span else NO_SPAN)
            except Exception:  # an answer that never comes: counted, and the loop goes on
                self.raised += 1
                self.first_error = self.first_error or traceback.format_exc()
                t_end = time.perf_counter()
                continue
            t_end = time.perf_counter()
            times.append(seconds)
            self._keep(out)
            del out
        return {"ops": {"encode": [], "decode": times}, "round_trips": len(times),
                "window_s": t_end - t_begin, "tensor_bytes": self.nbytes}

    def window(self, seconds: float) -> dict:
        """The timed window: restores until ``seconds`` have passed (the
        last one started before then runs to its end)."""
        return self._run(lambda elapsed, _: elapsed >= seconds)

    def traced(self, count: int) -> dict:
        """``count`` restores, each in a ``record_function`` span
        ("bench.restore")."""
        from torch.profiler import record_function

        return self._run(lambda _, attempts: attempts >= count,
                         lambda: record_function("bench.restore"))

    def _wrong(self, got) -> int:
        """Bytes of the kept state that the restored tree ``got`` does not
        hold: a tensor leaf of another dtype, shape or device, or missing,
        counts all its bytes; another value counts 1."""
        restored = leaves(got)
        wrong = sum(1 for p in restored if p not in self.kept)
        for p, want in self.kept.items():
            have = restored.get(p)
            if not isinstance(want, torch.Tensor):
                wrong += isinstance(have, torch.Tensor) or have != want
            elif (not isinstance(have, torch.Tensor) or have.dtype != want.dtype
                  or have.shape != want.shape or have.device != want.device):
                wrong += want.nbytes
            else:
                wrong += int((_bytes(have) != _bytes(want)).sum())
        return wrong

    def _file_wrong(self, reading) -> int:
        """Bytes of the kept state that the reference's reading of the file
        does not hold: the manifest's leaves and values, and the sampled
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
        """Release the program's input and judge the sampled restores and
        the file against the kept state.  ``reference`` is the
        configuration's reference, ``reference(path, seed)`` (ValueError
        for a file it cannot read).  Returns the numbers compared, {name:
        (value, limit)}, and {"sampled": restores judged, "bad": those
        with a wrong leaf, "frames_read": leaf records the reference
        decoded}."""
        self.state = None
        self.save = self.load = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        wrongs = [self._wrong(out) for out in self.sample]
        self.sample = []
        frames_read = 0
        try:
            reading = reference(self.path, self.seed)
            frame_bad = self._file_wrong(reading)
            frames_read = len(reading["decoded"])
        except (OSError, ValueError):
            frame_bad = self.nbytes
        self.kept = None
        self._cleanup()
        # no restore at all is an answer that never came
        decoded_bad = max(wrongs) if wrongs else self.nbytes
        return ({"frame_bad_bytes": (frame_bad, 0), "decoded_bad_bytes": (decoded_bad, 0),
                 "failed_calls": (self.raised, 0)},
                {"sampled": len(wrongs), "bad": sum(bool(w or frame_bad) for w in wrongs),
                 "frames_read": frames_read})


def lower_precision(loop, stack) -> None:
    """The control: the configuration states a lossless restore of its
    dtype; the control saves every floating-point leaf cast to the next
    precision below (``control_dtype``) and back, what a lossy checkpoint
    would hand back."""
    low = getattr(torch, loop.cell.config["control_dtype"])
    save = loop.save

    def lossy(path, state, opts):
        def cast(node):
            if isinstance(node, dict):
                return {k: cast(v) for k, v in node.items()}
            if isinstance(node, list):
                return [cast(v) for v in node]
            if isinstance(node, torch.Tensor) and node.is_floating_point():
                return node.to(low).to(node.dtype)
            return node

        return save(path, cast(state), opts)

    loop.save = lossy


def altered_leaf(loop, stack) -> None:
    """One byte changed in the middle of one restored leaf, the largest."""
    load = loop.load

    def altered(path, **kwargs):
        out = load(path, **kwargs)
        t = max((v for v in leaves(out).values() if isinstance(v, torch.Tensor)),
                key=torch.Tensor.numel)
        b = _bytes(t)
        b[b.numel() // 2] ^= 1
        return out

    loop.load = altered


def damaged_record(loop, stack) -> None:
    """One byte changed in the middle of the file once it is written,
    which lies inside a leaf's record."""
    save = loop.save

    def damaged(path, state, opts):
        save(path, state, opts)
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x10]))

    loop.save = damaged


CONTROL = lower_precision
FAULTS = {"altered_leaf": altered_leaf, "damaged_record": damaged_record}
