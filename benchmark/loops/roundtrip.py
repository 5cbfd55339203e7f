"""Round trips of one device tensor through the port, in a closed loop.

One round trip is ``tpu_blosc_torch.compress_array(x, opts,
strategy=<encode_strategy>)`` of a tensor that lives on the device, then
``decompress_array(frame, dtype, shape, device=x.device,
strategy=<decode_strategy>)`` of the frame it returned, back onto the
device, and a synchronise: what an offload does when it stages a tensor
off the card and brings it back.  One caller; the next round trip starts
when the last returns.

The tensor comes from the configuration's data generator and the seed;
a copy of it that the program never sees is kept on the device for the
check.  The check samples round trips from the seed (reservoir sampling,
so each round trip of the window is as likely to be drawn) and keeps
each drawn frame and decoded tensor until the window has closed.  It then
holds each decoded tensor to the kept input byte for byte, and each
frame, read back by the plain reference, too.
"""

from __future__ import annotations

import contextlib
import random
import time
import traceback

import numpy as np
import torch

NO_SPAN = contextlib.nullcontext()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """The round-trip loop of one cell: data and options from the
    configuration, sizes from the traffic file, the seed's sample."""

    def __init__(self, cell, seed: int, device: torch.device):
        import tpu_blosc_torch as tbt

        self.cell, self.device = cell, device
        cfg, traffic = cell.config, cell.traffic
        o = cfg["options"]
        self.opts = tbt.Options(codec=tbt.Codec[o["codec"]], level=o["level"],
                                shuffle=tbt.Shuffle[o["shuffle"]], type_size=o["type_size"],
                                block_size=o["block_size"], num_threads=o["num_threads"])
        self.dtype = getattr(torch, cfg["dtype"])
        self.nbytes = traffic["tensor_bytes"]
        if self.nbytes % self.dtype.itemsize:
            raise ValueError(f"{self.nbytes} bytes is not a whole number of {self.dtype}")
        self.encode_strategy = traffic["encode_strategy"]
        self.decode_strategy = traffic["decode_strategy"]
        self.make = cell.module("data", cfg["data"]["generator"]).make
        self.x = self.make(self.nbytes, self.dtype, seed, device, cfg["data"])
        self.kept = self.x.clone()
        # the calls the timed path makes; controls and fault tests put
        # others in their place
        self.compress = tbt.compress_array
        self.decompress = tbt.decompress_array
        self.k = traffic["check_sample"]
        self.rng = random.Random(seed)
        self.sample: list = []
        self.frames: list = []
        self.seen = 0
        self.attempted = 0
        self.raised = 0
        self.first_error = ""
        self.frame_bytes = None

    def _round_trip(self, enc_span=NO_SPAN, dec_span=NO_SPAN):
        """One round trip: (frame, decoded tensor, encode s, decode s)."""
        x = self.x
        t0 = time.perf_counter()
        with enc_span:
            frame = self.compress(x, self.opts, strategy=self.encode_strategy)
        t1 = time.perf_counter()
        with dec_span:
            y = self.decompress(frame, x.dtype, x.shape, device=x.device,
                                strategy=self.decode_strategy)
            _sync(self.device)
        return frame, y, t1 - t0, time.perf_counter() - t1

    def warm(self, rounds: int) -> None:
        """Set-up: ``rounds`` round trips and as many more as the sample
        keeps.  The first calls load the port's libraries (building them
        where the checkout has none yet); outputs as many as the sample
        keeps are held at once, so the window's allocations are cached.  A
        call that raises is counted as in the window."""
        held = []
        for _ in range(rounds + self.k):
            try:
                held.append(self._round_trip()[:2])
            except Exception:
                self.raised += 1
                self.first_error = self.first_error or traceback.format_exc()
        self.frame_bytes = len(held[-1][0]) if held else None
        del held
        _sync(self.device)

    def _keep(self, frame, y) -> None:
        """Reservoir sampling of the round trips' outputs.  A drawn frame
        equal to one kept already is dropped and the kept one stands for
        it, so the window holds one copy of the (usually single) frame and
        the program's host memory is not pinned by the benchmark."""
        if len(self.sample) < self.k:
            j = len(self.sample)
            self.sample.append(None)
        else:
            j = self.rng.randrange(self.seen + 1)
        self.seen += 1
        if j < self.k:
            same = next((f for f in self.frames if f == frame), None)
            if same is None:
                self.frames.append(frame)
                same = frame
            self.sample[j] = (same, y)

    def _run(self, stop, spans=None) -> dict:
        """Round trips until ``stop(seconds so far, round trips so far)``."""
        ops = {"encode": [], "decode": []}
        t_begin = time.perf_counter()
        t_end = t_begin
        attempts = 0
        while not stop(t_end - t_begin, attempts):
            attempts += 1
            self.attempted += 1
            try:
                frame, y, t_enc, t_dec = self._round_trip(*(spans() if spans else ()))
            except Exception:  # an answer that never comes: counted, and the loop goes on
                self.raised += 1
                self.first_error = self.first_error or traceback.format_exc()
                t_end = time.perf_counter()
                continue
            t_end = time.perf_counter()
            ops["encode"].append(t_enc)
            ops["decode"].append(t_dec)
            self._keep(frame, y)
            del frame, y
        return {"ops": ops, "round_trips": len(ops["encode"]), "window_s": t_end - t_begin,
                "tensor_bytes": self.nbytes}

    def window(self, seconds: float) -> dict:
        """The timed window: round trips until ``seconds`` have passed (the
        last one started before then runs to its end)."""
        return self._run(lambda elapsed, _: elapsed >= seconds)

    def traced(self, count: int) -> dict:
        """``count`` round trips, each call in a ``record_function`` span
        ("bench.encode", "bench.decode")."""
        from torch.profiler import record_function

        return self._run(lambda _, attempts: attempts >= count,
                         lambda: (record_function("bench.encode"),
                                  record_function("bench.decode")))

    def check(self, reference) -> tuple[dict, dict]:
        """Release the program's input and judge the sampled outputs
        against the kept copy.  ``reference`` is the configuration's
        reference, ``reference(frame) -> uint8 array`` (ValueError for a
        frame it cannot read).  Returns the numbers compared, {name:
        (value, limit)}, and {"sampled": round trips judged, "bad":
        those with a wrong output}."""
        self.x = None
        self.compress = self.decompress = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        want = self.kept.view(-1).view(torch.uint8)
        n = want.numel()
        want_host = want.cpu().numpy()
        # no round trip at all is an answer that never came
        decoded_bad = frame_bad = 0 if self.sample else n
        judged: list = []
        bad = 0
        for frame, y in self.sample:
            if (not isinstance(y, torch.Tensor) or y.dtype != self.dtype
                    or y.device != self.device or y.numel() * y.element_size() != n):
                wrong_y = n
            else:
                wrong_y = int((y.contiguous().view(-1).view(torch.uint8) != want).sum())
            wrong_f = next((w for f, w in judged if f is frame), None)
            if wrong_f is None:
                try:
                    got = reference(frame)
                    wrong_f = n if got.size != n else int(np.count_nonzero(got != want_host))
                except ValueError:
                    wrong_f = n
                judged.append((frame, wrong_f))
            decoded_bad = max(decoded_bad, wrong_y)
            frame_bad = max(frame_bad, wrong_f)
            bad += bool(wrong_y or wrong_f)
        sampled = len(self.sample)
        self.sample, self.frames = [], []
        self.kept = None
        return ({"frame_bad_bytes": (frame_bad, 0), "decoded_bad_bytes": (decoded_bad, 0),
                 "failed_calls": (self.raised, 0)},
                {"sampled": sampled, "bad": bad, "frames_read": len(judged)})
