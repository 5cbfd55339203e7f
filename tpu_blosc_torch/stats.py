"""Observability: compression statistics, frame structure, a profiler
trace of a region, and the spans the device round trip records into it.

Counterpart: ``tpu_blosc/stats.py:20-151``.  ``CompressionStats``,
``FrameStats``, ``frame_stats`` and ``compress_with_stats`` are the JAX
package's host code, field for field.  ``trace`` keeps its contract (a
dict that always gets ``elapsed_s``, and ``trace_dir`` only when a trace
was written) with ``torch.profiler`` in place of ``jax.profiler``: CPU
activity, and CUDA activity when a card is present, exported as a Chrome
trace (``chrome://tracing`` or Perfetto read it).  ``span`` is the port's
own: the stages of ``compress_array`` and ``decompress_array`` as named
``record_function`` spans in that trace, recorded only while a profiler
records.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler

from .format import Header, Shuffle, parse_header
from .options import Options


@dataclass(frozen=True)
class CompressionStats:
    """What happened during one compress call."""

    nbytes_orig: int
    nbytes_comp: int
    codec: int
    shuffle: Shuffle
    type_size: int
    block_size: int
    num_blocks: int
    memcpy_blocks: int
    elapsed_s: float

    @property
    def ratio(self) -> float:
        return self.nbytes_orig / max(self.nbytes_comp, 1)

    @property
    def throughput_gbps(self) -> float:
        return self.nbytes_orig / max(self.elapsed_s, 1e-12) / 1e9

    @property
    def used_memcpy(self) -> bool:
        return self.memcpy_blocks > 0


@dataclass(frozen=True)
class FrameStats:
    """Structure of an existing frame (no decompression performed)."""

    header: Header
    num_blocks: int
    block_payload_sizes: tuple = field(default_factory=tuple)
    memcpy_blocks: int = 0

    @property
    def ratio(self) -> float:
        return self.header.nbytes_orig / max(self.header.nbytes_comp, 1)


def frame_stats(frame) -> FrameStats:
    """A frame's block structure (single-block or FLAG_SPLIT)."""
    raw = bytes(frame) if not isinstance(frame, bytes) else frame
    header = parse_header(raw)
    if not header.is_split:
        return FrameStats(
            header=header,
            num_blocks=1,
            block_payload_sizes=(header.nbytes_comp - 16,),
            memcpy_blocks=1 if header.is_memcpy else 0,
        )
    from .chunk import parse_block_table

    entries, _ = parse_block_table(raw, header)
    return FrameStats(
        header=header,
        num_blocks=len(entries),
        block_payload_sizes=tuple(s for s, _ in entries),
        memcpy_blocks=sum(1 for _, m in entries if m),
    )


def compress_with_stats(data, opts: Options | None = None):
    """Compress and return (frame, CompressionStats)."""
    from .api import compress_with_options

    if opts is None:
        opts = Options()
    t0 = time.perf_counter()
    frame = compress_with_options(data, opts)
    elapsed = time.perf_counter() - t0
    if frame[:4] == b"TPB2":
        from .container import parse_container

        _, codec, _, type_size, total, sizes, _ = parse_container(frame)
        return frame, CompressionStats(
            nbytes_orig=total,
            nbytes_comp=len(frame),
            codec=codec,
            shuffle=opts.clamped().shuffle,
            type_size=type_size,
            block_size=0,
            num_blocks=len(sizes),
            memcpy_blocks=0,
            elapsed_s=elapsed,
        )
    fs = frame_stats(frame)
    header = fs.header
    return frame, CompressionStats(
        nbytes_orig=header.nbytes_orig,
        nbytes_comp=len(frame),
        codec=header.codec,
        shuffle=header.shuffle_mode,
        type_size=header.type_size,
        block_size=header.block_size,
        num_blocks=fs.num_blocks,
        memcpy_blocks=fs.memcpy_blocks,
        elapsed_s=elapsed,
    )


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile a region: wall time always, and with ``log_dir`` a
    ``torch.profiler`` trace of it written there as a Chrome trace JSON.

        with tpu_blosc_torch.stats.trace("/tmp/trace") as t:
            tbt.compress_array(x)
        print(t["elapsed_s"], t["trace_file"])

    The trace holds the host's operators and, with a card, its kernels
    and copies (``"cat": "kernel"``, ``"gpu_memcpy"``); the card is
    synchronised before the profiler stops, so the kernels launched in
    the region finish inside it.  ``trace_dir`` and ``trace_file`` are set
    only when the trace was written; a profiler that fails to start leaves
    the region untraced, as in the JAX package.

    The round trip's stages appear in it as ``record_function`` spans
    (``"cat": "user_annotation"``, see ``span``), on the clock of the
    host's operators and the card's runtime calls:

    - ``tpbt.compress``: all of ``device.compress_array``; inside it
      ``tpbt.compress.filter`` (the filter launches on the tensor's
      device and the tail's copy), ``tpbt.compress.d2h`` (the copy to
      host memory), ``tpbt.compress.host_filter`` (the tail's filter and
      the unfilter of blocks stored raw), ``tpbt.compress.codec`` (the
      codec; on the host route, ``compress_with_options``) and
      ``tpbt.compress.frame`` (the frame's assembly);
    - ``tpbt.decompress``: all of ``device.decompress_array``; inside it
      ``tpbt.decompress.codec`` (the host decode),
      ``tpbt.decompress.host_filter`` (the tail's unfilter),
      ``tpbt.decompress.h2d`` (the copy to the target device) and
      ``tpbt.decompress.unfilter`` (the unfilter launches and the tail's
      copy on the target device).

    - ``tpbt.load_pytree``: all of ``checkpoint.load_pytree``; inside it
      ``tpbt.load_pytree.manifest`` (opening the file, its manifest and
      the leaf specs) and, on a device load's prefetch pipeline, one
      ``tpbt.load_pytree.wait`` around each wait for the worker threads'
      next decoded window of leaves and one ``tpbt.load_pytree.h2d``
      around each leaf's copy to the target device.  The workers' own read
      and decode run on threads the profiler does not follow, so the
      waits are where their time shows.
    - ``tpbt.save_pytree``: all of ``checkpoint.save_pytree``; inside it
      ``tpbt.save_pytree.manifest`` (the tree's walk and record 0's
      frame), one ``tpbt.save_pytree.wait`` around each wait for a CUDA
      leaf's stage 1 (its filter and copy to host memory, on a worker
      thread the profiler does not follow; a lone CUDA leaf runs it on the
      calling thread, inside the wait), one ``tpbt.save_pytree.codec``
      around each leaf's stage 2 and each native batch of host leaves, and
      one ``tpbt.save_pytree.write`` around each record's write.
    - ``tpbt.save_pytree_sharded``: all of
      ``checkpoint.save_pytree_sharded``; inside it
      ``tpbt.save_pytree_sharded.manifest`` (the tree's walk, the shards'
      span checks and record 0's frame) and save_pytree's ``.wait``,
      ``.codec`` and ``.write`` stages, under their ``tpbt.save_pytree.*``
      names.

    A stage that does no work in a call records no span there (no tail,
    no raw block, a single-block frame).  The time a top span covers
    outside its stages is the entry point's own: options, header checks,
    views.  Checkpoint writers and the distributed entry points, which
    call the stages directly, record the stages without a top span.
    """
    record: dict = {}
    prof = None
    if log_dir is not None:
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        try:
            from torch.profiler import ProfilerActivity, profile, schedule

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            # one warm-up step, then the region as the one active step.  A
            # second trace in a process has been seen to lose its first
            # device operations on an H100 (a copy from host memory and
            # the kernel after it), so where the process already uses the
            # card, the warm-up step runs such a pair of its own on the
            # current device, which the trace leaves out.
            prof = profile(activities=activities, record_shapes=False, acc_events=True,
                           schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                           on_trace_ready=lambda p: _export(p, path))
            prof.start()
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.ones(1).to(torch.cuda.current_device()).add_(1)
                torch.cuda.synchronize()
            prof.step()
        except Exception:
            prof = None
    t0 = time.perf_counter()
    try:
        yield record
    finally:
        if prof is not None and torch.cuda.is_available():
            torch.cuda.synchronize()
        record["elapsed_s"] = time.perf_counter() - t0
        if prof is not None:
            prof.step()  # the active step ends: the trace is written
            prof.stop()
            if os.path.exists(path):
                record["trace_dir"] = log_dir
                record["trace_file"] = path


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a ``record_function``
    span while a torch profiler records (``trace``, or the caller's own
    ``torch.profiler.profile``), and else does nothing.

    The test is one read of torch's module-wide "a profiler is on" flag,
    so without a profiler a span costs that read and the shared no-op
    context, a fraction of a microsecond.  The flag is the same on every
    thread, but the profiler records the threads it follows (the one that
    started it): a stage on another thread enters ``record_function`` and
    is not recorded.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def _export(prof, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
