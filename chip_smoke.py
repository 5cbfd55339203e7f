#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA GPU and check them.

Run from the root of the repository, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the native host codec (g++, from the port's own copy of the
source, then its fastcall module with gcc) and the CUDA kernels (nvcc,
one process per source in csrc/, all at once, beside the g++ build) from
the sources in the checkout into tpu_blosc_torch/_build/, then:

1. prints the card, its power limit, the host CPU, torch, CUDA and nvcc
   versions, the build times and whether the fastcall module loaded;
2. holds each kernel against its plain PyTorch version on the card:
   - the shuffle pair, on both of its paths (vec16 and generic): random
     bytes at type sizes 2, 3, 4, 5, 8, 12, 16, 32 and 300, each at
     (1, 8 ts), (7, 4096 ts), (64, ~1 MiB) and a block of 24 elements
     (bs/ts not a multiple of 16), with raw rows; (16384, 4096) at ts 4;
     sources 1, 4 and 12 bytes off a 16-byte boundary; 2 GiB + 1 MiB at
     ts 4; each launcher refusing a path whose preconditions fail.
     Timed at (64, ~1 MiB) for type sizes 2, 3, 4, 8 and 16 and at
     (16384, 4096) for ts 4;
   - the match strategy's two kernels, each on both of its paths (vec16
     and generic: aligned rows, the same rows on the generic path, and
     views 4 bytes off a 16-byte boundary), at seg 256, 1000, 4096, 16384,
     18440, 20480 and 262144 on random and periodic rows.  The mask
     kernel, in its nibble and its packed form: offsets 1, 3, 48, 1024,
     3000 (above the kernels' shared-memory halo) and one that leaves the
     whole row literal, and run lengths 1, 3, 8 and 9 with tails 0, 5 and
     16.  The count kernel: the candidate lists of
     14 and of 20 offsets and one with an offset above the halo, plus
     rows with no equal bytes, constant rows, a row where two offsets
     tie, rows whose only equal pair straddles a tile edge, and a
     periodic row followed by a row that starts with the same bytes.
     Each launcher refusing a path whose preconditions fail (and, in
     step 7, path C's own (1024, 262144) segments, where both are timed);
   - the probe kernel: 1, 2 and 4 tiles and a 64 MiB (32768, 512) tensor,
     timed on the latter;
   - the bit-shuffle pair: random bytes at type sizes 2, 3, 4, 5, 8, 16
     and 32, each at (1, 8 ts), (7, 512 * 8 ts) and (64, ~1 MiB), with
     raw rows; sources 1 and 4 bytes off a 16-byte boundary; each wrapper
     and each launcher refusing bs % (8 ts) != 0.  Timed at (64, 1 MiB)
     for type sizes 2, 4 and 8, aligned and on a view 4 bytes off;
   - the rle strategy's two kernels (run counts, run records), each on
     both of its paths and on views 4 bytes off a 16-byte boundary, at seg
     256, 1000, 4096, 18440 and 262144: random rows, small-alphabet rows,
     a start at every byte, rows of one run side by side (a row that ends
     with the byte the next begins with), runs that straddle the tile
     edges, rows picked out of order and twice; counts off by one must
     raise; each launcher refusing what it does not take (and, in step 8,
     path G's own (1024, 262144) segments, where both are timed);
   - the fill kernel of the records decode, on both of its paths and into
     a view 4 bytes off, at seg 256, 1000, 4096, 8192 (one tile of the
     kernel), 8208, 16384, 18440, 24581 and 262144: offsets filled in
     bytes (1, 2, 3, 6, 7, 250, 255), in words (4, 12, 24) and in uint4
     (16, 48, 96, 256, 768, 1024; most divide no seg), literals on both
     sides of the tile edges, a tile with no record, a row of 30%
     literals, a row of literals only, a row whose only literals are its
     first d bytes, a row with no record, and one (1, 2**24) row at d = 1;
     the launcher and the wrapper refusing what they do not take (and, in
     step 9, path H's own records, where it is timed, and synthetic
     records at 2.2% on the same geometry at offsets 1, 3, 4, 16, 256 and
     1024);
3. main path A: a 64 MiB float32 ramp, LZ4 level 5, byte shuffle;
4. main path B: 64 MB of float64 signal, ZSTD level 5, byte shuffle,
   with one 1 MiB block of random bytes (memcpy fallback) and a ragged
   tail;
5. main path D: 64 MiB of float32 linspace(0, 1), LZ4 level 5, bit
   shuffle;
6. main path E: 32,000,005 int16 samples of a 12-bit ADC signal
   (BASELINE.json config 4), LZ4 level 5, bit shuffle, with one 1 MiB
   block of random bytes and a 36,874-byte tail ending in a partial group
   of 5 elements;
   then, on A: compress_with_stats of its bytes and frame_stats of its
   frame (64 blocks); a stats.trace of its compress_array and
   decompress_array(strategy="device"); the codec registry (a codec at
   the new ID 42, zlib level 1, and one in place of LZ4 that wraps the
   builtin, each counting its calls): compress_array launches the shuffle
   kernel once, calls the codec once a block and writes the frame
   compress_with_options writes under the same registry;
   decompress_array(strategy="device") calls the codec on each coded
   block, launches the unshuffle kernel once and gives the tensor back;
   strategy "match" under the override gives the transfer frame; then the
   registry is restored and A's frame is the builtin one again;
7. main path C: 256 MiB of tiled float32 with 1% noise (bench.py's match
   data), LZ4 level 5, 1 MiB blocks, compress_array(strategy="match");
8. main path G: 256 MiB of int32, a staircase (arange // 64) whose every
   odd 1 MiB block has its low byte replaced by random bytes from the
   seed, LZ4 level 5, byte shuffle, compress_array(strategy="rle"): the
   even blocks have four run-sparse byte planes (the emitter writes them
   from run records), the odd ones three and a dense one (gathered,
   rebuilt on the host, re-encoded);
9. main path H: decompress_array(strategy="records") of path C's match
   frame and of the host encoder's frame of the same tensor;
10. main path F: a checkpoint of GPT-2 medium's 292 parameter tensors
    (354.8 M bfloat16 values, N(0, 0.02) from the seed, made on the card)
    through save_pytree (LZ4 level 5, byte shuffle), load_pytree onto the
    card (the transfer and the device strategy) and load_leaf, in a
    temporary directory, and a stats.trace of one more save_pytree; then,
    for H, load_pytree(device=True, strategy="records") of a checkpoint
    of one of F's leaves and 64 MiB of C's tensor;
11. suggest_codec and suggest_options on A's, B's and random bytes; the
    CLI (tpu_blosc_torch.__main__.main) in this process: suggest, then
    compress (the file must be compress_batch_with_options' frame),
    decompress, info, pack, unpack and verify --deep on A's bytes and on
    a .npy of a leaf of F (as float32);
12. main path I: in this process, a group of one rank over NCCL on cuda:0
    (dist.initialize_distributed, a FileStore in a temporary directory):
    compress_chunked_mesh with statistics and decompress_chunked_mesh of
    A's ramp plus a 123-byte tail (byte shuffle) and of D's linspace (bit
    shuffle), and compress_chunked_multihost / decompress_chunked_multihost
    of the same bytes; the calls and, one by one, the stages are timed;
    then stats.trace of compress_chunked_mesh with statistics, and of 20
    launches each of the shuffle and the run-count kernel back to back on
    its (64, 1 MiB) rows;
13. main path J: the script starts itself twice (--rank r --world 2), two
    ranks over Gloo that share the card: (a) compress_chunked_mesh and
    decompress_chunked_mesh of I's first stream; (b) save_pytree_sharded
    of F's state cut to its first four layers (full width; every 2-D
    weight a DTensor Shard(0) over the ranks with CUDA local shards, the
    rest plain tensors), and the same from CPU local shards; then this
    process loads the set with load_pytree_sharded and load_leaf_sharded;
    beside the ranks, one ``python -m tpu_blosc_torch info`` of A's frame
    in a subprocess;
14. standalone: copies tpu_blosc_torch/ alone into a temporary
    directory and, in a subprocess that can import no copy of tpu_blosc,
    builds it there (host codec, fastcall module, CUDA kernels) and runs
    path A at 16 MiB; the frame must be this process's, the launches A's;
15. native-less: a subprocess with TPU_BLOSC_NO_NATIVE=1 (the pure-Python
    codecs) runs compress and decompress of a 4 MiB host float32 ramp
    (LZ4 5, ts 4) under byte and bit shuffle, then compress_array (1 MiB
    blocks) and decompress_array(strategy="device") of it as a CUDA
    tensor; each call must launch its filter kernel exactly once, and
    each frame must decode here on the native route and equal the frame
    the child writes with its host filter forced onto the plain version;
16. fastcall: 10,000 compress() calls of the 100 KB i % 256 ramp (LZ4 5,
    shuffle, ts 4) in a subprocess with the fastcall module (it must
    load where Python's headers are present) and 10,000 in one with
    TPU_BLOSC_NO_FAST=1 (ctypes); the frames must be equal; microseconds
    a call of each, beside the card and the host CPU;
17. prints the device busy share of the traces of A, F and I (the union of
    their kernel, copy and memset intervals over the traced window), the
    kernels' JSON line (each kernel's launches on the main paths, its
    time, its plain version's, the time of the one PyTorch call that
    computes the same function where there is one, and the least time the
    card could take: see ``bound``; for the shuffle pair and the run-count
    kernel their mean device time in the traces) and, last, the ok line.
    A trace is complete when every call that put work on the card has its
    device event (matched by correlation ID) and every launch of a port
    kernel its event (read_trace names them by TRACE_KERNELS); only a
    complete trace gives a busy share, and each trace must hold the
    events of the kernels its phase names.

Paths A, B, D and E run compress_array on the CUDA tensor and
decompress_array(strategy="device"), and must give the frame of the host
path (compress_with_options on the tensor's bytes) and the tensor back
exactly.  Path C's frame must differ from the transfer frame (the
emitter engaged), decode to the tensor on the host and through
decompress_array(strategy="device"), and equal, on a 16 MiB slice, the
frame the CPU route (the kernels' plain versions) writes; so must E's
match frame on a 16 MiB slice.  G's frame must differ from the transfer
frame, decode to the tensor on the host and through
decompress_array(strategy="device"), and equal the CPU route's on a 16 MiB
slice.  H's tensors must equal C's tensor and the transfer decode, and
the checkpoint's leaves must come back exactly, the dense one by the
transfer route.  F's file must equal the one save_pytree
writes from the same tree on the CPU, and every load must give every
leaf back exactly.  I's and each of J's frames must equal the host path's
frame and decode to the bytes, their MeshStats a NumPy oracle's (the
sampled byte histogram and the per-block diff counts of the host-filtered
stream); each file of J's set must equal the one its rank writes from CPU
shards, and every loaded leaf the tensor it was made from; a rank that
fails or hangs fails the run.  Every kernel must be launched by the path it serves
(A, B and C the shuffle pair on its vec16 path, C the mask and the count
kernel of the match strategy on theirs, D and E the bit-shuffle pair, F
the shuffle pair, G the shuffle kernel, the run-count and the run-record
kernel, H the fill and the unshuffle kernel, I the shuffle pair, the
bit-shuffle pair and the run-count kernel, each of J's ranks the shuffle
pair and the run-count kernel in (a) and the shuffle kernel once for each
of its CUDA records over 4 MiB in (b)): the launch counts are reset just before each
path and read just after.  Any failure raises, so the script exits
non-zero without the ok line.  It imports nothing of JAX and exits
non-zero when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20261016
MIB = 1 << 20
DEVICE = "cuda"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_s(fn, reps: int = 5) -> float:
    """Median wall seconds of ``fn``, which must end synchronised."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# bytes a second, and operations a second outside the tensor cores (the
# float32 rate; the kernels here do integer and bit operations, for which
# the data sheet gives no rate of its own, and the card has half as many
# int32 lanes, so this bound is a generous one).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def bound(nbytes: int, operations: int) -> dict:
    """The least time the card could take to move ``nbytes`` (each input
    read once, each output written once) and to do ``operations``: the
    larger of the two times, in ms, and which of them it is."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = operations / PEAK_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def phase_environment() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from tpu_blosc_torch.filters import kernels
    from tpu_blosc_torch.native import backend

    print(gpu_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([kernels.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(backend.lib), pool.submit(kernels.lib)]
        for b in builds:
            b.result()
    print(f"build, both at once: {time.perf_counter() - t0:.1f} s; host codec "
          f"{backend.build_seconds:.1f} s compiling, fastcall module "
          f"{backend.fast_build_seconds or 0:.1f} s after it ({backend.fastcall_status()}), "
          f"CUDA kernels ({len(kernels.SOURCES)} sources) {kernels.build_seconds:.1f} s "
          f"compiling; host {cpu_line()}")
    print_kernel_resources(kernels)


def print_kernel_resources(kernels) -> None:
    """Registers, spills and shared memory of every kernel, as ptxas
    reports them: each source compiled once more with -Xptxas -v, all at
    once, into a temporary directory."""
    import re

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ptxas_") as tmp:
        procs = [(src, subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", src,
             "-o", os.path.join(tmp, os.path.basename(src) + ".o")],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
            for src in kernels.SOURCES]
        for src, proc in procs:
            _, err = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"nvcc -Xptxas -v of {src}: {err[-2000:]}")
            found = re.findall(
                r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, (\d+) bytes spill "
                r"loads\s*\n[^\n]*Used (\d+) registers([^\n]*)", err, re.S)
            names = [f[0] for f in found]
            if shutil.which("c++filt"):
                names = subprocess.run(["c++filt", "-p"], input="\n".join(names), text=True,
                                       capture_output=True, check=True).stdout.split("\n")
            rows = []
            for name, (_, stores, loads, regs, rest) in zip(names, found):
                shared = re.search(r"(\d+) bytes smem", rest)
                rows.append(f"{name.rsplit('::', 1)[-1]} {regs} registers, {stores}+{loads} "
                            f"bytes spilled, {shared.group(1) if shared else 0} bytes shared")
            print(f"ptxas, {os.path.basename(src)}: " + "; ".join(rows))


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| of two uint8 tensors, without widening them."""
    return int((torch.maximum(a, b) - torch.minimum(a, b)).max()) if a.numel() else 0


def hold_shuffle_pair(x, ts, keep, path=None, out=None) -> tuple[int, set]:
    """Shuffle ``x``, unshuffle the result plainly and with the ``keep``
    rows raw, each on ``path`` (None: the one shuffle_path picks), and
    hold all three to the plain versions; returns the largest error and
    the paths the launches took."""
    from tpu_blosc_torch.filters import batched, kernels

    before = dict(kernels.launches)
    got = kernels.shuffle_blocks(x, ts, out=out, path=path)
    back = kernels.unshuffle_blocks(got, ts, path=path)
    kept = kernels.unshuffle_blocks(got, ts, keep_raw=keep, path=path)
    torch.cuda.synchronize()
    taken = {k for k, v in kernels.launches.items() if "." in k and v != before[k]}
    what = f"ts={ts} shape={tuple(x.shape)} path={path or 'picked'} -> {sorted(taken)}"
    worst = 0
    for a, b in ((got, batched.shuffle_blocks_plain(x, ts)),
                 (back, batched.unshuffle_blocks_plain(got, ts)), (back, x),
                 (kept, batched.unshuffle_blocks_plain(got, ts, keep))):
        worst = max(worst, max_abs_diff(a, b))
        check(torch.equal(a, b), f"shuffle pair vs plain, {what}")
    check(torch.equal(kept[keep], got[keep]), f"keep_raw rows, {what}")
    return worst, taken


def check_refusals(gen) -> None:
    """Each launcher, handed a path whose preconditions fail, returns an
    error that the wrapper raises, and counts no launch."""
    from tpu_blosc_torch.filters import kernels

    buf = torch.randint(0, 256, (7 * 4096 * 4 + 16,), dtype=torch.uint8,
                        device=DEVICE, generator=gen)
    cases = {
        "source 4 bytes off": (buf[4: 4 + 7 * 16384].view(7, 16384), 4),
        "ts 3": (buf[: 7 * 12288].view(7, 12288), 3),
        "bs/ts = 24": (buf[: 7 * 96].view(7, 96), 4),
        "ts 32": (buf[: 7 * 4096].view(7, 4096), 32),
    }
    for what, (x, ts) in cases.items():
        before = dict(kernels.launches)
        for fn in (kernels.shuffle_blocks, kernels.unshuffle_blocks):
            try:
                fn(x, ts, path="vec16")
            except RuntimeError as e:
                check("CUDA error" in str(e), f"{fn.__name__} refusal names the error: {e}")
            else:
                raise RuntimeError(f"chip_smoke check failed: {fn.__name__} took "
                                   f"path vec16 at {what}")
        check(kernels.launches == before, f"a refused launch was counted ({what})")
    print(f"kernels: both launchers refuse path vec16 at {', '.join(cases)}")


def phase_kernels(gen) -> dict:
    """Each shuffle kernel against its plain version on both paths;
    returns the largest error and the times (for the JSON line)."""
    from tpu_blosc_torch.filters import batched, kernels

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=DEVICE, generator=gen)

    worst = 0
    for ts in (2, 3, 4, 5, 8, 12, 16, 32, 300):
        big = MIB // (8 * ts) * (8 * ts)
        shapes = [(1, 8 * ts), (7, 4096 * ts), (64, big), (5, 24 * ts)]
        if ts == 4:
            shapes.append((16384, 4096))  # chunk.MIN_BLOCK
        seen = set()
        for nb, bs in shapes:
            x = rand(nb, bs)
            keep = torch.rand(nb, device=DEVICE, generator=gen) < 0.5
            keep[0] = nb > 1  # a raw row and, where nb > 1, a filtered one
            err, taken = hold_shuffle_pair(x, ts, keep)
            worst = max(worst, err)
            want = kernels.shuffle_path(bs, ts, x.data_ptr(), x.data_ptr())
            check(taken == {f"shuffle_blocks.{want}", f"unshuffle_blocks.{want}"},
                  f"ts={ts} {(nb, bs)} took {taken}, shuffle_path says {want}")
            seen.add(want)
            if want == "vec16":  # the generic path at the same geometry
                worst = max(worst, hold_shuffle_pair(x, ts, keep, path="generic")[0])
        # unaligned views of the source, and of the destination
        for off in (1, 4, 12):
            nb, bs = 7, 4096 * ts
            buf = rand(nb * bs + 16)
            xv = buf[off: off + nb * bs].view(nb, bs)
            keep = torch.arange(nb, device=DEVICE) % 2 == 0
            outv = torch.empty_like(buf)[16 - off: 16 - off + nb * bs].view(nb, bs)
            for out in (None, outv):
                err, taken = hold_shuffle_pair(xv, ts, keep, out=out)
                worst = max(worst, err)
                # the unshuffles read the shuffle's output: unaligned when out is
                check("shuffle_blocks.generic" in taken and (
                    out is None or "unshuffle_blocks.generic" in taken),
                    f"ts={ts} off={off}: unaligned views took {taken}")
        if ts in kernels.VEC16_TYPE_SIZES:
            check(seen == {"vec16", "generic"}, f"ts={ts}: paths seen {seen}")
        also = "; the vec16 shapes on the generic path too" if "vec16" in seen else ""
        print(f"kernels: ts={ts} equal to the plain versions at {shapes} ({sorted(seen)}"
              f"{also}), and on views 1, 4 and 12 bytes off alignment")

    # past 2**31 bytes: 64-bit block offsets on both paths
    x = rand(2049, MIB)
    keep = torch.arange(2049, device=DEVICE) % 3 == 0
    for path in (None, "generic"):
        err, taken = hold_shuffle_pair(x, 4, keep, path=path)
        worst = max(worst, err)
        print(f"kernels: (2049, {MIB}) ts=4, {x.numel()} bytes, equal to the plain "
              f"versions on {sorted(taken)}")
    del x, keep
    torch.cuda.empty_cache()
    check_refusals(gen)

    # the first timed launches after the checks above read up to 18% slow,
    # the plain version's too: keep the card busy for about 50 ms first
    x = rand(64, MIB)
    cuda_ms(lambda: batched.shuffle_blocks_plain(x, 2), iters=300)
    times = {}
    geometries = [(ts, 64, MIB // (8 * ts) * (8 * ts)) for ts in (2, 3, 4, 8, 16)]
    for ts, nb, bs in geometries + [(4, 16384, 4096)]:
        x = rand(nb, bs)
        s = kernels.shuffle_blocks(x, ts)
        path = kernels.shuffle_path(bs, ts, x.data_ptr(), s.data_ptr())
        fns = {
            "shuffle": lambda: kernels.shuffle_blocks(x, ts),
            "shuffle_plain": lambda: batched.shuffle_blocks_plain(x, ts),
            "unshuffle": lambda: kernels.unshuffle_blocks(s, ts),
            "unshuffle_plain": lambda: batched.unshuffle_blocks_plain(s, ts),
        }
        # the one PyTorch call that computes the same function; the port
        # never calls it outside its plain versions
        ne = bs // ts
        fns["shuffle_library"] = lambda: x.view(nb, ne, ts).transpose(1, 2).contiguous()
        fns["unshuffle_library"] = lambda: s.view(nb, ts, ne).transpose(1, 2).contiguous()
        if path == "vec16":
            fns["shuffle_generic"] = lambda: kernels.shuffle_blocks(x, ts, path="generic")
            fns["unshuffle_generic"] = lambda: kernels.unshuffle_blocks(s, ts, path="generic")
        # two turns, the second in reverse order
        runs = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                runs[k].append(cuda_ms(fns[k]))
        row = {"path": path, **{k: statistics.mean(v) for k, v in runs.items()}}
        times[f"ts{ts} ({nb}, {bs})"] = row
        print(f"kernel times ({nb}, {bs}) ts={ts}, {path} path, ms as turn 1 / turn 2 "
              f"(mean of 20 launches each): " + ", ".join(
                  f"{k} {v[0]:.4f} / {v[1]:.4f} = {x.numel() / statistics.mean(v) / 1e6:.1f} GB/s"
                  for k, v in runs.items())
              + " (GB/s of input bytes; each byte is read once and written once)")
    return {"max_abs_err": worst, "times": times}


def make_cases(tbt, rng) -> list:
    """(name, tensor on DEVICE, options) of the two main-path cells."""
    # A: the README's headline shape (BASELINE.json config 1 scaled up)
    a = torch.arange(16 * MIB, dtype=torch.float32, device=DEVICE)
    opts_a = tbt.Options(codec=tbt.Codec.LZ4, level=5,
                         shuffle=tbt.Shuffle.SHUFFLE, type_size=4)
    # B: BASELINE.json config 3, 64 MB of float64 signal, ZSTD level 5,
    # with one block of random bytes and a ragged tail
    n_b = 8_000_003
    t = np.linspace(0.0, 400.0 * np.pi, n_b)
    signal = 1e3 * np.sin(t) + rng.normal(scale=1e-3, size=n_b)
    signal.view(np.uint8)[5 * MIB : 6 * MIB] = rng.integers(0, 256, MIB, dtype=np.uint8)
    b = torch.from_numpy(signal).to(DEVICE)
    opts_b = tbt.Options(codec=tbt.Codec.ZSTD, level=5,
                         shuffle=tbt.Shuffle.SHUFFLE, type_size=8)
    return [("A f32 ramp LZ4", a, opts_a), ("B f64 signal ZSTD", b, opts_b)]


def run_main_path(tbt, cases) -> list:
    """compress_array and decompress_array(strategy="device") once per
    case, on the card; returns (frame, decoded, kernel launches) per
    case, the launches counted from 0 for each case."""
    from tpu_blosc_torch.filters import kernels

    results = []
    for _, x, opts in cases:
        kernels.reset_launches()
        frame = tbt.compress_array(x, opts)
        y = tbt.decompress_array(frame, x.dtype, device=DEVICE, strategy="device")
        torch.cuda.synchronize()
        results.append((frame, y, dict(kernels.launches)))
    return results


def check_fast_path(name: str, launches: dict) -> None:
    """The path launched both shuffle kernels, each on its vec16 path."""
    for kernel in ("shuffle_blocks", "unshuffle_blocks"):
        check(launches[kernel] >= 1 and launches[f"{kernel}.vec16"] == launches[kernel],
              f"{name}: {kernel} launched on the vec16 path ({launches})")


def check_and_time_case(tbt, name, x, opts, frame, y) -> int:
    """Check one main-path result against the host path, time both paths
    and the stages; returns the number of blocks stored raw."""
    from tpu_blosc_torch import chunk, device as dev, format as fmt

    host_bytes = x.cpu().numpy().tobytes()
    host_frame = tbt.compress_with_options(host_bytes, opts)
    check(frame == host_frame, f"{name}: compress_array frame == host path frame")
    check(y.shape == x.shape and y.dtype == x.dtype and y.device == x.device,
          f"{name}: decoded shape/dtype/device")
    check(torch.equal(dev.tensor_bytes(y), dev.tensor_bytes(x)),
          f"{name}: decompress_array(strategy='device') gives x's bytes")
    check(tbt.decompress(frame) == host_bytes, f"{name}: host decode of the frame")
    header = fmt.parse_header(frame)
    entries, _ = chunk.parse_block_table(frame, header)
    n = len(host_bytes)
    n_raw = sum(m for _, m in entries)

    def compress():
        tbt.compress_array(x, opts)

    def decompress():
        tbt.decompress_array(frame, x.dtype, device=DEVICE, strategy="device")

    t_c = host_s(compress)
    t_d = host_s(decompress)
    t_hc = host_s(lambda: tbt.compress_with_options(host_bytes, opts))
    t_hd = host_s(lambda: tbt.decompress(frame))
    # the alternatives a caller holding a CUDA tensor has: copy the raw
    # bytes over and run the host path, or decode on the host and copy
    t_cc = host_s(lambda: tbt.compress_with_options(x.cpu().numpy(), opts))
    t_dt = host_s(lambda: tbt.decompress_array(frame, x.dtype, device=DEVICE,
                                               strategy="transfer"))

    # where the time goes: the stages of both calls, run one by one
    bs = header.block_size
    nb_full = n // bs
    flat = dev.tensor_bytes(x)
    blocks = flat[: nb_full * bs].view(nb_full, bs)
    staged = torch.empty_like(flat)
    bit = opts.shuffle == tbt.Shuffle.BITSHUFFLE
    kind = "bit-shuffle" if bit else "shuffle"
    t_shuf = host_s(lambda: tbt.filters.filter_blocks(
        blocks, opts.type_size, opts.shuffle, out=staged[: nb_full * bs].view(nb_full, bs)))
    t_d2h = host_s(lambda: staged.cpu())
    filtered = dev._device_filter_fetch(flat, opts, nb_full, bs)
    t_codec = host_s(lambda: dev._compress_array_stage2((filtered, opts, bs)))
    native = chunk.native_pipeline_codec(header.codec, 1)
    t_decode = host_s(lambda: dev._decode_filtered_blocks(frame, header, n, native[0]))
    host_stream, _ = dev._decode_filtered_blocks(frame, header, n, native[0])
    t_h2d = host_s(lambda: host_stream.to(DEVICE))
    on_dev = host_stream.to(DEVICE)
    t_unshuf = host_s(lambda: tbt.filters.unfilter_blocks(
        on_dev[: nb_full * bs].view(nb_full, bs), opts.type_size, opts.shuffle))

    gb = n / 1e9
    print(f"{name}: {n} bytes, {len(entries)} blocks of {bs} ({n_raw} stored raw, "
          f"tail {n - nb_full * bs} bytes), ratio {n / len(frame):.2f}; "
          f"medians of 5: compress_array {gb / t_c:.3f} GB/s ({t_c * 1e3:.3f} ms), "
          f"decompress_array(device) {gb / t_d:.3f} GB/s ({t_d * 1e3:.3f} ms); "
          f"host path on host bytes: compress {gb / t_hc:.3f} GB/s "
          f"({t_hc * 1e3:.3f} ms), decompress {gb / t_hd:.3f} GB/s "
          f"({t_hd * 1e3:.3f} ms); x.cpu() then host compress {gb / t_cc:.3f} GB/s "
          f"({t_cc * 1e3:.3f} ms); decompress_array(transfer) {gb / t_dt:.3f} GB/s "
          f"({t_dt * 1e3:.3f} ms)")
    print(f"{name} stages (ms, medians of 5): compress = {kind} kernel "
          f"{t_shuf * 1e3:.3f} + device-to-host copy {t_d2h * 1e3:.3f} + host codec "
          f"and frame {t_codec * 1e3:.3f}; decompress = host codec "
          f"{t_decode * 1e3:.3f} + host-to-device copy {t_h2d * 1e3:.3f} + "
          f"{kind.replace('shuffle', 'unshuffle')} kernel {t_unshuf * 1e3:.3f}")
    return n_raw


def periodic_rows(rng, nrows: int, seg: int, period: int) -> np.ndarray:
    """Rows tiled with a random pattern of ``period`` bytes, with 1% of
    the bytes changed."""
    pattern = rng.integers(0, 256, (nrows, period), dtype=np.uint8)
    rows = np.tile(pattern, (1, seg // period + 1))[:, :seg].copy()
    hit = rng.random((nrows, seg)) < 0.01
    rows[hit] ^= 0x5A
    return rows


def off_by_4(t: torch.Tensor) -> torch.Tensor:
    """A copy of the contiguous uint8 tensor ``t`` that starts 4 bytes past
    a 16-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=torch.uint8, device=t.device)
    view = buf[4: 4 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def count_rows(rng, seg: int) -> tuple[np.ndarray, dict]:
    """Rows that try the count kernel's edges, and the index each must get
    with match_offsets(seg) (for those where it is plain to see)."""
    distinct = (np.arange(seg) % 251).astype(np.uint8)  # no offset divides by 251
    rows = [distinct, np.full(seg, 7, np.uint8)]
    want = {0: 0, 1: 0}  # no equal bytes; constant: d = 1 has the most
    tie = distinct.copy()
    tie[50], tie[120] = tie[48], tie[116]  # one pair at d = 2, one at d = 4
    want[len(rows)] = 1
    rows.append(tie)
    if seg > 16384 + 2:
        # the only equal pair straddles the edge between two tiles
        for d, index in ((3, 2), (1024, 19)):
            edge = distinct.copy()
            edge[16384 + 1] = edge[16384 + 1 - d]
            want[len(rows)] = index
            rows.append(edge)
    # a periodic row, then a row that goes on with its pattern for 48 bytes
    # and has one equal pair of its own, at d = 1
    pattern = rng.integers(0, 256, 48, dtype=np.uint8)
    rows.append(np.tile(pattern, seg // 48 + 1)[:seg])
    follower = distinct.copy()
    follower[:48] = np.tile(pattern, seg // 48 + 2)[seg: seg + 48]
    follower[100] = follower[99]
    rows.append(follower)
    return np.stack(rows), want


def check_match_refusals(rng) -> None:
    """Each match launcher, handed a path whose preconditions fail or
    arguments out of range, returns cudaErrorInvalidValue, which the
    wrapper raises, and counts no launch."""
    from tpu_blosc_torch.filters import kernels

    aligned = torch.from_numpy(rng.integers(0, 256, (8, 4096), dtype=np.uint8)).to(DEVICE)
    cases = {
        "rows 4 bytes off": off_by_4(aligned),
        "seg 1000": aligned.view(-1)[: 8 * 1000].view(8, 1000),
    }
    for what, x in cases.items():
        row_d = torch.ones(x.shape[0], dtype=torch.int32, device=DEVICE)
        before = dict(kernels.launches)
        for name, fn in (("match_nibble", lambda: kernels.match_nibble(x, row_d, 16, 8, path="vec16")),
                         ("match_mask", lambda: kernels.match_mask(x, row_d, 16, 8, path="vec16")),
                         ("match_count", lambda: kernels.match_count(x, (1, 2, 3), path="vec16"))):
            try:
                fn()
            except RuntimeError as e:
                check("CUDA error 1" in str(e), f"{name} refusal names the error: {e}")
            else:
                raise RuntimeError(f"chip_smoke check failed: {name} took path vec16 at {what}")
        check(kernels.launches == before, f"a refused match launch was counted ({what})")
    lib = kernels.lib()
    stream = torch.cuda.current_stream().cuda_stream
    row_d = torch.ones(8, dtype=torch.int32, device=DEVICE)
    out = torch.empty((8, 1024), dtype=torch.uint8, device=DEVICE)
    offs = torch.ones(33, dtype=torch.int32, device=DEVICE)
    counts = torch.zeros((8, 33), dtype=torch.int32, device=DEVICE)
    best = torch.empty(8, dtype=torch.int64, device=DEVICE)
    ptr = aligned.data_ptr()
    rcs = {
        "T = 10": lib.tpbt_match_nibble(ptr, row_d.data_ptr(), out.data_ptr(), 8, 4096, 16, 10, 1, stream),
        "tail < 0": lib.tpbt_match_nibble(ptr, row_d.data_ptr(), out.data_ptr(), 8, 4096, -1, 8, 0, stream),
        "seg % 4": lib.tpbt_match_nibble(ptr, row_d.data_ptr(), out.data_ptr(), 8, 4094, 16, 8, 0, stream),
        "path 2": lib.tpbt_match_nibble(ptr, row_d.data_ptr(), out.data_ptr(), 8, 4096, 16, 8, 2, stream),
        "a packed mask at seg % 8": lib.tpbt_match_mask(ptr, row_d.data_ptr(), out.data_ptr(),
                                                        counts.data_ptr(), 8, 4092, 16, 8, 0, stream),
        "33 offsets": lib.tpbt_match_count(ptr, offs.data_ptr(), counts.data_ptr(), best.data_ptr(),
                                           8, 4096, 33, 1, stream),
        "no offsets": lib.tpbt_match_count(ptr, offs.data_ptr(), counts.data_ptr(), best.data_ptr(),
                                           8, 4096, 0, 0, stream),
    }
    check(set(rcs.values()) == {1}, f"the match launchers refuse bad arguments: {rcs}")
    print(f"kernels: both match launchers refuse path vec16 at {', '.join(cases)}, "
          f"and {', '.join(rcs)}")


def phase_match_kernel(rng) -> dict:
    """The mask and the count kernel against their plain versions at seven
    segment lengths, each on both paths; returns the largest errors."""
    from tpu_blosc_torch import match as tm
    from tpu_blosc_torch.filters import kernels, match as fm

    worst = {"nibble": 0, "count": 0}
    kernels.reset_launches()

    def compare(segs, row_d, what, tail=fm.ROW_TAIL_LITERALS, T=fm.MATCH_T):
        """The mask kernel on aligned rows (the picked path and the
        generic one) and on a view 4 bytes off, against the plain version."""
        want = fm.match_nibble_plain(segs, row_d, tail, T)
        picked = kernels.match_path(segs.shape[1], segs.data_ptr())
        for x, path in ((segs, None), (segs, "generic"), (off_by_4(segs), None)):
            before = dict(kernels.launches)
            got = kernels.match_nibble(x, row_d, tail, T, path=path)
            torch.cuda.synchronize()
            took = "generic" if path or x is not segs else picked
            check(kernels.launches[f"match_nibble.{took}"] == before[f"match_nibble.{took}"] + 1,
                  f"match kernel took the {took} path, {what}")
            worst["nibble"] = max(worst["nibble"], int((got.int() - want.int()).abs().max()))
            check(torch.equal(got, want), f"match kernel ({took}) vs plain, {what}")
            if segs.shape[1] % 8 == 0:  # the same kernel's packed form
                counts, packed = kernels.match_mask(x, row_d, tail, T, path=path)
                want_counts, want_packed = fm.literal_mask_plain(segs, row_d, tail, T)
                torch.cuda.synchronize()
                worst["nibble"] = max(worst["nibble"], max_abs_diff(packed, want_packed),
                                      int((counts - want_counts).abs().max()))
                check(torch.equal(packed, want_packed) and torch.equal(counts, want_counts),
                      f"match kernel's packed mask and counts ({took}) vs plain, {what}")
        return want

    def compare_count(segs, offsets, what):
        want = fm.count_best_plain(segs, offsets)
        for x, path in ((segs, None), (segs, "generic"), (off_by_4(segs), None)):
            got = kernels.match_count(x, offsets, path=path)
            torch.cuda.synchronize()
            check(got.dtype == torch.int64 and got.shape == want.shape,
                  f"count kernel gives one int64 index a row, {what}")
            worst["count"] = max(worst["count"], int((got - want).abs().max()))
            check(torch.equal(got, want), f"count kernel vs plain, {what}: "
                  f"{got.tolist()} != {want.tolist()}")
        return want

    # 18440 and 20480: a short last tile after a whole one, on each path
    for seg in (256, 1000, 4096, 16384, 18440, 20480, 262144):
        nrows = 64 if seg < 262144 else 16
        offsets = [d for d in (1, 3, 48, 1024, 3000) if d < seg] + [seg - 20]
        half = nrows // 2
        rows = np.concatenate([
            rng.integers(0, 256, (half, seg), dtype=np.uint8),
            np.concatenate([periodic_rows(rng, 1, seg, offsets[i % len(offsets)])
                            for i in range(half)]),
        ])
        segs = torch.from_numpy(rows).to(DEVICE)
        lit = {}
        for d in offsets:
            row_d = torch.full((nrows,), d, dtype=torch.int32, device=DEVICE)
            got = compare(segs, row_d, f"seg={seg} d={d}")
            lit[d] = int(sum(int(((got >> t) & 1).sum()) for t in range(4)))
        mixed = torch.tensor([offsets[i % len(offsets)] for i in range(nrows)],
                             dtype=torch.int32, device=DEVICE)
        compare(segs, mixed, f"seg={seg} mixed offsets")
        check(lit[seg - 20] == nrows * seg, f"seg={seg}: d = seg - 20 leaves every byte literal")
        if seg == 4096:
            for T, tail in ((1, 0), (1, 16), (3, 5), (8, 0), (9, 16), (9, 5)):
                compare(segs, mixed, f"seg={seg} mixed offsets T={T} tail={tail}", tail, T)
        print(f"match kernel: seg={seg}, {nrows} rows (half random, half periodic "
              f"with 1% breaks), equal to the plain version at d={offsets} and mixed, "
              f"on both paths and 4 bytes off alignment; literal bytes per d: {lit}")

        lists = {f"{len(tm.match_offsets(seg))} candidates": tm.match_offsets(seg)}
        if seg > 256:
            lists["14 candidates"] = tm.match_offsets(256)
        if seg > 3000:
            lists["with an offset above the halo"] = (1, 48, 3000, seg - 20)
        edge_rows, want = count_rows(rng, seg)
        edges = torch.from_numpy(edge_rows).to(DEVICE)
        for name, offs in lists.items():
            offs = tuple(d for d in offs if d < seg)
            best = compare_count(segs, offs, f"seg={seg} {name}")
            edge_best = compare_count(edges, offs, f"seg={seg} {name}, edge rows")
            if offs == tm.match_offsets(seg):
                for row, index in want.items():
                    check(int(edge_best[row]) == index,
                          f"seg={seg}: edge row {row} gets index {index}, not {int(edge_best[row])}")
                print(f"count kernel: seg={seg}, equal to the plain version on the {nrows} rows "
                      f"and {len(edge_rows)} edge rows with {', '.join(lists)}, on both paths "
                      f"and 4 bytes off alignment; offsets picked {sorted(set(np.asarray(offs)[best.cpu().numpy()].tolist()))}, "
                      f"edge rows {edge_best.tolist()}")

    taken = dict(kernels.launches)
    for kernel in ("match_nibble", "match_count"):
        check(all(taken[f"{kernel}.{path}"] >= 1 for path in kernels.MATCH_PATHS),
              f"{kernel} ran on both paths ({taken})")
    check_match_refusals(rng)
    return {"max_abs_err": worst["nibble"], "count_max_abs_err": worst["count"]}


def phase_probe_kernel(rng) -> dict:
    """The probe kernel against its plain version; returns the largest
    error and the times at (32768, 512)."""
    from tpu_blosc_torch.filters import kernels, probe as tp

    worst = 0
    inputs = {
        "1 tile, 300 KB structured": np.tile(np.arange(7, dtype=np.uint8), 300_000 // 7),
        "2 tiles, 1.5 MB random": rng.integers(0, 256, 1_500_000, dtype=np.uint8),
        "4 tiles, 3.9 MB small alphabet": rng.integers(0, 3, 3_900_000, dtype=np.uint8),
    }
    for name, data in inputs.items():
        words = tp.probe_ready(data, device=DEVICE)
        got = kernels.probe_tiles(words)
        want = tp.probe_tiles_plain(words)
        torch.cuda.synchronize()
        worst = max(worst, int((got - want).abs().max()))
        check(torch.equal(got, want), f"probe kernel vs plain, {name}")
        print(f"probe kernel: {name}: per-tile (runs, byte sum) {got.tolist()}, "
              f"equal to the plain version")
    words = torch.from_numpy(
        rng.integers(-(2**31), 2**31, (32768, 512), dtype=np.int32)).to(DEVICE)
    got = kernels.probe_tiles(words)
    want = tp.probe_tiles_plain(words)
    torch.cuda.synchronize()
    worst = max(worst, int((got - want).abs().max()))
    check(torch.equal(got, want), "probe kernel vs plain, (32768, 512)")
    t = {
        "ms": cuda_ms(lambda: kernels.probe_tiles(words)),
        "plain_ms": cuda_ms(lambda: tp.probe_tiles_plain(words), iters=10),
    }
    print(f"probe kernel: (32768, 512) random, 64 tiles: runs {got[:, 0].sum().item()}, "
          f"byte sum {got[:, 1].sum().item()}, equal to the plain version; kernel "
          f"{t['ms']:.4f} ms = {words.numel() * 4 / t['ms'] / 1e6:.1f} GB/s, plain "
          f"{t['plain_ms']:.4f} ms = {words.numel() * 4 / t['plain_ms'] / 1e6:.1f} GB/s")
    return {"max_abs_err": worst, **t}


def match_data() -> np.ndarray:
    """256 MiB of float32: a tiled 256-element random pattern plus 1%
    noise (bench.py:223-233, numpy seed 5)."""
    rng = np.random.default_rng(5)
    n_el = 64 * MIB
    data = np.tile(rng.random(256).astype(np.float32), n_el // 256)
    hit = rng.choice(data.size, data.size // 100, replace=False)
    data[hit] += rng.random(hit.size).astype(np.float32) * 0.01
    return data


def run_path_c(tbt, x, opts):
    frame = tbt.compress_array(x, opts, strategy="match")
    y = tbt.decompress_array(frame, x.dtype, device=DEVICE, strategy="device")
    torch.cuda.synchronize()
    return frame, y


def check_and_time_path_c(tbt, x, opts, frame, y) -> dict:
    """Check path C's result and time it beside the transfer route and
    stage by stage; returns, for the mask and the count kernel, the
    kernel's and its plain version's times, the largest difference and
    the bound on the path's own segments."""
    from tpu_blosc_torch import chunk, device as dev, match as tm
    from tpu_blosc_torch.filters import kernels, match as fm
    from tpu_blosc_torch.native import backend as nb

    host_bytes = x.cpu().numpy().tobytes()
    transfer = tbt.compress_array(x, opts)
    check(frame != transfer, "C: the match frame differs from the transfer frame")
    check(tbt.decompress(frame) == host_bytes, "C: host decode of the match frame")
    check(torch.equal(dev.tensor_bytes(y), dev.tensor_bytes(x)),
          "C: decompress_array(strategy='device') gives x")
    part = x[: 4 * MIB]
    check(tbt.compress_array(part, opts, strategy="match")
          == tbt.compress_array(part.cpu(), opts, strategy="match"),
          "C: the CUDA route's frame equals the CPU route's on 16 MiB")

    n = x.numel() * 4
    gb = n / 1e9
    t_m = host_s(lambda: tbt.compress_array(x, opts, strategy="match"), reps=3)
    t_t = host_s(lambda: tbt.compress_array(x, opts), reps=3)
    t_d = host_s(lambda: tbt.decompress_array(frame, x.dtype, device=DEVICE,
                                              strategy="device"), reps=3)
    print(f"C f32 tiled + 1% noise, LZ4 match: {n} bytes, ratio {n / len(frame):.2f} "
          f"(transfer frame {n / len(transfer):.2f}); medians of 3: "
          f"compress_array(match) {gb / t_m:.3f} GB/s ({t_m * 1e3:.3f} ms), "
          f"compress_array(transfer) {gb / t_t:.3f} GB/s ({t_t * 1e3:.3f} ms), "
          f"decompress_array(device) of the match frame {gb / t_d:.3f} GB/s "
          f"({t_d * 1e3:.3f} ms)")

    # the stages of compress_array_match, run one by one
    bs, ts = opts.block_size, 4
    seg, nb_full = bs // ts, n // bs
    flat = dev.tensor_bytes(x)
    offsets = tm.match_offsets(seg)
    blocks = flat.view(nb_full, bs)
    segs = tbt.filters.shuffle_blocks(blocks, ts).view(-1, seg)
    best = fm.count_best(segs, offsets)
    offs = torch.tensor(offsets, dtype=torch.int32, device=DEVICE)
    row_d = offs[best]
    lit_counts_d, packed = tm.literal_mask(segs, row_d)
    lit_counts = lit_counts_d.cpu().numpy().astype(np.int64)
    d_all = np.asarray(offsets, dtype=np.int32)[best.cpu().numpy()]
    sparse = lit_counts <= seg // 10
    dense_idx = np.flatnonzero(~sparse)
    n_real = int(lit_counts[sparse].sum())
    mask = packed.cpu().numpy().reshape(-1)
    pos = nb.mask_positions(mask, n_real)
    vals = tm.gather_values(segs, pos)
    dense = tm.gather_rows(segs, dense_idx.astype(np.int32)) if dense_idx.size else None
    payloads, entries = tm.emit_blocks(opts, seg, bs, nb_full, d_all, sparse, pos,
                                       vals, dense_idx, dense)
    stages = {
        "shuffle kernel": lambda: tbt.filters.shuffle_blocks(blocks, ts),
        "count kernel": lambda: fm.count_best(segs, offsets),
        "mask kernel": lambda: fm.literal_mask(segs, row_d),
        "mask (kernel, then the rows over seg/10 zeroed)": lambda: tm.literal_mask(segs, row_d),
        "mask copy": lambda: packed.cpu(),
        "position scan": lambda: nb.mask_positions(mask, n_real),
        "gather and value copy": lambda: tm.gather_values(segs, pos),
        "dense rows": lambda: (tm.gather_rows(segs, dense_idx.astype(np.int32))
                               if dense_idx.size else None),
        "emit and re-encode": lambda: tm.emit_blocks(opts, seg, bs, nb_full, d_all,
                                                     sparse, pos, vals, dense_idx, dense),
        "frame": lambda: chunk.split_header(opts, n, bs, entries, sum(map(len, payloads)))
        + b"".join(payloads),
    }
    times = {k: host_s(f, reps=3) * 1e3 for k, f in stages.items()}
    print(f"C stages (ms, medians of 3): " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    print(f"C records: {int(sparse.sum())} of {sparse.size} rows sparse, {n_real} literals "
          f"({n_real / n:.4%} of bytes), {len(dense_idx)} dense rows, offsets used "
          f"{sorted(set(d_all.tolist()))}, {sum(1 for e in entries if e & 0x80000000)} "
          f"blocks stored raw")

    got = kernels.match_nibble(segs, row_d, fm.ROW_TAIL_LITERALS, fm.MATCH_T)
    want = fm.match_nibble_plain(segs, row_d)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"match kernel vs plain on C's segments {tuple(segs.shape)}")
    err = int((got.int() - want.int()).abs().max())
    best_plain = fm.count_best_plain(segs, offsets)
    check(torch.equal(best, best_plain),
          f"count kernel vs plain on C's segments {tuple(segs.shape)}")
    del want
    # keep the card busy for about 50 ms before timing (see phase_kernels)
    cuda_ms(lambda: kernels.match_nibble(segs, row_d, 16, 8), iters=100)
    counts, packed_k = kernels.match_mask(segs, row_d, 16, 8)
    want_counts, want_packed = fm.literal_mask_plain(segs, row_d)
    torch.cuda.synchronize()
    check(torch.equal(packed_k, want_packed) and torch.equal(counts, want_counts),
          f"match kernel's packed mask and counts vs plain on C's segments")
    err = max(err, max_abs_diff(packed_k, want_packed), int((counts - want_counts).abs().max()))
    del want_packed, packed_k
    fns = {
        "mask": lambda: kernels.match_mask(segs, row_d, 16, 8),
        "mask_generic": lambda: kernels.match_mask(segs, row_d, 16, 8, path="generic"),
        "mask_plain": lambda: fm.literal_mask_plain(segs, row_d),
        "nibble": lambda: kernels.match_nibble(segs, row_d, 16, 8),
        "nibble_generic": lambda: kernels.match_nibble(segs, row_d, 16, 8, path="generic"),
        "nibble_plain": lambda: fm.match_nibble_plain(segs, row_d),
        "count": lambda: kernels.match_count(segs, offsets),
        "count_generic": lambda: kernels.match_count(segs, offsets, path="generic"),
        "count_plain": lambda: fm.count_best_plain(segs, offsets),
    }
    runs = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):  # two turns, the second reversed
        for k in order:
            plain = k.endswith("plain")
            runs[k].append(cuda_ms(fns[k], iters=3 if plain else 20, warmup=1 if plain else 3))
    ms = {k: statistics.mean(v) for k, v in runs.items()}
    nseg = segs.shape[0]
    # what the functions must move and do on these inputs: the mask reads
    # each byte and each row's offset once and writes a bit a byte and a
    # count a row (packed form, the one path C runs) or a nibble byte per 4
    # bytes, with one compare and 2 (T - 1) bit operations a position; the
    # count reads each byte and the offsets once and writes an index a row,
    # with one compare and one add for each position at or past each offset
    mask_ops = segs.numel() * (1 + 2 * (fm.MATCH_T - 1))
    bounds = {
        "mask": bound(segs.numel() + 4 * nseg + segs.numel() // 8 + 4 * nseg, mask_ops),
        "nibble": bound(segs.numel() + 4 * nseg + segs.numel() // 4,
                        mask_ops),
        "count": bound(segs.numel() + 4 * len(offsets) + 8 * nseg,
                       2 * nseg * sum(seg - d for d in offsets)),
    }
    print(f"match kernel times on C's segments {tuple(segs.shape)} at their offsets, ms as "
          f"turn 1 / turn 2 (mean of 20 launches each, the plain versions of 3): " + ", ".join(
              f"{k} {v[0]:.4f} / {v[1]:.4f} = {segs.numel() / statistics.mean(v) / 1e6:.1f} GB/s"
              for k, v in runs.items())
          + f" (GB/s of input bytes); equal outputs; bounds: " + ", ".join(
              f"{k} {b['bound_ms']:.4f} ms by {b['bound_by']}" for k, b in bounds.items()))
    return {
        # the kernel in the form path C launches, and in its nibble form
        "nibble": {"max_abs_err": err, "ms": ms["mask"], "generic_ms": ms["mask_generic"],
                   "plain_ms": ms["mask_plain"], **bounds["mask"],
                   "nibble_form": {"ms": ms["nibble"], "generic_ms": ms["nibble_generic"],
                                   "plain_ms": ms["nibble_plain"], **bounds["nibble"]}},
        "count": {"max_abs_err": int((best - best_plain).abs().max()), "ms": ms["count"],
                  "generic_ms": ms["count_generic"], "plain_ms": ms["count_plain"],
                  **bounds["count"]},
    }


def phase_advisors(tbt, rng, cases) -> dict:
    """suggest_codec and suggest_options on the card; returns the probe
    kernel's launches in those calls."""
    from tpu_blosc_torch import api
    from tpu_blosc_torch.filters import kernels, probe as tp

    datasets = [(name, x.cpu().numpy().tobytes(), opts.type_size) for name, x, opts in cases]
    datasets.append(("random bytes", rng.integers(0, 256, 64 * MIB, dtype=np.uint8).tobytes(), 1))
    kernels.reset_launches()
    advice = [(tbt.suggest_codec(data, type_size=ts), tbt.suggest_options(data, type_size=ts))
              for _, data, ts in datasets]
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    check(launches["probe_tiles"] >= len(datasets), "probe kernel launched by suggest_codec")
    for (name, data, ts), (codec, options) in zip(datasets, advice):
        sample = api._probe_sample(data, 1 << 22, ts)
        shuffled = tbt.filters.shuffle_bytes(sample, ts) if ts > 1 else np.frombuffer(sample, np.uint8)
        stats = tp.stream_probe(shuffled.tobytes())
        print(f"advisors, {name} ({len(data)} bytes, ts {ts}): suggest_codec {codec.name}, "
              f"suggest_options {options.codec.name}/{options.shuffle.name}; probe on the "
              f"card: run_fraction {stats['run_fraction']:.6f}, mean_byte "
              f"{stats['mean_byte']:.4f}, n {stats['n']}; NumPy all-pairs run_fraction "
              f"{api._run_fraction(shuffled):.6f}")
    return launches


def hold_bit_pair(x, ts, keep, out=None) -> int:
    """Bit-shuffle ``x``, bit-unshuffle the result plainly and with the
    ``keep`` rows raw, and hold all three to the plain versions; returns
    the largest error."""
    from tpu_blosc_torch.filters import batched, kernels

    got = kernels.bit_shuffle_blocks(x, ts, out=out)
    back = kernels.bit_unshuffle_blocks(got, ts)
    kept = kernels.bit_unshuffle_blocks(got, ts, keep_raw=keep)
    torch.cuda.synchronize()
    what = f"ts={ts} shape={tuple(x.shape)} at offset {x.data_ptr() % 16}"
    worst = 0
    for a, b in ((got, batched.bit_shuffle_blocks_plain(x, ts)),
                 (back, batched.bit_unshuffle_blocks_plain(got, ts)), (back, x),
                 (kept, batched.bit_unshuffle_blocks_plain(got, ts, keep))):
        worst = max(worst, max_abs_diff(a, b))
        check(torch.equal(a, b), f"bit-shuffle pair vs plain, {what}")
    check(torch.equal(kept[keep], got[keep]), f"bit keep_raw rows, {what}")
    return worst


def check_bit_refusals(gen) -> None:
    """bs % (8 ts) != 0: each wrapper raises before launching, and each
    launcher, called directly, refuses with CUDA error 1
    (cudaErrorInvalidValue) and counts no launch."""
    from tpu_blosc_torch.filters import kernels

    stream = torch.cuda.current_stream().cuda_stream
    for ts, bs in ((4, 8 * 4 * 10 + 4), (2, 8 * 2 * 3 + 8), (3, 9)):
        x = torch.randint(0, 256, (7, bs), dtype=torch.uint8, device=DEVICE, generator=gen)
        out = torch.empty_like(x)
        before = dict(kernels.launches)
        for fn in (kernels.bit_shuffle_blocks, kernels.bit_unshuffle_blocks):
            try:
                fn(x, ts)
            except ValueError as e:
                check("8*type_size" in str(e), f"{fn.__name__} refusal names the rule: {e}")
            else:
                raise RuntimeError(f"chip_smoke check failed: {fn.__name__} took bs={bs} ts={ts}")
        lib = kernels.lib()
        rcs = (lib.tpbt_bitshuffle_blocks(x.data_ptr(), out.data_ptr(), 7, bs, ts, stream),
               lib.tpbt_bitunshuffle_blocks(x.data_ptr(), out.data_ptr(), None, 7, bs, ts,
                                            stream))
        check(rcs == (1, 1), f"the launchers refuse bs={bs} ts={ts}: {rcs}")
        check(kernels.launches == before, f"a refused bit-shuffle launch was counted (ts={ts})")
    print("kernels: both bit-shuffle wrappers and launchers refuse bs % (8 ts) != 0")


def phase_bit_kernels(gen) -> dict:
    """The bit-shuffle pair against its plain versions; returns the
    largest error and the times at (64, 1 MiB)."""
    from tpu_blosc_torch.filters import batched, kernels

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=DEVICE, generator=gen)

    worst = 0
    for ts in (2, 3, 4, 5, 8, 16, 32):
        shapes = [(1, 8 * ts), (7, 512 * 8 * ts), (64, MIB // (8 * ts) * (8 * ts))]
        for nb, bs in shapes:
            keep = torch.rand(nb, device=DEVICE, generator=gen) < 0.5
            keep[0] = nb > 1
            worst = max(worst, hold_bit_pair(rand(nb, bs), ts, keep))
        for off in (1, 4):  # views of the source, and of the destination
            nb, bs = 7, 512 * 8 * ts
            buf = rand(nb * bs + 16)
            xv = buf[off: off + nb * bs].view(nb, bs)
            outv = torch.empty_like(buf)[16 - off: 16 - off + nb * bs].view(nb, bs)
            keep = torch.arange(nb, device=DEVICE) % 2 == 0
            for out in (None, outv):
                worst = max(worst, hold_bit_pair(xv, ts, keep, out=out))
        print(f"kernels: bit-shuffle ts={ts} equal to the plain versions at {shapes}, "
              f"and on views 1 and 4 bytes off alignment")
    check_bit_refusals(gen)

    times = {}
    for ts in (2, 4, 8):
        nb, bs = 64, MIB
        x = rand(nb, bs)
        s = kernels.bit_shuffle_blocks(x, ts)
        buf = rand(nb * bs + 16)
        xo = buf[4: 4 + nb * bs].view(nb, bs)  # the launcher's generic path
        so = torch.empty_like(buf)[4: 4 + nb * bs].view(nb, bs)
        kernels.bit_shuffle_blocks(xo, ts, out=so)
        fns = {
            "shuffle": lambda: kernels.bit_shuffle_blocks(x, ts),
            "shuffle_plain": lambda: batched.bit_shuffle_blocks_plain(x, ts),
            "shuffle_offset4": lambda: kernels.bit_shuffle_blocks(xo, ts),
            "unshuffle": lambda: kernels.bit_unshuffle_blocks(s, ts),
            "unshuffle_plain": lambda: batched.bit_unshuffle_blocks_plain(s, ts),
            "unshuffle_offset4": lambda: kernels.bit_unshuffle_blocks(so, ts),
        }
        runs = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):  # two turns, the second reversed
            for k in order:
                runs[k].append(cuda_ms(fns[k], iters=10 if "plain" in k else 20))
        times[f"ts{ts} ({nb}, {bs})"] = {k: statistics.mean(v) for k, v in runs.items()}
        print(f"bit-shuffle kernel times ({nb}, {bs}) ts={ts}, ms as turn 1 / turn 2: " + ", ".join(
            f"{k} {v[0]:.4f} / {v[1]:.4f} = {x.numel() / statistics.mean(v) / 1e6:.1f} GB/s"
            for k, v in runs.items()) + " (GB/s of input bytes; offset4: views 4 bytes off "
            "a 16-byte boundary, which take the generic path)")
        del x, s, buf, xo, so
    return {"max_abs_err": worst, "times": times}


def make_bit_cases(tbt, rng) -> list:
    """(name, tensor on DEVICE, options) of the two bit-shuffle cells."""
    # D: bench.py:157-158's bitshuffle data, scaled as A scales the README shape
    d = torch.linspace(0, 1, 16 * MIB, dtype=torch.float32, device=DEVICE)
    opts_d = tbt.Options(codec=tbt.Codec.LZ4, level=5,
                         shuffle=tbt.Shuffle.BITSHUFFLE, type_size=4)
    # E: BASELINE.json config 4, int16 sensor data: a 12-bit ADC reading a
    # slow sine with a little noise, one block of random bytes, and a tail
    # of 2304 groups of 8 samples and 5 samples more
    n_e = 32_000_005
    t = np.arange(n_e) / 20_000.0
    adc = 2048 + 1500 * np.sin(2 * np.pi * 3.0 * t) + rng.normal(scale=4.0, size=n_e)
    e = np.clip(np.rint(adc), 0, 4095).astype(np.int16)
    e.view(np.uint8)[20 * MIB : 21 * MIB] = rng.integers(0, 256, MIB, dtype=np.uint8)
    opts_e = tbt.Options(codec=tbt.Codec.LZ4, level=5,
                         shuffle=tbt.Shuffle.BITSHUFFLE, type_size=2)
    return [("D f32 linspace LZ4 bitshuffle", d, opts_d),
            ("E i16 ADC LZ4 bitshuffle", torch.from_numpy(e).to(DEVICE), opts_e)]


def check_bit_path(name: str, launches: dict) -> None:
    """The path launched both bit-shuffle kernels."""
    for kernel in ("bit_shuffle_blocks", "bit_unshuffle_blocks"):
        check(launches[kernel] >= 1, f"{name}: {kernel} launched ({launches})")


GPT2_MEDIUM = {"n_layer": 24, "n_embd": 1024, "vocab_size": 50257, "n_positions": 1024}
# what that config holds: 12 tensors a layer and 4 more, and their values
GPT2_TENSORS, GPT2_VALUES = 292, 354_823_168


def gpt2_medium_state(seed: int, n_layer: int | None = None) -> dict:
    """The parameter shapes of the public gpt2-medium config (292 tensors,
    354,823,168 values), N(0, 0.02) in bfloat16, made on the card from
    ``seed``, in the original GPT-2 names; ``n_layer`` cuts the depth."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    c = GPT2_MEDIUM
    e = c["n_embd"]

    def w(*shape):
        x = torch.randn(shape, generator=gen, device=DEVICE, dtype=torch.float32)
        return (x * 0.02).to(torch.bfloat16)

    def dense(n_in, n_out):
        return {"w": w(n_in, n_out), "b": w(n_out)}

    def layer():
        return {"ln_1": {"g": w(e), "b": w(e)},
                "attn": {"c_attn": dense(e, 3 * e), "c_proj": dense(e, e)},
                "ln_2": {"g": w(e), "b": w(e)},
                "mlp": {"c_fc": dense(e, 4 * e), "c_proj": dense(4 * e, e)}}

    params = {"wte": w(c["vocab_size"], e), "wpe": w(c["n_positions"], e),
              "h": [layer() for _ in range(c["n_layer"] if n_layer is None else n_layer)],
              "ln_f": {"g": w(e), "b": w(e)}}
    rng = torch.tensor([seed, seed + 1], dtype=torch.int64, device=DEVICE)
    return {"params": params, "step": 1000, "rng": rng}


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def run_path_f(tbt, state, opts, workdir):
    """The checkpoint path: save_pytree, the two loads onto the card and
    load_leaf; returns (file path, loaded trees, leaf, wall seconds)."""
    path = os.path.join(workdir, "gpt2-medium.tpbs")
    t0 = time.perf_counter()
    tbt.save_pytree(path, state, opts)
    t_save = time.perf_counter() - t0
    loads, t_loads = {}, {}
    for strategy in ("transfer", "device"):
        t0 = time.perf_counter()
        loads[strategy] = tbt.load_pytree(path, device=True, strategy=strategy)
        torch.cuda.synchronize()
        t_loads[strategy] = time.perf_counter() - t0
    leaf = tbt.load_leaf(path, "params/h/12/mlp/c_fc/w", device=True)
    torch.cuda.synchronize()
    return path, loads, leaf, t_save, t_loads


def check_path_f(tbt, state, opts, path, loads, leaf, t_save, t_loads, workdir) -> None:
    """F's file against the CPU route's, and every load against the state."""
    tensors = [x for x in tree_leaves(state) if isinstance(x, torch.Tensor)]
    n_values = sum(x.numel() for x in tensors if x.dtype == torch.bfloat16)
    check(len(tensors) - 1 == GPT2_TENSORS and n_values == GPT2_VALUES,
          f"F: GPT-2 medium has {GPT2_TENSORS} parameter tensors of {GPT2_VALUES} values "
          f"({len(tensors) - 1}, {n_values}; the other tensor is rng)")
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    size = os.path.getsize(path)
    cpu_state = tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, state)
    cpu_path = os.path.join(workdir, "gpt2-medium-cpu.tpbs")
    t0 = time.perf_counter()
    tbt.save_pytree(cpu_path, cpu_state, opts)
    t_cpu = time.perf_counter() - t0
    with open(path, "rb") as a, open(cpu_path, "rb") as b:
        same = a.read() == b.read()
    check(same, "F: the file equals the one save_pytree writes from the tree on the CPU")
    os.remove(cpu_path)
    for strategy, loaded in loads.items():
        got = tree_leaves(loaded)
        check(len(got) == len(tree_leaves(state)), f"F: {strategy} load has every leaf")
        for x, y in zip(tree_leaves(state), got):
            if isinstance(x, torch.Tensor):
                check(y.device == x.device and y.dtype == x.dtype and torch.equal(x, y),
                      f"F: {strategy} load gives the leaf back exactly")
            else:
                check(x == y, f"F: {strategy} load gives {x!r} back")
    check(torch.equal(leaf, state["params"]["h"][12]["mlp"]["c_fc"]["w"]),
          "F: load_leaf of params/h/12/mlp/c_fc/w")
    gb = nbytes / 1e9
    print(f"F GPT-2 medium checkpoint: {len(tensors) - 1} parameter tensors, {n_values} "
          f"bf16 values, {nbytes} bytes, file {size} bytes, ratio {nbytes / size:.3f}; "
          f"save_pytree {t_save:.3f} s = {gb / t_save:.3f} GB/s; load_pytree(device=True) "
          f"transfer {t_loads['transfer']:.3f} s = {gb / t_loads['transfer']:.3f} GB/s, "
          f"device {t_loads['device']:.3f} s = {gb / t_loads['device']:.3f} GB/s; "
          f"save_pytree of the tree moved to the CPU {t_cpu:.3f} s (moves not timed)")


def rle_rows(rng, seg: int, nrand: int) -> np.ndarray:
    """Rows that try the rle kernels' edges: random bytes, a small
    alphabet, a staircase, a start at every byte, two rows of one run
    each, side by side (the first ends with the byte the second begins
    with), runs that straddle the tile edges of both kernels (4096 and
    16384), and a one-byte run at the row's end."""
    rows = [rng.integers(0, 256, seg, dtype=np.uint8) for _ in range(nrand)]
    rows += [rng.integers(0, 2, seg, dtype=np.uint8) for _ in range(nrand)]
    rows.append((np.arange(seg) // 64).astype(np.uint8))
    rows.append((np.arange(seg) % 2).astype(np.uint8))
    rows += [np.full(seg, 7, np.uint8), np.full(seg, 7, np.uint8)]
    edge = np.zeros(seg, np.uint8)
    for t in (4096, 3 * 4096, 16384):
        if t + 5 < seg:
            edge[t - 3: t + 5] = 9
    last = np.zeros(seg, np.uint8)
    last[-1] = 1
    return np.stack(rows + [edge, last])


def row_bases(counts: np.ndarray) -> np.ndarray:
    """Each row's first record, and one entry more: the exclusive sum."""
    bases = np.zeros(counts.size + 1, dtype=np.int64)
    np.cumsum(counts, out=bases[1:])
    return bases


def check_rle_refusals(rng) -> None:
    """Each rle launcher, handed a path whose preconditions fail or
    arguments out of range, returns cudaErrorInvalidValue, which the
    wrapper raises, and counts no launch."""
    from tpu_blosc_torch.filters import kernels

    aligned = torch.from_numpy(rng.integers(0, 4, (8, 4096), dtype=np.uint8)).to(DEVICE)
    cases = {
        "rows 4 bytes off": off_by_4(aligned),
        "seg 1000": aligned.view(-1)[: 8 * 1000].view(8, 1000),
    }
    rows = torch.arange(8, dtype=torch.int64, device=DEVICE)
    bases = torch.arange(9, dtype=torch.int64, device=DEVICE) * 4096
    for what, x in cases.items():
        before = dict(kernels.launches)
        for name, fn in (("seg_run_counts", lambda: kernels.seg_run_counts(x, path="vec16")),
                         ("rows_rle", lambda: kernels.rows_rle(x, rows, bases, 8 * 4096,
                                                               path="vec16"))):
            try:
                fn()
            except RuntimeError as e:
                check("CUDA error 1" in str(e), f"{name} refusal names the error: {e}")
            else:
                raise RuntimeError(f"chip_smoke check failed: {name} took path vec16 at {what}")
        check(kernels.launches == before, f"a refused rle launch was counted ({what})")
    lib = kernels.lib()
    stream = torch.cuda.current_stream().cuda_stream
    counts = torch.zeros(8, dtype=torch.int32, device=DEVICE)
    vals = torch.empty(8 * 4096, dtype=torch.uint8, device=DEVICE)
    lens = torch.empty(8 * 4096, dtype=torch.int32, device=DEVICE)
    ptr = aligned.data_ptr()
    rcs = {
        "seg 0": lib.tpbt_seg_run_counts(ptr, counts.data_ptr(), 8, 0, 0, stream),
        "seg 2**31": lib.tpbt_seg_run_counts(ptr, counts.data_ptr(), 1, 2**31, 0, stream),
        "path 2": lib.tpbt_seg_run_counts(ptr, counts.data_ptr(), 8, 4096, 2, stream),
        "no counts": lib.tpbt_seg_run_counts(ptr, None, 8, 4096, 1, stream),
        "k < 0": lib.tpbt_rows_rle(ptr, rows.data_ptr(), bases.data_ptr(), vals.data_ptr(),
                                   lens.data_ptr(), counts.data_ptr(), 8, 4096, -1, 1, stream),
        "no flag": lib.tpbt_rows_rle(ptr, rows.data_ptr(), bases.data_ptr(), vals.data_ptr(),
                                     lens.data_ptr(), None, 8, 4096, 8, 1, stream),
    }
    check(set(rcs.values()) == {1}, f"the rle launchers refuse bad arguments: {rcs}")
    print(f"kernels: both rle launchers refuse path vec16 at {', '.join(cases)}, "
          f"and {', '.join(rcs)}")


def phase_rle_kernels(rng) -> dict:
    """The run-count and the run-record kernel against their plain
    versions at five segment lengths, each on both paths and on a view 4
    bytes off a 16-byte boundary; returns the largest errors."""
    from tpu_blosc_torch.filters import kernels, rle as fr

    worst = {"counts": 0, "rows": 0}
    kernels.reset_launches()
    for seg in (256, 1000, 4096, 18440, 262144):
        segs = torch.from_numpy(rle_rows(rng, seg, 8 if seg < 262144 else 3)).to(DEVICE)
        nseg = segs.shape[0]
        want_counts = fr.seg_run_counts_plain(segs)
        counts = want_counts.cpu().numpy().astype(np.int64)
        # every row out of order, then the two one-run rows side by side
        ones = np.flatnonzero(counts == 1)
        pick = np.concatenate([rng.permutation(nseg), ones]).astype(np.int64)
        bases = row_bases(counts[pick])
        rows_t = torch.from_numpy(pick).to(DEVICE)
        bases_t = torch.from_numpy(bases).to(DEVICE)
        want_vals, want_lens = fr.rows_rle_plain(segs, rows_t)
        check(want_vals.numel() == bases[-1], f"seg={seg}: the plain records are the counts' sum")
        picked = kernels.rle_path(seg, segs.data_ptr())
        for x, path in ((segs, None), (segs, "generic"), (off_by_4(segs), None)):
            took = "generic" if path or x is not segs else picked
            before = dict(kernels.launches)
            got = kernels.seg_run_counts(x, path=path)
            vals, lens, bad = kernels.rows_rle(x, rows_t, bases_t, int(bases[-1]), path=path)
            torch.cuda.synchronize()
            for kernel in ("seg_run_counts", "rows_rle"):
                check(kernels.launches[f"{kernel}.{took}"] == before[f"{kernel}.{took}"] + 1,
                      f"{kernel} took the {took} path, seg={seg}")
            worst["counts"] = max(worst["counts"], int((got - want_counts).abs().max()))
            check(got.dtype == torch.int32 and torch.equal(got, want_counts),
                  f"run-count kernel ({took}) vs plain, seg={seg}")
            worst["rows"] = max(worst["rows"], max_abs_diff(vals, want_vals),
                                int((lens - want_lens).abs().max()))
            check(int(bad) == 0 and torch.equal(vals, want_vals) and torch.equal(lens, want_lens),
                  f"run-record kernel ({took}) vs plain, seg={seg}")
        # through the wrapper that takes the host's rows and counts; and
        # counts that are not the rows' own, which the kernel must notice
        vals, lens = fr.rows_rle(segs, pick, counts[pick])
        check(torch.equal(vals, want_vals) and torch.equal(lens, want_lens),
              f"rows_rle wrapper vs plain, seg={seg}")
        for delta in (1, -1):
            wrong = counts[pick].copy()
            wrong[1] += delta
            if wrong[1] < 0:
                continue
            try:
                fr.rows_rle(segs, pick, wrong)
            except RuntimeError as e:
                check("disagree" in str(e), f"rows_rle names the disagreement: {e}")
            else:
                raise RuntimeError(f"chip_smoke check failed: rows_rle took counts off by {delta}")
        print(f"rle kernels: seg={seg}, {nseg} rows, {int(bases[-1])} runs of {pick.size} picked "
              f"rows: counts and records equal to the plain versions on both paths and 4 bytes "
              f"off alignment; counts off by one raise")
    taken = dict(kernels.launches)
    for kernel in ("seg_run_counts", "rows_rle"):
        check(all(taken[f"{kernel}.{path}"] >= 1 for path in kernels.RLE_PATHS),
              f"{kernel} ran on both paths ({taken})")
    check_rle_refusals(rng)
    return {"counts_max_abs_err": worst["counts"], "rows_max_abs_err": worst["rows"]}


def fill_tensors(pos: np.ndarray, vals: np.ndarray, row_d: np.ndarray, nseg: int, seg: int):
    """(pos, vals, row_first, row_d) on the card, as kernels.match_fill
    takes them."""
    row_first = np.searchsorted(pos, np.arange(nseg + 1, dtype=np.int64) * seg).astype(np.int64)
    return [torch.from_numpy(a).to(DEVICE) for a in (pos, vals, row_first, row_d)]


def fill_case(rng, seg: int, offsets) -> tuple:
    """Literal records of one row per offset (its first d bytes and 1% of
    the rest literal; the first row 30%, so that a tile holds many more
    records than the block has threads), a row of literals only, a row
    whose only literals are its first d bytes, and a row with no record at
    all.  Every second row has literals on both sides of the kernel's
    first two tile edges; the others only before the first and after the
    second, and no record in the tile between."""
    from tpu_blosc_torch.filters.kernels import FILL_TILE as tile

    nrows = len(offsets) + 3
    row_d = np.array(list(offsets) + [offsets[0], offsets[-1], offsets[0]], dtype=np.int32)
    lit = rng.random((nrows, seg)) < 0.01
    lit[0] = rng.random(seg) < 0.3
    lit[1::2, tile: 2 * tile] = False
    for r, d in enumerate(offsets):
        lit[r, :d] = True
        edges = (tile - 1, tile, 2 * tile - 1, 2 * tile) if r % 2 == 0 else (tile - 1, 2 * tile)
        lit[r, [e for e in edges if e < seg]] = True
    lit[-3] = True
    lit[-2:] = False
    lit[-2, : row_d[-2]] = True
    pos = np.flatnonzero(lit).astype(np.int32)
    return pos, rng.integers(0, 256, pos.size, dtype=np.uint8), row_d, nrows


def synthetic_fill_records(gen, nseg: int, seg: int, d: int, density: float) -> list:
    """(pos, vals, row_first, row_d) on the card for nseg rows at offset d:
    each row's first d bytes and ``density`` of the rest literal, from the
    seeded generator."""
    lit = torch.rand((nseg, seg), device=DEVICE, generator=gen) < density
    lit[:, :d] = True
    pos = torch.nonzero(lit.view(-1)).view(-1).to(torch.int32)
    del lit
    vals = torch.randint(0, 256, pos.shape, dtype=torch.uint8, device=DEVICE, generator=gen)
    starts = (torch.arange(nseg + 1, dtype=torch.int64, device=DEVICE) * seg).to(torch.int32)
    row_first = torch.searchsorted(pos, starts).to(torch.int64)
    return [pos, vals, row_first, torch.full((nseg,), d, dtype=torch.int32, device=DEVICE)]


def phase_fill_kernel(rng) -> dict:
    """The fill kernel against its plain version at nine segment lengths
    (one tile, a tile and 16 bytes, two tiles, three tiles and 5 bytes
    among them) with offsets of each width the kernel fills in, and one
    (1, 2**24) row at d = 1, on both paths and into a view 4 bytes off a
    16-byte boundary; returns the largest error."""
    from tpu_blosc_torch.filters import fill as ff, kernels

    worst = 0
    kernels.reset_launches()

    def compare(pos, vals, row_d, nseg, seg, what):
        nonlocal worst
        args = fill_tensors(pos, vals, row_d, nseg, seg)
        want = ff.match_fill_plain(args[0], args[1], args[3], nseg, seg)
        buf = torch.empty(nseg * seg + 16, dtype=torch.uint8, device=DEVICE)
        off = buf[4: 4 + nseg * seg].view(nseg, seg)
        picked = kernels.fill_path(seg, want.data_ptr())
        for out, path in ((None, None), (None, "generic"), (off, None)):
            took = "generic" if path or out is not None else picked
            before = dict(kernels.launches)
            got = kernels.match_fill(*args, nseg, seg, out=out, path=path)
            torch.cuda.synchronize()
            check(kernels.launches[f"match_fill.{took}"] == before[f"match_fill.{took}"] + 1,
                  f"fill kernel took the {took} path, {what}")
            worst = max(worst, max_abs_diff(got, want))
            check(torch.equal(got, want), f"fill kernel ({took}) vs plain, {what}")
        got = ff.match_fill(pos, vals, row_d, nseg, seg, DEVICE)
        check(torch.equal(got, want), f"match_fill wrapper vs plain, {what}")

    tile = kernels.FILL_TILE
    for seg in (256, 1000, 4096, tile, tile + 16, 2 * tile, 18440, 3 * tile + 5, 262144):
        # filled in bytes: 1, 2, 3, 6, 7, 250, 255; in words: 4, 12, 24; in
        # uint4: 16, 48, 96, 256, 768, 1024.  3, 48 and 96 divide none of
        # these seg; 7, 250 and 255 are no candidates
        offsets = [d for d in (1, 3, 48, 96, 1024, 7, 250, 256, 255, 2, 6, 4, 12, 24, 16, 768)
                   if d < seg]
        pos, vals, row_d, nrows = fill_case(rng, seg, offsets)
        compare(pos, vals, row_d, nrows, seg, f"seg={seg}")
        print(f"fill kernel: seg={seg}, {nrows} rows at d={row_d.tolist()}, {pos.size} records "
              f"(literals on both sides of the tile edges {tile} and {2 * tile}, rows with no "
              f"record between them, one row of literals only, one with only its first d bytes "
              f"literal, one with none): equal to the plain version on both paths and into a "
              f"view 4 bytes off alignment")
    seg = 1 << 24
    pos = np.unique(np.concatenate([[0], rng.choice(seg, 1000, replace=False),
                                    [seg - 1]])).astype(np.int32)
    vals = rng.integers(0, 256, pos.size, dtype=np.uint8)
    compare(pos, vals, np.ones(1, np.int32), 1, seg, "(1, 2**24) at d = 1")
    print(f"fill kernel: one row of 2**24 bytes at d = 1, {pos.size} records: equal to the "
          f"plain version (2**24 steps down one column: no key to overflow)")
    check(all(kernels.launches[f"match_fill.{path}"] >= 1 for path in kernels.FILL_PATHS),
          f"match_fill ran on both paths ({kernels.launches})")

    # refusals: the wrapper for offsets and positions out of range, the
    # launcher for a path that does not fit and geometry it does not take
    *case, nrows = fill_case(rng, 1000, [1, 3])
    args = fill_tensors(*case, nrows, 1000)
    before = dict(kernels.launches)
    try:
        kernels.match_fill(*args, nrows, 1000, path="vec16")
    except RuntimeError as e:
        check("CUDA error 1" in str(e), f"match_fill refusal names the error: {e}")
    else:
        raise RuntimeError("chip_smoke check failed: match_fill took path vec16 at seg 1000")
    for bad_d in (0, kernels.FILL_MAX_D + 1):
        try:
            ff.match_fill(np.zeros(1, np.int32), np.zeros(1, np.uint8),
                          np.full(2, bad_d, np.int32), 2, 4096, DEVICE)
        except ValueError:
            pass
        else:
            raise RuntimeError(f"chip_smoke check failed: match_fill took d = {bad_d}")
    lib = kernels.lib()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(nrows * 1000, dtype=torch.uint8, device=DEVICE)
    ptrs = [a.data_ptr() for a in args]
    rcs = {
        "seg 0": lib.tpbt_match_fill(*ptrs, out.data_ptr(), nrows, 0, 0, stream),
        "2**31 bytes": lib.tpbt_match_fill(*ptrs, out.data_ptr(), 2**15, 2**16, 0, stream),
        "path 2": lib.tpbt_match_fill(*ptrs, out.data_ptr(), nrows, 1000, 2, stream),
        "no out": lib.tpbt_match_fill(*ptrs, None, nrows, 1000, 0, stream),
    }
    check(set(rcs.values()) == {1}, f"the fill launcher refuses bad arguments: {rcs}")
    check(kernels.launches == before, "a refused fill launch was counted")
    print(f"kernels: the fill launcher refuses path vec16 at seg 1000, and {', '.join(rcs)}; "
          f"the wrapper refuses d = 0 and d = {kernels.FILL_MAX_D + 1}")
    return {"max_abs_err": worst}


def rle_data() -> torch.Tensor:
    """256 MiB of int32 on the card, for 1 MiB blocks: a staircase
    (arange // 64: 4096 runs in a block's low byte plane, a few in the
    others), and in every odd block the low byte replaced by random bytes
    from the seed (one dense plane, three run-sparse ones)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 6)
    n_el = 64 * MIB
    per_block = MIB // 4
    x = (torch.arange(n_el, dtype=torch.int32, device=DEVICE) // 64).view(-1, per_block)
    noise = torch.randint(0, 256, (x.shape[0] // 2, per_block), dtype=torch.int32,
                          device=DEVICE, generator=gen)
    x[1::2] = (x[1::2] & ~0xFF) | noise
    return x.view(-1)


def run_path_g(tbt, x, opts):
    frame = tbt.compress_array(x, opts, strategy="rle")
    y = tbt.decompress_array(frame, x.dtype, device=DEVICE, strategy="device")
    torch.cuda.synchronize()
    return frame, y


def time_turns(fns: dict) -> tuple[dict, dict]:
    """Time each function in two turns, the second in reverse order (the
    plain versions and the library calls 3 launches after 1, the kernels
    20 after 3); returns (the runs, their means)."""
    runs = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            slow = k.endswith(("plain", "library"))
            runs[k].append(cuda_ms(fns[k], iters=3 if slow else 20, warmup=1 if slow else 3))
    return runs, {k: statistics.mean(v) for k, v in runs.items()}


def check_and_time_path_g(tbt, x, opts, frame, y) -> dict:
    """Check path G's result and time it beside the transfer route and
    stage by stage; returns, for the run-count and the run-record kernel,
    the kernel's, its plain version's and the library call's times, the
    largest difference and the bound on the path's own segments."""
    from tpu_blosc_torch import chunk, device as dev, match as tm, rle as tr
    from tpu_blosc_torch.filters import kernels, rle as fr

    host_bytes = x.cpu().numpy().tobytes()
    transfer = tbt.compress_array(x, opts)
    check(frame != transfer, "G: the rle frame differs from the transfer frame")
    check(tbt.decompress(frame) == host_bytes, "G: host decode of the rle frame")
    check(torch.equal(y, x), "G: decompress_array(strategy='device') gives x")
    part = x[: 4 * MIB]
    check(tbt.compress_array(part, opts, strategy="rle")
          == tbt.compress_array(part.cpu(), opts, strategy="rle"),
          "G: the CUDA route's frame equals the CPU route's on 16 MiB")

    n = x.numel() * 4
    gb = n / 1e9
    t_r = host_s(lambda: tbt.compress_array(x, opts, strategy="rle"), reps=3)
    t_t = host_s(lambda: tbt.compress_array(x, opts), reps=3)
    t_d = host_s(lambda: tbt.decompress_array(frame, x.dtype, device=DEVICE,
                                              strategy="device"), reps=3)
    print(f"G i32 staircase, every odd block with a random low byte, LZ4 rle: {n} bytes, ratio "
          f"{n / len(frame):.2f} (transfer frame {n / len(transfer):.2f}); medians of 3: "
          f"compress_array(rle) {gb / t_r:.3f} GB/s ({t_r * 1e3:.3f} ms), "
          f"compress_array(transfer) {gb / t_t:.3f} GB/s ({t_t * 1e3:.3f} ms), "
          f"decompress_array(device) of the rle frame {gb / t_d:.3f} GB/s ({t_d * 1e3:.3f} ms)")

    # the stages of compress_array_rle, run one by one
    bs, ts = opts.block_size, 4
    seg, nb_full = bs // ts, n // bs
    nseg = nb_full * ts
    blocks = dev.tensor_bytes(x).view(nb_full, bs)
    segs = tbt.filters.shuffle_blocks(blocks, ts).view(nseg, seg)
    counts_d = fr.seg_run_counts(segs)
    counts = counts_d.cpu().numpy().astype(np.int64)
    sparse = tr.sparse_rows(counts, seg)
    sparse_idx, dense_idx = np.flatnonzero(sparse), np.flatnonzero(~sparse)
    check(sparse_idx.size == 7 * nseg // 8 and dense_idx.size == nseg // 8,
          f"G: 7/8 of the segments are sparse ({sparse_idx.size} of {nseg})")
    vals_d, lens_d = fr.rows_rle(segs, sparse_idx, counts[sparse_idx])
    vals, lens, rec_first = tr.run_records(segs, sparse_idx, counts)
    dense = tm.gather_rows(segs, dense_idx)
    payloads, entries, rest = tr.emit_sparse_blocks(bs, nb_full, ts, sparse, sparse_idx, vals,
                                                    lens, rec_first)
    check(len(rest) == nb_full // 2, f"G: the emitter wrote the even blocks ({len(rest)} left)")
    rebuilt = tr.rebuild_blocks(rest, ts, seg, sparse, sparse_idx, vals, lens, rec_first,
                                dense_idx, dense)
    tr.encode_blocks(opts, bs, rest, rebuilt, payloads, entries)
    stages = {
        "shuffle kernel": lambda: tbt.filters.shuffle_blocks(blocks, ts),
        "count kernel": lambda: fr.seg_run_counts(segs),
        "counts copy": lambda: counts_d.cpu(),
        "rows kernel (with its upload and the check of its flag)":
            lambda: fr.rows_rle(segs, sparse_idx, counts[sparse_idx]),
        "record copies": lambda: (vals_d.cpu(), lens_d.cpu()),
        "dense rows": lambda: tm.gather_rows(segs, dense_idx),
        "emit": lambda: tr.emit_sparse_blocks(bs, nb_full, ts, sparse, sparse_idx, vals, lens,
                                              rec_first),
        "rebuild": lambda: tr.rebuild_blocks(rest, ts, seg, sparse, sparse_idx, vals, lens,
                                             rec_first, dense_idx, dense),
        "codec": lambda: tr.encode_blocks(opts, bs, rest, rebuilt, list(payloads), list(entries)),
        "frame": lambda: chunk.split_header(opts, n, bs, entries, sum(map(len, payloads)))
        + b"".join(payloads),
    }
    times = {k: host_s(f, reps=3) * 1e3 for k, f in stages.items()}
    print("G stages (ms, medians of 3): " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    n_runs = int(rec_first[-1])
    print(f"G records: {sparse_idx.size} of {nseg} segments sparse, {n_runs} runs "
          f"({5 * n_runs} bytes of records for {sparse_idx.size * seg} bytes of segments), "
          f"{dense_idx.size} dense segments ({dense_idx.size * seg} bytes), {nb_full - len(rest)} "
          f"blocks written by the emitter, {len(rest)} rebuilt and re-encoded, "
          f"{sum(1 for e in entries if e & 0x80000000)} stored raw")

    # the two kernels on G's own segments, against their plain versions
    rows_t = torch.from_numpy(sparse_idx).to(DEVICE)
    bases_t = torch.from_numpy(rec_first).to(DEVICE)
    want_counts = fr.seg_run_counts_plain(segs)
    got_vals, got_lens, bad = kernels.rows_rle(segs, rows_t, bases_t, n_runs)
    want_vals, want_lens = fr.rows_rle_plain(segs, rows_t)
    torch.cuda.synchronize()
    check(torch.equal(counts_d, want_counts), f"run-count kernel vs plain on G's segments")
    check(int(bad) == 0 and torch.equal(got_vals, want_vals) and torch.equal(got_lens, want_lens),
          f"run-record kernel vs plain on G's {sparse_idx.size} sparse segments")
    err_counts = int((counts_d - want_counts).abs().max())
    err_rows = max(max_abs_diff(got_vals, want_vals), int((got_lens - want_lens).abs().max()))
    del want_vals, want_lens, got_vals, got_lens
    cuda_ms(lambda: kernels.seg_run_counts(segs), iters=300)  # see phase_kernels
    flat_rows = segs.index_select(0, rows_t).view(-1)
    runs, ms = time_turns({
        "counts": lambda: kernels.seg_run_counts(segs),
        "counts_generic": lambda: kernels.seg_run_counts(segs, path="generic"),
        "counts_plain": lambda: fr.seg_run_counts_plain(segs),
        "rows": lambda: kernels.rows_rle(segs, rows_t, bases_t, n_runs),
        "rows_generic": lambda: kernels.rows_rle(segs, rows_t, bases_t, n_runs, path="generic"),
        "rows_plain": lambda: fr.rows_rle_plain(segs, rows_t),
        # the one PyTorch call near the rows kernel: a yardstick only, since
        # it joins runs across row edges and takes the rows already gathered
        "rows_library": lambda: torch.unique_consecutive(flat_rows, return_counts=True),
    })
    # what the functions must move and do on these inputs: the count reads
    # each byte once and writes a count a row, one compare and one add a
    # byte; the rows kernel reads the chosen rows, their indices and bases
    # once and writes 5 bytes a run, one compare a byte and one add a run
    k = sparse_idx.size
    bounds = {
        "counts": bound(segs.numel() + 4 * nseg, 2 * segs.numel()),
        "rows": bound(k * seg + 8 * (2 * k + 1) + 5 * n_runs, k * seg + n_runs),
    }
    print(f"rle kernel times on G's segments {tuple(segs.shape)}, {k} rows and {n_runs} runs for "
          f"the rows kernel, ms as turn 1 / turn 2 (mean of 20 launches each, the plain versions "
          f"and the library call of 3): " + ", ".join(
              f"{name} {v[0]:.4f} / {v[1]:.4f}" for name, v in runs.items())
          + "; equal outputs; bounds: " + ", ".join(
              f"{name} {b['bound_ms']:.4f} ms by {b['bound_by']}" for name, b in bounds.items()))
    return {
        "counts": {"max_abs_err": err_counts, "ms": ms["counts"],
                   "generic_ms": ms["counts_generic"], "plain_ms": ms["counts_plain"],
                   **bounds["counts"], "library_ms": None},
        "rows": {"max_abs_err": err_rows, "ms": ms["rows"], "generic_ms": ms["rows_generic"],
                 "plain_ms": ms["rows_plain"], **bounds["rows"],
                 "library_ms": ms["rows_library"]},
    }


def run_path_h(tbt, frames: dict) -> dict:
    """decompress_array(strategy="records") of each frame, on the card."""
    out = {name: tbt.decompress_array(frame, torch.float32, device=DEVICE, strategy="records")
           for name, frame in frames.items()}
    torch.cuda.synchronize()
    return out


def check_and_time_path_h(tbt, x, frames: dict, decoded: dict) -> dict:
    """Check path H's results and time the records decode beside the
    transfer and the device strategy and stage by stage; returns the fill
    kernel's and its plain version's times, the largest difference and
    the bound on the path's own records, and the kernel's times on
    synthetic records at 2.2% for offsets 1, 3, 4, 16, 256 and 1024."""
    from tpu_blosc_torch import chunk, device as dev, format as fmt, match as tm, records as trec
    from tpu_blosc_torch.filters import fill as ff, kernels
    from tpu_blosc_torch.filters.match import MATCH_T
    from tpu_blosc_torch.native import backend as nb

    n = x.numel() * 4
    gb = n / 1e9
    for name, frame in frames.items():
        y = decoded[name]
        check(y.dtype == x.dtype and y.device == x.device and torch.equal(y, x),
              f"H: the records decode of the {name} frame gives x")
        plain = tbt.decompress_array(frame, torch.float32, device=DEVICE, strategy="transfer")
        check(torch.equal(y, plain), f"H: the records decode of the {name} frame equals the "
              f"transfer decode")
        del plain
        times = {s: host_s(lambda: tbt.decompress_array(frame, torch.float32, device=DEVICE,
                                                        strategy=s), reps=3)
                 for s in ("records", "transfer", "device")}
        print(f"H records decode of C's tensor from the {name} frame ({len(frame)} bytes): "
              f"medians of 3: " + ", ".join(
                  f"decompress_array({s}) {gb / t:.3f} GB/s ({t * 1e3:.3f} ms)"
                  for s, t in times.items()))

    # the stages of decompress_array_records on the match frame, one by one
    frame = frames["match"]
    header = fmt.parse_header(frame)
    bs, ts = header.block_size, header.type_size
    seg = bs // ts
    nseg = n // seg
    native = chunk.native_pipeline_codec(header.codec, 1)
    stream = dev._decode_filtered_blocks(frame, header, n, native[0], forbid_memcpy=True)[0].numpy()
    rows2d = stream.reshape(nseg, seg)
    offsets = tm.match_offsets(seg)
    d_all = trec.choose_offsets(rows2d, offsets)
    packed = trec.host_lit_mask_packed(rows2d, d_all, MATCH_T)
    n_lit = int(np.bitwise_count(packed).sum(dtype=np.int64))
    pos = nb.mask_positions(packed.reshape(-1), n_lit)
    vals = stream[pos]
    args = fill_tensors(pos, vals, d_all, nseg, seg)
    filled = kernels.match_fill(*args, nseg, seg)
    stages = {
        "host block decode": lambda: dev._decode_filtered_blocks(frame, header, n, native[0],
                                                                 forbid_memcpy=True),
        "offset choice": lambda: trec.choose_offsets(rows2d, offsets),
        "mask": lambda: trec.host_lit_mask_packed(rows2d, d_all, MATCH_T),
        "literal count": lambda: np.bitwise_count(packed).sum(dtype=np.int64),
        "position scan": lambda: nb.mask_positions(packed.reshape(-1), n_lit),
        "value gather": lambda: stream[pos],
        "row index and copies to the card": lambda: fill_tensors(pos, vals, d_all, nseg, seg),
        "fill kernel": lambda: kernels.match_fill(*args, nseg, seg),
        "unshuffle kernel": lambda: tbt.filters.unfilter_blocks(filled.view(-1, bs), ts,
                                                                header.shuffle_mode),
    }
    times = {k: host_s(f, reps=3) * 1e3 for k, f in stages.items()}
    print("H stages, match frame (ms, medians of 3): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    print(f"H records: {n_lit} literals ({n_lit / n:.4%} of bytes, {5 * n_lit} bytes of records "
          f"for {n} bytes), offsets chosen {sorted(set(d_all.tolist()))}")

    want = ff.match_fill_plain(args[0], args[1], args[3], nseg, seg)
    torch.cuda.synchronize()
    check(torch.equal(filled, want), f"fill kernel vs plain on H's records ({nseg}, {seg})")
    err = max_abs_diff(filled, want)
    del want
    torch.cuda.empty_cache()
    cuda_ms(lambda: kernels.match_fill(*args, nseg, seg), iters=100)  # see phase_kernels
    runs, ms = time_turns({
        "fill": lambda: kernels.match_fill(*args, nseg, seg),
        "fill_generic": lambda: kernels.match_fill(*args, nseg, seg, path="generic"),
        "fill_plain": lambda: ff.match_fill_plain(args[0], args[1], args[3], nseg, seg),
    })
    # 5 bytes a record, a first record and an offset a row read once, the
    # stream written once; one select a byte
    limit = bound(5 * n_lit + 8 * (nseg + 1) + 4 * nseg + nseg * seg, nseg * seg)
    print(f"fill kernel times on H's records ({nseg}, {seg}), {n_lit} literals, ms as turn 1 / "
          f"turn 2 (mean of 20 launches each, the plain version of 3): " + ", ".join(
              f"{name} {v[0]:.4f} / {v[1]:.4f}" for name, v in runs.items())
          + f"; equal outputs; bound {limit['bound_ms']:.4f} ms by {limit['bound_by']}")

    # the same geometry with synthetic records at 2.2%, offset by offset:
    # each width the kernel fills in, with one thread a column and with many
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 7)
    by_offset = {}
    for d in (1, 3, 4, 16, 256, 1024):
        synth = synthetic_fill_records(gen, nseg, seg, d, 0.022)
        got = kernels.match_fill(*synth, nseg, seg)
        want = ff.match_fill_plain(synth[0], synth[1], synth[3], nseg, seg)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"fill kernel vs plain on synthetic records at d = {d}")
        del got, want
        torch.cuda.empty_cache()
        by_offset[d] = [cuda_ms(lambda: kernels.match_fill(*synth, nseg, seg)) for _ in range(2)]
        del synth
    print(f"fill kernel times on synthetic records ({nseg}, {seg}), 2.2% literals, vec16 path, "
          f"ms as turn 1 / turn 2 (mean of 20 launches each): " + ", ".join(
              f"d = {d} {v[0]:.4f} / {v[1]:.4f}" for d, v in by_offset.items())
          + "; equal to the plain version at every offset")
    return {"max_abs_err": err, "ms": ms["fill"], "generic_ms": ms["fill_generic"],
            "plain_ms": ms["fill_plain"], **limit, "library_ms": None,
            "by_offset_ms": {str(d): statistics.mean(v) for d, v in by_offset.items()}}


def check_records_load(tbt, state, x, opts, workdir) -> dict:
    """load_pytree(device=True, strategy="records") of a checkpoint that
    holds one leaf of F (random bfloat16: too dense for records, so the
    leaf takes the transfer route) and 64 MiB of C's tensor (which the
    records route decodes); returns the kernels' launches in that load."""
    from tpu_blosc_torch.filters import kernels

    tree = {"c_fc": state["params"]["h"][12]["mlp"]["c_fc"]["w"], "tiled": x[: 16 * MIB],
            "step": state["step"]}
    path = os.path.join(workdir, "records.tpbs")
    tbt.save_pytree(path, tree, opts, strategy="match")
    kernels.reset_launches()
    t0 = time.perf_counter()
    loaded = tbt.load_pytree(path, device=True, strategy="records")
    torch.cuda.synchronize()
    t_records = time.perf_counter() - t0
    launches = dict(kernels.launches)
    t0 = time.perf_counter()
    plain = tbt.load_pytree(path, device=True)
    torch.cuda.synchronize()
    t_transfer = time.perf_counter() - t0
    for key in ("c_fc", "tiled"):
        check(loaded[key].device == tree[key].device and torch.equal(loaded[key], tree[key])
              and torch.equal(plain[key], tree[key]),
              f"H: load_pytree(strategy='records') gives the leaf {key} back exactly")
    check(loaded["step"] == tree["step"], "H: load_pytree(strategy='records') gives step back")
    check(launches["match_fill"] == 1 and launches["unshuffle_blocks"] == 1,
          f"H: the tiled leaf took the records route, the dense one did not ({launches})")
    nbytes = sum(tree[k].numel() * tree[k].element_size() for k in ("c_fc", "tiled"))
    print(f"H load_pytree(device=True) of one leaf of F and 64 MiB of C's tensor ({nbytes} "
          f"bytes, file {os.path.getsize(path)} bytes): strategy records {t_records:.3f} s, "
          f"transfer {t_transfer:.3f} s; launches {launches}")
    os.remove(path)
    return launches


class Zlib1:
    """A codec for a new ID: zlib at level 1, in Python."""

    def name(self):
        return "zlib1"

    def compress(self, data, level):
        import zlib

        return zlib.compress(bytes(data), 1)

    def decompress(self, data, expected_size):
        import zlib

        return zlib.decompress(bytes(data))


class Counting:
    """A registered codec that counts its calls and forwards them."""

    def __init__(self, inner):
        self.inner = inner
        self.compressed = self.decompressed = 0

    def name(self):
        return "counting-" + self.inner.name()

    def compress(self, data, level):
        self.compressed += 1
        return self.inner.compress(data, level)

    def decompress(self, data, expected_size):
        self.decompressed += 1
        return self.inner.decompress(data, expected_size)


@contextlib.contextmanager
def restored_registry():
    """Put the port's codec registry back as it was on the way out."""
    from tpu_blosc_torch.codecs import registry

    saved = dict(registry._codecs)
    try:
        yield
    finally:
        with registry._lock:
            registry._codecs.clear()
            registry._codecs.update(saved)
            registry._version += 1


def phase_registry(tbt, x, opts, frame_a) -> dict:
    """The registry on the card: A's tensor with a codec under a new ID
    (42, zlib level 1) and with LZ4 taken over by a wrapper of the
    builtin, both counting their calls.  compress_array launches the
    shuffle kernel once on its vec16 path and calls the codec once a
    block, to the frame compress_with_options writes under the same
    registry; decompress_array(strategy="device") calls the codec once a
    block and launches the unshuffle kernel once on its vec16 path, and
    gives the tensor back; under the override strategy "match" gives the
    transfer frame.  The registry is restored, and A's frame is the
    builtin one again.  Returns each codec's launches and times."""
    from dataclasses import replace

    from tpu_blosc_torch.chunk import choose_block_size
    from tpu_blosc_torch.codecs import standard
    from tpu_blosc_torch.filters import kernels

    host = x.cpu().numpy()
    nb = -(-host.nbytes // choose_block_size(host.nbytes, opts.type_size, opts.block_size))
    out = {}
    with restored_registry():
        for cid, codec in ((42, Counting(Zlib1())), (tbt.LZ4, Counting(standard.Lz4Codec()))):
            tbt.register_codec(cid, codec)
            o = replace(opts, codec=cid)
            name = f"registry, {codec.name()} at ID {int(cid)}"
            kernels.reset_launches()
            t0 = time.perf_counter()
            frame = tbt.compress_array(x, o)
            t_c = time.perf_counter() - t0
            launches_c = dict(kernels.launches)
            check(launches_c["shuffle_blocks"] == launches_c["shuffle_blocks.vec16"] == 1,
                  f"{name}: compress_array launched the shuffle kernel once, vec16 ({launches_c})")
            check(codec.compressed == nb,
                  f"{name}: the codec compressed once a block ({codec.compressed} of {nb})")
            check(frame == tbt.compress_with_options(host, o),
                  f"{name}: the frame == compress_with_options' under the same registry")
            coded = nb - tbt.frame_stats(frame).memcpy_blocks
            kernels.reset_launches()
            t0 = time.perf_counter()
            y = tbt.decompress_array(frame, x.dtype, device=DEVICE, strategy="device")
            torch.cuda.synchronize()
            t_d = time.perf_counter() - t0
            launches_d = dict(kernels.launches)
            check(launches_d["unshuffle_blocks"] == launches_d["unshuffle_blocks.vec16"] == 1,
                  f"{name}: decompress_array(device) unshuffled on the card once, vec16 "
                  f"({launches_d})")
            check(codec.decompressed == coded,
                  f"{name}: the codec decoded each coded block ({codec.decompressed} of {coded})")
            check(torch.equal(y, x), f"{name}: decompress_array(device) gives the tensor back")
            if cid == tbt.LZ4:
                check(tbt.compress_array(x, o, strategy="match") == frame,
                      f"{name}: strategy match under the override gives the transfer frame")
            out[name] = {"launches_compress": nonzero(launches_c),
                         "launches_decompress": nonzero(launches_d), "compress_s": t_c,
                         "decompress_s": t_d, "ratio": host.nbytes / len(frame)}
            print(f"{name}: {host.nbytes} bytes in {nb} blocks, ratio "
                  f"{host.nbytes / len(frame):.2f}; compress_array {t_c:.3f} s (launches "
                  f"{nonzero(launches_c)}), decompress_array(device) {t_d:.3f} s (launches "
                  f"{nonzero(launches_d)})")
    check(standard.is_builtin(tbt.LZ4) and tbt.get_codec(42) is None,
          "the registry is restored")
    check(tbt.compress_array(x, opts) == frame_a, "A: the builtin frame again after the registry")
    return out


# (pattern of a kernel's name in a profiler trace, the port's kernel)
TRACE_KERNELS = [
    (r"vec16_blocks<\d+, true>", "tpbt_shuffle_blocks"),
    (r"vec16_blocks<\d+, false>", "tpbt_unshuffle_blocks"),
    (r"transpose_blocks<", "tpbt_shuffle_blocks or tpbt_unshuffle_blocks, generic"),
    (r"groups<(\d+, )?true>", "tpbt_bitshuffle_blocks"),
    (r"groups<(\d+, )?false>", "tpbt_bitunshuffle_blocks"),
    (r"seg_run_counts<", "tpbt_seg_run_counts"),
    (r"rows_rle<", "tpbt_rows_rle"),
    (r"match_count|match_argmax", "tpbt_match_count"),
    (r"match_nibble", "tpbt_match_nibble"),
    (r"probe_tiles", "tpbt_probe_tiles"),
    (r"match_fill", "tpbt_match_fill"),
]


def read_trace(path: str) -> dict:
    """The device side of a Chrome trace that stats.trace wrote: per kernel
    of the port (torch's own kernels under "torch: <name>") its count and
    device milliseconds, the copies', the busy share (the union of the
    kernel, copy and memset intervals over the traced window, first to
    last event of the trace), and the calls that put work on the card
    (runtime or driver launches, copies, memsets) whose device event is
    not in the trace, matched by correlation ID ("lost"), with the least
    gap from a kept call to its device event.  The file is removed."""
    import re

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    timed = [e for e in events if "ts" in e]
    start = min(float(e["ts"]) for e in timed)
    end = max(float(e["ts"]) + float(e.get("dur", 0)) for e in timed)
    kernels: dict = {}
    spans = []
    on_card: dict = {}
    calls = []
    for e in timed:
        cat = e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if (cat in ("cuda_runtime", "cuda_driver") and e.get("ph") == "X"
                and re.search(r"Launch|Memcpy|Memset", e.get("name", ""))):
            calls.append((corr, float(e["ts"]), e["name"]))
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t0, dur = float(e["ts"]), float(e.get("dur", 0))
        on_card[corr] = t0
        spans.append((t0, t0 + dur))
        name = e.get("name", "")
        if cat == "kernel":
            label = next((k for pat, k in TRACE_KERNELS if re.search(pat, name)), None)
            label = label or "torch: " + re.sub(r"^void |\(.*$|<.*$", "", name).split("::")[-1]
        else:
            label = name
        row = kernels.setdefault(label, {"count": 0, "ms": 0.0})
        row["count"] += 1
        row["ms"] += dur / 1e3
    busy, last = 0.0, start
    for a, b in sorted(spans):
        a = max(a, last)
        if b > a:
            busy += b - a
            last = b
    for row in kernels.values():
        row["mean_ms"] = row["ms"] / row["count"]
    window = (end - start) / 1e3
    lost = [f"{name} at {(ts - start) / 1e3:.3f} ms" for corr, ts, name in calls
            if corr not in on_card]
    gaps = [on_card[corr] - ts for corr, ts, _ in calls if corr in on_card]
    return {"window_ms": window, "busy_ms": busy / 1e3, "busy_share": busy / 1e3 / window,
            "kernels": kernels, "calls": len(calls), "lost": lost,
            "least_gap_ms": min(gaps) / 1e3 if gaps else None}


# the kernels' launch counters (filters.kernels.launches) by their names
# in TRACE_KERNELS
LAUNCH_NAMES = {"shuffle_blocks": "tpbt_shuffle_blocks",
                "unshuffle_blocks": "tpbt_unshuffle_blocks",
                "bit_shuffle_blocks": "tpbt_bitshuffle_blocks",
                "bit_unshuffle_blocks": "tpbt_bitunshuffle_blocks",
                "seg_run_counts": "tpbt_seg_run_counts", "rows_rle": "tpbt_rows_rle",
                "match_count": "tpbt_match_count", "match_nibble": "tpbt_match_nibble",
                "probe_tiles": "tpbt_probe_tiles", "match_fill": "tpbt_match_fill"}


def traced(tbt, name: str, fn, need: tuple, tries: int = 3) -> dict:
    """Run ``fn`` under stats.trace, read the trace and print the reading,
    with each port kernel's events beside its launches in the region.  A
    trace is complete when every call that put work on the card has its
    device event and every launch of a port kernel its event; only a
    complete trace gives a busy share ("busy_share" None otherwise).  The
    card's profiler has been seen to drop a region's first operations, so
    an incomplete trace is taken again, up to ``tries`` times in all, and
    each attempt is printed.  The last attempt must hold an event of each
    kernel in ``need``."""
    from tpu_blosc_torch.filters import kernels

    history = []
    for attempt in range(1, tries + 1):
        before = dict(kernels.launches)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
            with tbt.stats.trace(d) as t:
                fn()
            check("trace_file" in t, f"{name}: stats.trace wrote a trace")
            got = read_trace(t["trace_file"])
        launched = {LAUNCH_NAMES[k]: v - before[k] for k, v in kernels.launches.items()
                    if k in LAUNCH_NAMES and v > before[k]}
        kept = {k: got["kernels"].get(k, {}).get("count", 0) for k in launched}
        complete = not got["lost"] and kept == launched
        history.append({"lost": len(got["lost"]), "calls": got["calls"],
                        "kept": {k: f"{kept[k]} of {v}" for k, v in launched.items()}})
        print(f"trace {name}, attempt {attempt}: {got['calls']} calls that put work on the "
              f"card, {len(got['lost'])} without their device event {got['lost'][:6]}; port "
              f"kernels' events of their launches {history[-1]['kept']}; least gap from a "
              f"call to its device event {got['least_gap_ms']} ms")
        if complete:
            break
    missing = [k for k in need if got["kernels"].get(k, {}).get("count", 0) == 0]
    check(not missing, f"{name}: the trace holds events of {need} ({missing} missing)")
    share = (f"device busy {got['busy_ms']:.3f} ms = {100 * got['busy_share']:.2f}%, idle "
             f"{100 * (1 - got['busy_share']):.2f}%" if complete else
             "device busy share: incomplete (events lost), not given")
    rows = sorted(got["kernels"].items(), key=lambda kv: -kv[1]["ms"])
    print(f"trace {name} (stats.trace, attempt {attempt} of {tries}, card {gpu_line()}): "
          f"window {got['window_ms']:.3f} ms (wall {t['elapsed_s'] * 1e3:.3f} ms), {share}; "
          + "; ".join(f"{k} {v['count']}x, {v['ms']:.4f} ms, mean {v['mean_ms']:.4f}"
                      for k, v in rows[:12]))
    return {**got, "busy_share": got["busy_share"] if complete else None,
            "elapsed_s": t["elapsed_s"], "attempts": history}


def phase_stats_a(tbt, x, opts, frame) -> dict:
    """compress_with_stats of A's bytes, frame_stats of A's frame, and a
    trace of A's compress_array and decompress_array(device)."""
    host = x.cpu().numpy()
    frame_h, st = tbt.compress_with_stats(host, opts)
    fs = tbt.frame_stats(frame)
    check(frame_h == frame and st.nbytes_orig == host.nbytes and st.nbytes_comp == len(frame),
          "stats: compress_with_stats of A's bytes gives A's frame and its sizes")
    check(fs.num_blocks == st.num_blocks == 64 and fs.memcpy_blocks == st.memcpy_blocks == 0
          and sum(fs.block_payload_sizes) == len(frame) - 16 - 4 - 4 * 64,
          f"stats: frame_stats of A's frame, 64 blocks ({fs.num_blocks})")
    print(f"stats: compress_with_stats of A's {st.nbytes_orig} bytes: ratio {st.ratio:.2f}, "
          f"{st.num_blocks} blocks of {st.block_size}, {st.memcpy_blocks} raw, "
          f"{st.throughput_gbps:.3f} GB/s host compress; frame_stats: payloads "
          f"{min(fs.block_payload_sizes)}-{max(fs.block_payload_sizes)} bytes")

    def a():
        f = tbt.compress_array(x, opts)
        y = tbt.decompress_array(f, x.dtype, device=DEVICE, strategy="device")
        check(f == frame and torch.equal(y, x), "A traced: the frame and the tensor")

    return traced(tbt, "A compress_array + decompress_array(device)", a,
                  ("tpbt_shuffle_blocks", "tpbt_unshuffle_blocks"))


def phase_cli(tbt, x_a, leaf, workdir: str) -> None:
    """The CLI in this process on A's bytes and on a .npy of a leaf of F
    (as float32): suggest (tpu_blosc's advice: NumPy's statistic, no
    kernel), compress (the file is compress_batch_with_options'),
    decompress, info, pack, unpack and verify round-trip."""
    import io

    from tpu_blosc_torch.__main__ import main as cli

    t_start = time.perf_counter()
    data = x_a.cpu().numpy().tobytes()
    raw = os.path.join(workdir, "a.bin")
    with open(raw, "wb") as f:
        f.write(data)
    arr = leaf.float().cpu().numpy()
    npy = os.path.join(workdir, "leaf.npy")
    np.save(npy, arr)
    log = io.StringIO()

    def run(*argv):
        with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
            rc = cli(list(argv))
        check(rc == 0, f"CLI {' '.join(argv[:1])}: exit 0 ({log.getvalue()[-500:]})")

    run("suggest", raw)
    run("compress", raw, "-o", raw + ".bl2")
    with open(raw + ".bl2", "rb") as f:
        frame = f.read()
    opts = tbt.Options(codec=tbt.LZ4, level=5, shuffle=tbt.SHUFFLE, type_size=4)
    check(frame == tbt.compress_batch_with_options([data], opts)[0],
          "CLI compress: the file is compress_batch_with_options' frame")
    run("decompress", raw + ".bl2", "-o", raw + ".out")
    with open(raw + ".out", "rb") as f:
        check(f.read() == data, "CLI decompress gives A's bytes back")
    run("info", raw + ".bl2")
    run("pack", npy, "-o", npy + ".tpba")
    run("info", npy + ".tpba")
    run("unpack", npy + ".tpba", "-o", npy + ".out.npy")
    back = np.load(npy + ".out.npy")
    check(back.dtype == arr.dtype and np.array_equal(back, arr), "CLI pack/unpack of F's leaf")
    stream = os.path.join(workdir, "a.tpbs")
    with tbt.StreamWriter(stream, opts, checksum=True) as w:
        w.write(data)
        w.write(frame)
    run("verify", stream, "--deep")
    check("2 records ok (crc32-checked, decoded)" in log.getvalue(), "CLI verify --deep")
    advice = [line for line in log.getvalue().splitlines() if "--codec" in line]
    print(f"CLI: suggest, compress, decompress, info, pack, info, unpack, verify --deep in "
          f"process {time.perf_counter() - t_start:.3f} s (suggest: "
          f"{advice[0].split(': ', 1)[1]})")


def start_module_info(frame: bytes, workdir: str):
    """Start ``python -m tpu_blosc_torch info`` on ``frame`` in a
    subprocess; most of its time is importing torch, so it runs beside
    path J's ranks, which import it too."""
    path = os.path.join(workdir, "a.bl2")
    with open(path, "wb") as f:
        f.write(frame)
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "tpu_blosc_torch", "info", path], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=os.path.dirname(os.path.abspath(__file__)))


def check_module_info(started) -> None:
    """The module invocation of start_module_info read A's frame."""
    t0, proc = started
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
        proc.wait()
    check(proc.returncode == 0 and "uncompressed: 67,108,864 bytes" in out,
          f"python -m tpu_blosc_torch info: {out[-300:]} {err[-300:]}")
    print(f"CLI: python -m tpu_blosc_torch info of A's frame in a subprocess beside path J: "
          f"exit 0 after {time.perf_counter() - t0:.3f} s")


def phase_trace_i(tbt, inputs) -> dict:
    """Traces on path I's group: compress_chunked_mesh with statistics of
    I's first stream (it must hold the run-count kernel; the card's
    profiler has lost the copy of the rows to the card and the shuffle
    launch after it there), then 20 launches each of the shuffle and the
    run-count kernel back to back on its (64, 1 MiB) rows already on the
    card, which the trace times without the gaps between launches."""
    from tpu_blosc_torch.chunk import choose_block_size
    from tpu_blosc_torch.dist import mesh as dmesh
    from tpu_blosc_torch.filters import rle

    _, data, opts = inputs[0]
    got = {"mesh": traced(tbt, "I compress_chunked_mesh(return_stats=True)",
                          lambda: dmesh.compress_chunked_mesh(data, opts, return_stats=True),
                          ("tpbt_seg_run_counts",))}
    raw = np.frombuffer(data, np.uint8)
    bs = choose_block_size(raw.size, opts.type_size, opts.block_size)
    nb = raw.size // bs
    x = dmesh.rows_to_device(raw[: nb * bs].reshape(nb, bs), torch.device(DEVICE))
    y = tbt.filters.filter_blocks(x, opts.type_size, opts.shuffle)
    rle.seg_run_counts(y)

    def kernels20():
        for _ in range(20):
            tbt.filters.filter_blocks(x, opts.type_size, opts.shuffle)
            rle.seg_run_counts(y)

    got["x20"] = traced(tbt, f"I shuffle and seg_run_counts x20 at ({nb}, {bs})", kernels20,
                        ("tpbt_shuffle_blocks", "tpbt_seg_run_counts"))
    for kernel, nbytes in (("tpbt_shuffle_blocks", 2 * y.numel()),
                           ("tpbt_seg_run_counts", y.numel())):
        row = got["x20"]["kernels"][kernel]
        b = bound(nbytes, 0)["bound_ms"]
        print(f"I {kernel} by trace: {row['count']} launches, mean {row['mean_ms']:.4f} ms = "
              f"{100 * b / row['mean_ms']:.0f}% of its {b:.4f} ms bound (bytes)")
    return got


GROUP_TIMEOUT_S = 120
J_WORLD = 2
J_LAYERS = 4
J_LEAF = "params/h/2/mlp/c_fc/w"
TAIL_I = bytes(range(123))


def mesh_stats_oracle(tbt, data: bytes, opts, world: int):
    """(histogram, block_diffs, sample_bytes) of ``data``'s full blocks as
    ``world`` ranks sample them, in NumPy from the host-filtered stream
    (after tpu_blosc/dist/mesh.py:298-310 and :257-277): rank d holds
    rows [d*per, (d+1)*per) of the batch padded with zero rows, samples
    512-byte chunks at a stride that keeps about 256 KiB (the whole shard
    when its size is no multiple of 512), and only bytes of real rows
    count."""
    from tpu_blosc_torch.chunk import choose_block_size

    raw = np.frombuffer(data, np.uint8)
    bs = choose_block_size(raw.size, opts.type_size, opts.block_size)
    nb_full = raw.size // bs
    rows = np.stack([tbt.filters.filter_bytes(raw[i * bs : (i + 1) * bs], opts.type_size,
                                              opts.shuffle) for i in range(nb_full)])
    diffs = (rows[:, 1:] != rows[:, :-1]).sum(axis=1).astype(np.int32)
    per = -(-nb_full // world)
    hist = np.zeros(256, np.int64)
    for d in range(world):
        shard = rows[d * per : (d + 1) * per].reshape(-1)  # the real rows lead the shard
        if per * bs % 512 == 0:
            stride = max(1, per * bs // 512 // ((256 << 10) // 512))
            starts = np.arange(0, per * bs // 512, stride) * 512
            sample = np.concatenate([shard[s : s + 512] for s in starts])
        else:
            sample = shard
        hist += np.bincount(sample, minlength=256)
    return hist.astype(np.int32), diffs, int(hist.sum())


def nonzero(launches: dict) -> dict:
    """The kernels a path launched, for a line one can read."""
    return {k: v for k, v in launches.items() if v}


def check_mesh_stats(tbt, name: str, stats, data: bytes, opts, world: int) -> None:
    hist, diffs, sample_bytes = mesh_stats_oracle(tbt, data, opts, world)
    check(np.array_equal(stats.histogram, hist) and stats.histogram.dtype == np.int32,
          f"{name}: MeshStats.histogram equals the NumPy oracle's for {world} shards")
    check(np.array_equal(stats.block_diffs, diffs),
          f"{name}: MeshStats.block_diffs equals the NumPy oracle's")
    check(stats.sample_bytes == sample_bytes == int(stats.histogram.sum()),
          f"{name}: histogram.sum() == sample_bytes == {sample_bytes}")


def start_group(device, store_file: str, rank: int, world: int) -> None:
    import datetime

    import torch.distributed as dist

    from tpu_blosc_torch.dist import initialize_distributed

    initialize_distributed(device, store=dist.FileStore(store_file, world), rank=rank,
                           world_size=world,
                           timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def path_i_inputs(cases) -> list:
    """(name, bytes, options) of path I's two streams: A's ramp with a
    123-byte tail under the byte shuffle, D's linspace under the bit
    shuffle."""
    (_, x_a, opts_a), (_, x_d, opts_d) = cases[0], cases[2]
    return [("I ramp+tail byte shuffle", x_a.cpu().numpy().tobytes() + TAIL_I, opts_a),
            ("I linspace bit shuffle", x_d.cpu().numpy().tobytes(), opts_d)]


def run_path_i(tbt, inputs) -> list:
    """Path I: in this process, one rank over NCCL on cuda:0 (the group is
    up already).  compress_chunked_mesh with statistics,
    decompress_chunked_mesh and the multihost pair on each stream."""
    from tpu_blosc_torch.dist import mesh as dmesh, multihost as dmh

    results = []
    for _, data, opts in inputs:
        frame, stats = dmesh.compress_chunked_mesh(data, opts, return_stats=True)
        decoded = dmesh.decompress_chunked_mesh(frame)
        mh_stats: dict = {}
        mh_frame = dmh.compress_chunked_multihost(len(data), data, opts, stats=mh_stats)
        mh_decoded = dmh.decompress_chunked_multihost(mh_frame)
        torch.cuda.synchronize()
        results.append((frame, stats, decoded, mh_frame, mh_stats, mh_decoded))
    return results


def check_and_time_path_i(tbt, inputs, results, launches: dict) -> dict:
    """Hold path I's results to the host path and the oracle, then time the
    calls and, for the byte-shuffled stream, the stages one by one."""
    import torch.distributed as dist

    from tpu_blosc_torch import device as dev
    from tpu_blosc_torch.chunk import choose_block_size
    from tpu_blosc_torch.dist import _group, mesh as dmesh, multihost as dmh
    from tpu_blosc_torch.filters import rle

    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
          and _group.comm_device().type == "cuda", "I: one rank over NCCL, collectives on the card")
    for kernel, count in (("shuffle_blocks", 1), ("unshuffle_blocks", 1), ("seg_run_counts", 2),
                          ("bit_shuffle_blocks", 1), ("bit_unshuffle_blocks", 1)):
        check(launches[kernel] == count, f"I: {kernel} launched {count} time(s) ({launches})")
    for kernel in ("shuffle_blocks", "unshuffle_blocks", "seg_run_counts"):
        check(launches[f"{kernel}.vec16"] == launches[kernel],
              f"I: {kernel} on its vec16 path ({launches})")
    host_frames = []
    for (name, data, opts), (frame, stats, decoded, mh_frame, mh_stats, mh_decoded) in zip(
            inputs, results):
        host_frame = tbt.compress_with_options(data, opts)
        host_frames.append(host_frame)
        check(frame == host_frame, f"{name}: the mesh frame == compress_with_options' frame")
        check(decoded == data, f"{name}: decompress_chunked_mesh gives the bytes back")
        check_mesh_stats(tbt, name, stats, data, opts, 1)
        check(mh_frame == host_frame, f"{name}: the multihost frame == the host frame")
        check(mh_decoded == (data, 0, len(data)),
              f"{name}: decompress_chunked_multihost gives the whole stream")
        check(mh_stats["num_processes"] == 1 and mh_stats["local_bytes"] == len(data),
              f"{name}: the multihost stats record ({mh_stats})")

    name, data, opts = inputs[0]
    frame = results[0][0]
    ts, mode = opts.type_size, opts.shuffle
    raw = np.frombuffer(data, np.uint8)
    bs = choose_block_size(raw.size, ts, opts.block_size)
    nb_full = raw.size // bs
    body = nb_full * bs
    blocks = raw[:body].reshape(nb_full, bs)
    t = {"compress_chunked_mesh": host_s(lambda: dmesh.compress_chunked_mesh(data, opts)),
         "compress_chunked_mesh with stats": host_s(
             lambda: dmesh.compress_chunked_mesh(data, opts, return_stats=True)),
         "decompress_chunked_mesh": host_s(lambda: dmesh.decompress_chunked_mesh(frame)),
         "compress_chunked_multihost": host_s(
             lambda: dmh.compress_chunked_multihost(len(data), data, opts)),
         "compress_with_options": host_s(lambda: tbt.compress_with_options(data, opts))}
    card = torch.device(DEVICE)
    st = {"copy to the card": host_s(lambda: dmesh.rows_to_device(blocks, card))}
    x = dmesh.rows_to_device(blocks, card)
    st["filter kernel"] = host_s(lambda: tbt.filters.filter_blocks(x, ts, mode))
    y = tbt.filters.filter_blocks(x, ts, mode)
    st["count kernel"] = host_s(lambda: rle.seg_run_counts(y))
    st["sample and bincount"] = host_s(lambda: dmesh.sample_histogram(y))
    _, hist, diffs = dmesh.rank_step(x, ts, mode)
    st["all_reduce"] = host_s(lambda: dist.all_reduce(hist.clone()))
    st["all_gather"] = host_s(lambda: _group.all_gather_rows(diffs))
    st["copy back"] = host_s(lambda: y.cpu())
    filtered = np.concatenate([y.cpu().numpy().reshape(-1),
                               tbt.filters.filter_bytes(raw[body:], ts, mode)])
    st["host codec"] = host_s(lambda: dev.compress_filtered_slots(filtered, opts, bs))
    slots = dev.compress_filtered_slots(filtered, opts, bs)
    st["payload list"] = host_s(lambda: dmh.slot_payloads(*slots))
    payloads, memf = dmh.slot_payloads(*slots)
    st["payload gather"] = host_s(lambda: dmh.allgather_payloads(payloads, memf))
    st["frame"] = host_s(lambda: dmh.assemble_payload_frame(opts, raw.size, bs, payloads, memf))
    check(dmh.assemble_payload_frame(opts, raw.size, bs, payloads, memf) == frame,
          "I: the stages, run one by one, give the frame")
    samp_bytes = int(results[0][1].sample_bytes)
    ev = {"filter kernel": cuda_ms(lambda: tbt.filters.filter_blocks(x, ts, mode)),
          "count kernel": cuda_ms(lambda: rle.seg_run_counts(y)),
          "count plain": cuda_ms(lambda: rle.seg_run_counts_plain(y), iters=3, warmup=1),
          "sample and bincount": cuda_ms(lambda: dmesh.sample_histogram(y)),
          "all_reduce": cuda_ms(lambda: dist.all_reduce(hist.clone())),
          "all_gather": cuda_ms(lambda: _group.all_gather_rows(diffs))}
    gb = raw.size / 1e9
    print(f"{name}: {raw.size} bytes, {nb_full} blocks of {bs} and a {raw.size - body}-byte "
          f"tail, ratio {raw.size / len(frame):.2f}; one rank over NCCL, medians of 5: "
          + ", ".join(f"{k} {gb / v:.3f} GB/s ({v * 1e3:.3f} ms)" for k, v in t.items())
          + f"; card {gpu_line()}")
    print(f"I stages (ms, medians of 5, host clock, each synchronised; card {gpu_line()}): "
          + " + ".join(f"{k} {v * 1e3:.3f}" for k, v in st.items())
          + f"; by CUDA events (mean of 20): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ev.items())
          + f"; the sample is {samp_bytes} bytes of {body}")
    return {"stage_ms": {k: v * 1e3 for k, v in st.items()}, "event_ms": ev,
            "host_frame": host_frames[0]}


def j_state(seed: int) -> dict:
    """Path J's state: F's, cut to the first J_LAYERS transformer blocks
    (full width; wte, wpe and ln_f stay)."""
    return gpt2_medium_state(seed, n_layer=J_LAYERS)


def j_device_route_records(state: dict, rank: int, world: int, threshold: int) -> int:
    """How many of ``rank``'s records of path J's sharded save take the
    device route: local shards of the 2-D weights, and on rank 0 the plain
    tensors, of more than ``threshold`` bytes."""
    count = 0
    for x in tree_leaves(state):
        if not isinstance(x, torch.Tensor):
            continue
        if x.dim() == 2:
            rows = -(-x.shape[0] // world)
            local_rows = max(0, min(x.shape[0], (rank + 1) * rows) - rank * rows)
            count += local_rows * x.shape[1] * x.element_size() > threshold
        elif rank == 0:
            count += x.numel() * x.element_size() > threshold
    return count


def j_sharded_tree(state: dict, mesh, rank: int, world: int, device: str):
    """``state`` with every 2-D weight as a DTensor Shard(0) over ``mesh``
    whose local shard is this rank's rows on ``device``; the other leaves
    plain tensors there."""
    from torch.distributed.tensor import DTensor, Shard

    def place(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dim() != 2:
            return x.to(device)
        rows = -(-x.shape[0] // world)
        local = x[rank * rows : (rank + 1) * rows].to(device).contiguous()
        return DTensor.from_local(local, mesh, [Shard(0)], run_check=False, shape=x.shape,
                                  stride=x.stride())

    return tree_map(place, state)


def j_mesh_launches(n: int, opts, rank: int, world: int) -> dict:
    """The launches of path J (a) on ``rank``, from the two partitions of
    the blocks: the filter step takes rows [rank*per, (rank+1)*per) of the
    full blocks in one shuffle launch and one count launch, the codec stage
    filters the run of its process_slice before those rows and the run
    after (a launch each, where there is one), and the decode unshuffles
    the rank's shard of the blocks, all of them compressed, in one."""
    from tpu_blosc_torch.chunk import choose_block_size
    from tpu_blosc_torch.dist.multihost import process_slice

    bs = choose_block_size(n, opts.type_size, opts.block_size)
    nb_full = n // bs
    per = -(-nb_full // world)
    lo_byte, hi_byte = process_slice(n, bs, rank, world)
    lo, hi = lo_byte // bs, min(hi_byte, nb_full * bs) // bs
    a0, a1 = max(lo, rank * per), min(hi, (rank + 1) * per)
    extra = 1 if a1 <= a0 else (lo < a0) + (a1 < hi)
    return {"shuffle_blocks": 1 + (extra if hi > lo else 0), "seg_run_counts": 1,
            "unshuffle_blocks": 1}


def worker_main(rank: int, world: int, store_file: str, workdir: str) -> int:
    """One rank of path J: Gloo collectives, the shared card for the data."""
    if not torch.cuda.is_available():
        print("chip_smoke worker: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist
    from torch.distributed.tensor import init_device_mesh

    import tpu_blosc_torch as tbt
    from tpu_blosc_torch import checkpoint
    from tpu_blosc_torch.dist import _group, mesh as dmesh
    from tpu_blosc_torch.filters import kernels

    check("jax" not in sys.modules, "the port imported jax")
    torch.cuda.set_device(0)
    start_group("cpu", store_file, rank, world)
    try:
        check(dist.get_backend() == "gloo" and _group.comm_device().type == "cpu"
              and (_group.rank(), _group.world_size()) == (rank, world),
              f"J rank {rank}: {world} ranks over Gloo")
        name = f"J rank {rank}"
        # (a) one frame from both ranks
        data = np.arange(16 * MIB, dtype=np.float32).tobytes() + TAIL_I
        opts = tbt.Options(codec=tbt.Codec.LZ4, level=5, shuffle=tbt.Shuffle.SHUFFLE,
                           type_size=4)
        kernels.reset_launches()
        t0 = time.perf_counter()
        frame, stats = dmesh.compress_chunked_mesh(data, opts, return_stats=True)
        t_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        decoded = dmesh.decompress_chunked_mesh(frame)
        t_dec = time.perf_counter() - t0
        launches_a = dict(kernels.launches)
        check(frame == tbt.compress_with_options(data, opts),
              f"{name}: the mesh frame == compress_with_options' frame")
        check(decoded == data, f"{name}: decompress_chunked_mesh gives the bytes back")
        check_mesh_stats(tbt, name, stats, data, opts, world)
        for kernel, count in j_mesh_launches(len(data), opts, rank, world).items():
            check(launches_a[kernel] == launches_a[f"{kernel}.vec16"] == count,
                  f"{name}: {kernel} launched {count} time(s) by the mesh pair, on its "
                  f"vec16 path ({launches_a})")
        with open(os.path.join(workdir, f"j_frame.r{rank}"), "wb") as f:
            f.write(frame)
        t_mesh2 = host_s(lambda: dmesh.compress_chunked_mesh(data, opts), reps=3)

        # (b) a sharded checkpoint: CUDA local shards, then CPU ones
        state = j_state(SEED)
        opts_f = tbt.Options(codec=tbt.Codec.LZ4, level=5, shuffle=tbt.Shuffle.SHUFFLE)
        prefix = os.path.join(workdir, "j_ckpt")
        tree = j_sharded_tree(state, init_device_mesh(DEVICE, (world,)), rank, world, DEVICE)
        dist.barrier()
        kernels.reset_launches()
        t0 = time.perf_counter()
        checkpoint.save_pytree_sharded(prefix, tree, opts_f)
        t_save = time.perf_counter() - t0
        launches_b = dict(kernels.launches)
        expected = j_device_route_records(state, rank, world, tbt.AUTO_BLOCK_THRESHOLD)
        check(expected >= 1 and launches_b["shuffle_blocks"] == expected
              and launches_b["shuffle_blocks.vec16"] == expected,
              f"{name}: the shuffle kernel launched once for each of the {expected} CUDA "
              f"records over {tbt.AUTO_BLOCK_THRESHOLD} bytes ({launches_b})")
        cpu_tree = j_sharded_tree(state, init_device_mesh("cpu", (world,)), rank, world, "cpu")
        t0 = time.perf_counter()
        checkpoint.save_pytree_sharded(prefix + "_cpu", cpu_tree, opts_f)
        t_cpu = time.perf_counter() - t0
        mine, plain = (f"{p}.p{rank}.tpbs" for p in (prefix, prefix + "_cpu"))
        with open(mine, "rb") as a, open(plain, "rb") as b:
            same = a.read() == b.read()
        check(same, f"{name}: its file equals the one it writes from CPU local shards")
        os.remove(plain)
        dist.barrier()
        local_bytes = sum(
            x.to_local().numel() * x.element_size() if hasattr(x, "to_local")
            else x.numel() * x.element_size() * (rank == 0)
            for x in tree_leaves(tree) if isinstance(x, torch.Tensor))
        record = {"rank": rank, "launches_a": launches_a, "launches_b": launches_b,
                  "mesh_ms": t_mesh * 1e3, "mesh_ms_median3": t_mesh2 * 1e3,
                  "mesh_decode_ms": t_dec * 1e3, "save_s": t_save, "save_cpu_s": t_cpu,
                  "local_bytes": local_bytes, "file_bytes": os.path.getsize(mine),
                  "device_route_records": expected}
        with open(os.path.join(workdir, f"j.r{rank}.json"), "w") as f:
            json.dump(record, f)
        # one write, so that the ranks' lines do not run into each other
        sys.stdout.write(
            f"{name} of {world} (Gloo, cuda:0): compress_chunked_mesh {t_mesh * 1e3:.3f} ms "
            f"first, {t_mesh2 * 1e3:.3f} ms median of 3, decompress_chunked_mesh "
            f"{t_dec * 1e3:.3f} ms, launches {nonzero(launches_a)}; save_pytree_sharded of "
            f"{local_bytes} local bytes into {record['file_bytes']} in {t_save:.3f} s "
            f"(from CPU shards {t_cpu:.3f} s), {expected} record(s) on the device route, "
            f"launches {nonzero(launches_b)}\n")
        sys.stdout.flush()
    finally:
        dist.destroy_process_group()
    return 0


def run_path_j(workdir: str) -> list:
    """Path J: start this script once per rank, wait, and read what the
    ranks wrote.  A rank that fails or outlasts its time fails the run;
    every rank is stopped before this returns."""
    store = os.path.join(workdir, "store_j")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               "--world", str(J_WORLD), "--store", store, "--workdir", workdir])
             for r in range(J_WORLD)]
    try:
        deadline = time.monotonic() + 420
        for r, proc in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "no exit code in time"
            check(rc == 0, f"J: rank {r} exited with 0 ({rc})")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    records = []
    for r in range(J_WORLD):
        with open(os.path.join(workdir, f"j.r{r}.json")) as f:
            records.append(json.load(f))
    return records


def check_path_j(tbt, records: list, host_frame: bytes, workdir: str) -> None:
    """The ranks' frames against each other and the host frame; the set
    they wrote, loaded here, against the tensors it was made from."""
    from tpu_blosc_torch import checkpoint

    for r in range(J_WORLD):
        with open(os.path.join(workdir, f"j_frame.r{r}"), "rb") as f:
            check(f.read() == host_frame, f"J: rank {r}'s frame equals the host frame")
    state = j_state(SEED)
    prefix = os.path.join(workdir, "j_ckpt")
    t0 = time.perf_counter()
    loaded = checkpoint.load_pytree_sharded(prefix, J_WORLD)
    t_load = time.perf_counter() - t0
    want, got = tree_leaves(state), tree_leaves(loaded)
    check(len(got) == len(want), "J: the loaded tree has every leaf")
    for x, y in zip(want, got):
        if isinstance(x, torch.Tensor):
            check(y.device.type == "cpu" and y.dtype == x.dtype and torch.equal(x.cpu(), y),
                  "J: load_pytree_sharded gives the leaf back exactly")
        else:
            check(x == y, f"J: load_pytree_sharded gives {x!r} back")
    node = state
    for seg in J_LEAF.split("/"):
        node = node[int(seg)] if isinstance(node, list) else node[seg]
    check(torch.equal(checkpoint.load_leaf_sharded(prefix, J_WORLD, J_LEAF), node.cpu()),
          f"J: load_leaf_sharded of {J_LEAF}")
    nbytes = sum(x.numel() * x.element_size() for x in want if isinstance(x, torch.Tensor))
    size = sum(rec["file_bytes"] for rec in records)
    print(f"J sharded checkpoint: {J_LAYERS} layers, wte, wpe, ln_f at gpt2-medium's width, "
          f"{nbytes} bytes into {size} bytes in {J_WORLD} files, ratio {nbytes / size:.3f}; "
          f"save_pytree_sharded {max(rec['save_s'] for rec in records):.3f} s (the slower "
          f"rank), load_pytree_sharded {t_load:.3f} s = {nbytes / 1e9 / t_load:.3f} GB/s; "
          f"card {gpu_line()}")


def cpu_line() -> str:
    """The host's CPU model and its logical cores: the host phases time
    host code.  The model comes from /proc/cpuinfo, else from lscpu, else
    only the architecture is known."""
    import platform

    model = None
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key.strip().lower() in ("model name", "cpu model") and value.strip():
                model = value.strip()
                break
    if model is None and shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=60).stdout
        for line in out.splitlines():
            key, _, value = line.partition(":")
            if key.strip() in ("Model name", "Vendor ID") and value.strip():
                model = value.strip()
                break
    return f"{model or 'CPU model not reported'} ({platform.machine()}), " \
           f"{os.cpu_count()} logical cores"


def card_and_host() -> str:
    return f"card {gpu_line()}; host {cpu_line()}"


def run_child(code: str, args: list, what: str, cwd: str, env: dict | None = None,
              timeout: int = 600) -> dict:
    """Run ``code`` in a fresh interpreter; its last stdout line is a JSON
    object, returned.  A child that fails fails the run."""
    proc = subprocess.run([sys.executable, "-c", code, *map(str, args)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)
    check(proc.returncode == 0, f"{what}: exit {proc.returncode}: {proc.stdout[-1500:]} "
                                f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


STANDALONE_MIB = 16

# Run from a directory that holds a copy of tpu_blosc_torch/ and nothing
# else of the repository: build there, then path A at argv[1] MiB.
STANDALONE_CHILD = r"""
import importlib.util, json, os, sys, time
from concurrent.futures import ThreadPoolExecutor
assert importlib.util.find_spec("tpu_blosc") is None, "a copy of tpu_blosc is importable"
import torch
import tpu_blosc_torch as tbt
from tpu_blosc_torch.filters import kernels
from tpu_blosc_torch.native import backend
here = os.path.realpath(os.getcwd())
for path in (backend.SOURCE, backend.LIB_PATH, backend.FAST_PATH, kernels.CSRC, kernels.LIB_PATH):
    assert os.path.realpath(path).startswith(here + os.sep), path
t0 = time.perf_counter()
with ThreadPoolExecutor(2) as pool:
    for build in [pool.submit(backend.lib), pool.submit(kernels.lib)]:
        build.result()
build_s = time.perf_counter() - t0
x = torch.arange(int(sys.argv[1]) << 18, dtype=torch.float32, device="cuda")
opts = tbt.Options(codec=tbt.Codec.LZ4, level=5, shuffle=tbt.Shuffle.SHUFFLE, type_size=4)
kernels.reset_launches()
frame = tbt.compress_array(x, opts)
y = tbt.decompress_array(frame, torch.float32, device="cuda", strategy="device")
torch.cuda.synchronize()
launches = dict(kernels.launches)
assert torch.equal(x, y)
with open("a.bl2", "wb") as f:
    f.write(frame)
print(json.dumps({"build_s": build_s, "host_codec_s": backend.build_seconds,
                  "fastcall_s": backend.fast_build_seconds, "kernels_s": kernels.build_seconds,
                  "fastcall": backend.fastcall_status(), "launches": launches}))
"""


def phase_standalone(tbt, workdir: str) -> dict:
    """Copy only tpu_blosc_torch/ into ``workdir``; in a subprocess whose
    sys.path holds no copy of tpu_blosc, build there and run path A at
    STANDALONE_MIB MiB on the card.  The frame must equal this process's.
    Returns the kernel launches of the child's path A."""
    here = os.path.dirname(os.path.abspath(__file__))
    copy = os.path.join(workdir, "standalone")
    shutil.copytree(os.path.join(here, "tpu_blosc_torch"), os.path.join(copy, "tpu_blosc_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    res = run_child(STANDALONE_CHILD, [STANDALONE_MIB], "standalone", copy, env)
    wall = time.perf_counter() - t0
    with open(os.path.join(copy, "a.bl2"), "rb") as f:
        frame = f.read()
    x = torch.arange(STANDALONE_MIB << 18, dtype=torch.float32, device=DEVICE)
    opts = tbt.Options(codec=tbt.Codec.LZ4, level=5, shuffle=tbt.Shuffle.SHUFFLE, type_size=4)
    check(frame == tbt.compress_array(x, opts), "standalone: the copy's frame is this process's")
    check_fast_path("standalone A", res["launches"])
    check_fastcall_status(res["fastcall"], "standalone")
    print(f"standalone: a copy of tpu_blosc_torch/ alone built in {res['build_s']:.1f} s "
          f"(host codec {res['host_codec_s']:.1f} s, fastcall module {res['fastcall_s'] or 0:.1f} s "
          f"after it, CUDA kernels {res['kernels_s']:.1f} s, at once), {res['fastcall']}; "
          f"path A at {STANDALONE_MIB} MiB gave this process's frame; child {wall:.1f} s "
          f"in all ({card_and_host()})")
    return res["launches"]


NATIVE_LESS_MIB = 4

# Run with TPU_BLOSC_NO_NATIVE=1: argv[1] a directory for the frames,
# argv[2] the MiB of the float32 ramp.
NATIVE_LESS_CHILD = r"""
import json, os, sys, time
import numpy as np
import torch
import tpu_blosc_torch as tbt
from tpu_blosc_torch.filters import kernels
from tpu_blosc_torch.native import backend
out_dir, mib = sys.argv[1], int(sys.argv[2])
assert not backend.available() and tbt.backend_name() == "python+cuda", tbt.backend_name()
kernels.lib()  # built before the timed calls
data = np.arange(mib << 18, dtype=np.float32).tobytes()
x = torch.from_numpy(np.frombuffer(data, np.float32).copy()).to("cuda")
runs, frames = {}, {}


def timed(name, fn):
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    runs[name] = {"s": time.perf_counter() - t0, "launches": dict(kernels.launches)}
    return out


def opts(mode, block_size):
    return tbt.Options(codec=tbt.Codec.LZ4, level=5, shuffle=tbt.Shuffle[mode], type_size=4,
                       block_size=block_size)


for mode in ("SHUFFLE", "BITSHUFFLE"):
    frames["compress " + mode] = timed("compress " + mode, lambda: tbt.compress(
        data, tbt.Codec.LZ4, 5, tbt.Shuffle[mode], 4))
    back = timed("decompress " + mode, lambda: tbt.decompress(frames["compress " + mode]))
    assert back == data
    frames["compress_array " + mode] = timed(
        "compress_array " + mode, lambda: tbt.compress_array(x, opts(mode, 1 << 20)))
    y = timed("decompress_array(device) " + mode, lambda: tbt.decompress_array(
        frames["compress_array " + mode], torch.float32, device="cuda", strategy="device"))
    assert torch.equal(x, y)
# the device entry point's frames against the host route's (plain filters)
equal_host = {
    "compress_array " + mode: frames["compress_array " + mode]
    == tbt.compress_with_options(data, opts(mode, 1 << 20))
    for mode in ("SHUFFLE", "BITSHUFFLE")}
for name, frame in frames.items():
    with open(os.path.join(out_dir, name.replace(" ", "_") + ".bl2"), "wb") as f:
        f.write(frame)
print(json.dumps({"runs": runs, "equal_host": equal_host, "names": list(frames)}))
"""

# each native-less call, and the one filter kernel it must launch once
# (None: the host route, which filters with the plain versions)
NATIVE_LESS_LAUNCH = {
    "compress SHUFFLE": None, "decompress SHUFFLE": None,
    "compress_array SHUFFLE": "shuffle_blocks",
    "decompress_array(device) SHUFFLE": "unshuffle_blocks",
    "compress BITSHUFFLE": None, "decompress BITSHUFFLE": None,
    "compress_array BITSHUFFLE": "bit_shuffle_blocks",
    "decompress_array(device) BITSHUFFLE": "bit_unshuffle_blocks",
}
FILTER_KERNELS = ("shuffle_blocks", "unshuffle_blocks", "bit_shuffle_blocks",
                  "bit_unshuffle_blocks")


def phase_native_less(tbt, workdir: str) -> list:
    """The route without a native build, in a subprocess with
    TPU_BLOSC_NO_NATIVE=1: compress of a host float32 ramp of
    NATIVE_LESS_MIB MiB (LZ4 5, byte and bit shuffle, ts 4) and its
    decompress, which filter on the host and launch no filter kernel,
    then compress_array and decompress_array(strategy="device") of the
    same data as a CUDA tensor, each of which launches its filter kernel
    exactly once.  Every frame decodes here, on the native route, and
    compress_array's equals the host route's frame of the same data.
    Returns each call's launches."""
    out_dir = os.path.join(workdir, "native_less")
    os.makedirs(out_dir)
    env = dict(os.environ, TPU_BLOSC_NO_NATIVE="1")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = run_child(NATIVE_LESS_CHILD, [out_dir, NATIVE_LESS_MIB], "native-less", here, env)
    wall = time.perf_counter() - t0
    data = np.arange(NATIVE_LESS_MIB << 18, dtype=np.float32).tobytes()
    for name in res["names"]:
        with open(os.path.join(out_dir, name.replace(" ", "_") + ".bl2"), "rb") as f:
            check(tbt.decompress(f.read()) == data, f"native-less {name}: decodes natively")
    for name, same in res["equal_host"].items():
        check(same, f"native-less {name}: the host route's frame")
    for name, kernel in NATIVE_LESS_LAUNCH.items():
        launched = {k: v for k, v in res["runs"][name]["launches"].items()
                    if v and k in FILTER_KERNELS}
        check(launched == ({kernel: 1} if kernel else {}),
              f"native-less {name}: filter launches {launched}, expected {kernel or 'none'}")
    print(f"native-less (TPU_BLOSC_NO_NATIVE=1, pure-Python LZ4 5, ts 4) on a "
          f"{NATIVE_LESS_MIB} MiB float32 ramp; {card_and_host()}: " + "; ".join(
              f"{name} {run['s']:.3f} s = {len(data) / run['s'] / 1e6:.2f} MB/s, "
              + (f"one {LAUNCH_NAMES[NATIVE_LESS_LAUNCH[name]]}" if NATIVE_LESS_LAUNCH[name]
                 else "plain host filter")
              for name, run in res["runs"].items()))
    print(f"native-less: every frame decodes on the native route, compress_array's equal "
          f"the host route's; phase {wall:.1f} s with the child's start and kernel build")
    return [run["launches"] for run in res["runs"].values()]


FAST_CALLS = 10_000

# argv[1] calls of compress() on the 100 KB i % 256 ramp; the binding is
# the one the environment picks (TPU_BLOSC_NO_FAST=1: ctypes).
FAST_CHILD = r"""
import json, sys, time
import numpy as np
import tpu_blosc_torch as tbt
from tpu_blosc_torch.native import backend
data = (np.arange(100 * 1024) % 256).astype(np.uint8).tobytes()
n = int(sys.argv[1])
frame = tbt.compress(data, tbt.LZ4, 5, tbt.SHUFFLE, 4)
assert tbt.decompress(frame) == data
t0 = time.perf_counter()
for _ in range(n):
    tbt.compress(data, tbt.LZ4, 5, tbt.SHUFFLE, 4)
us = (time.perf_counter() - t0) / n * 1e6
print(json.dumps({"status": backend.fastcall_status(), "us": us, "frame": frame.hex()}))
"""


def check_fastcall_status(status: str, what: str) -> None:
    """Where Python's headers are present the fastcall module must load;
    where they are missing the backend says so."""
    import sysconfig

    headers = os.path.exists(os.path.join(sysconfig.get_paths()["include"], "Python.h"))
    want = "fastcall: loaded" if headers else "fastcall: unavailable (no Python.h)"
    check(status == want, f"{what}: {status}, expected {want}")


def phase_fastcall(tbt) -> None:
    """compress() of the 100 KB i % 256 ramp (LZ4 5, shuffle, ts 4;
    BASELINE.json config 1), FAST_CALLS calls in a subprocess with the
    fastcall module and FAST_CALLS in one with TPU_BLOSC_NO_FAST=1; the
    frames must be equal, and this process's."""
    here = os.path.dirname(os.path.abspath(__file__))
    fast = run_child(FAST_CHILD, [FAST_CALLS], "fastcall", here)
    slow = run_child(FAST_CHILD, [FAST_CALLS], "fastcall, TPU_BLOSC_NO_FAST=1", here,
                     dict(os.environ, TPU_BLOSC_NO_FAST="1"))
    check_fastcall_status(fast["status"], "fastcall")
    check(slow["status"] == "fastcall: off (TPU_BLOSC_NO_FAST)", f"no-fast: {slow['status']}")
    data = (np.arange(100 * 1024) % 256).astype(np.uint8).tobytes()
    check(fast["frame"] == slow["frame"] == tbt.compress(data, tbt.LZ4, 5, tbt.SHUFFLE, 4).hex(),
          "fastcall: the frames of both bindings are equal")
    print(f"fastcall: compress() of the 100 KB i % 256 ramp, LZ4 5, shuffle, ts 4, "
          f"{FAST_CALLS} calls a binding: {fast['status']} {fast['us']:.3f} us a call, "
          f"ctypes (TPU_BLOSC_NO_FAST=1) {slow['us']:.3f} us a call; frames equal "
          f"({card_and_host()})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; it runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import tpu_blosc_torch as tbt
    from tpu_blosc_torch.filters import kernels

    check("jax" not in sys.modules, "the port imported jax")
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)

    phase_environment()
    kern = phase_kernels(gen)
    match_k = phase_match_kernel(rng)
    probe_k = phase_probe_kernel(rng)
    bit_k = phase_bit_kernels(gen)
    rle_k = phase_rle_kernels(rng)
    fill_k = phase_fill_kernel(rng)
    cases = make_cases(tbt, rng) + make_bit_cases(tbt, rng)  # A, B, D, E

    results = run_main_path(tbt, cases)
    for (name, _, opts), (_, _, launches) in zip(cases, results):
        print(f"main path {name}, launches: {launches}")
        if opts.shuffle == tbt.Shuffle.BITSHUFFLE:
            check_bit_path(name, launches)
        else:
            check_fast_path(name, launches)

    for (name, x, opts), (frame, y, _) in zip(cases, results):
        n_raw = check_and_time_case(tbt, name, x, opts, frame, y)
        if name[0] in "BE":
            check(n_raw >= 1, f"{name[0]}: the random block took the memcpy fallback")
    _, x_a, opts_a = cases[0]
    frame_a = results[0][0]
    trace_a = phase_stats_a(tbt, x_a, opts_a, frame_a)
    registry_a = phase_registry(tbt, x_a, opts_a, frame_a)
    _, x_e, opts_e = cases[3]
    part = x_e[: 8 * MIB]
    check(tbt.compress_array(part, opts_e, strategy="match")
          == tbt.compress_array(part.cpu(), opts_e, strategy="match"),
          "E: the CUDA route's match frame equals the CPU route's on 16 MiB")
    print("E: compress_array(strategy='match') of a 16 MiB slice equals the CPU route's")

    x_c = torch.from_numpy(match_data()).to(DEVICE)
    opts_c = tbt.Options(codec=tbt.Codec.LZ4, level=5, shuffle=tbt.Shuffle.SHUFFLE,
                         type_size=4, block_size=MIB)
    kernels.reset_launches()
    frame_c, y_c = run_path_c(tbt, x_c, opts_c)
    launches_c = dict(kernels.launches)
    print(f"main path C, launches: {launches_c}")
    for kernel in ("match_nibble", "match_count"):
        check(launches_c[kernel] >= 1 and launches_c[f"{kernel}.vec16"] == launches_c[kernel],
              f"{kernel} launched by compress_array(match), on its vec16 path ({launches_c})")
    check_fast_path("C", launches_c)
    match_c = check_and_time_path_c(tbt, x_c, opts_c, frame_c, y_c)
    del y_c

    x_g = rle_data()
    opts_g = tbt.Options(codec=tbt.Codec.LZ4, level=5, shuffle=tbt.Shuffle.SHUFFLE,
                         type_size=4, block_size=MIB)
    kernels.reset_launches()
    frame_g, y_g = run_path_g(tbt, x_g, opts_g)
    launches_g = dict(kernels.launches)
    print(f"main path G, launches: {launches_g}")
    for kernel in ("shuffle_blocks", "seg_run_counts", "rows_rle"):
        check(launches_g[kernel] >= 1 and launches_g[f"{kernel}.vec16"] == launches_g[kernel],
              f"{kernel} launched by compress_array(rle), on its vec16 path ({launches_g})")
    check_fast_path("G", launches_g)
    rle_g = check_and_time_path_g(tbt, x_g, opts_g, frame_g, y_g)
    del x_g, y_g, frame_g

    frames_h = {"match": frame_c,
                "host encoder's": tbt.compress_with_options(x_c.cpu().numpy(), opts_c)}
    kernels.reset_launches()
    decoded_h = run_path_h(tbt, frames_h)
    launches_h = dict(kernels.launches)
    print(f"main path H, launches: {launches_h}")
    for kernel in ("match_fill", "unshuffle_blocks"):
        check(launches_h[kernel] == len(frames_h)
              and launches_h[f"{kernel}.vec16"] == launches_h[kernel],
              f"{kernel} launched by each decompress_array(records), on its vec16 path "
              f"({launches_h})")
    fill_h = check_and_time_path_h(tbt, x_c, frames_h, decoded_h)
    del decoded_h, frames_h
    torch.cuda.empty_cache()

    state = gpt2_medium_state(SEED)
    opts_f = tbt.Options(codec=tbt.Codec.LZ4, level=5, shuffle=tbt.Shuffle.SHUFFLE)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        kernels.reset_launches()
        f_run = run_path_f(tbt, state, opts_f, workdir)
        launches_f = dict(kernels.launches)
        print(f"main path F, launches: {launches_f}")
        for kernel in ("shuffle_blocks", "unshuffle_blocks"):
            check(launches_f[kernel] >= 1, f"F: {kernel} launched ({launches_f})")
        check_path_f(tbt, state, opts_f, *f_run, workdir)
        del f_run
        traced_path = os.path.join(workdir, "traced.tpbs")
        trace_f = traced(tbt, "F save_pytree", lambda: tbt.save_pytree(traced_path, state, opts_f),
                         ("tpbt_shuffle_blocks",))
        os.remove(traced_path)
        launches_h_load = check_records_load(tbt, state, x_c, opts_f, workdir)
    finally:
        shutil.rmtree(workdir)

    launches_adv = phase_advisors(tbt, rng, cases[:2])
    print(f"advisors, launches: {launches_adv}")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        phase_cli(tbt, x_a, state["params"]["h"][0]["mlp"]["c_fc"]["w"], workdir)
    finally:
        shutil.rmtree(workdir)
    del state
    torch.cuda.empty_cache()

    import torch.distributed as dist

    workdir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        start_group(None, os.path.join(workdir, "store_i"), 0, 1)
        try:
            inputs_i = path_i_inputs(cases)
            kernels.reset_launches()
            results_i = run_path_i(tbt, inputs_i)
            launches_i = dict(kernels.launches)
            print(f"main path I, launches: {nonzero(launches_i)}")
            dist_i = check_and_time_path_i(tbt, inputs_i, results_i, launches_i)
            del results_i
            trace_i = phase_trace_i(tbt, inputs_i)
        finally:
            dist.destroy_process_group()
        sys.stdout.flush()
        module_info = start_module_info(frame_a, workdir)
        try:
            records_j = run_path_j(workdir)
        except BaseException:
            module_info[1].kill()
            module_info[1].wait()
            raise
        check_module_info(module_info)
        launches_j = [rec[key] for rec in records_j for key in ("launches_a", "launches_b")]
        print(f"main path J, launches by rank, (a) the frame and (b) the sharded save: "
              f"{[nonzero(c) for c in launches_j]}")
        check_path_j(tbt, records_j, dist_i["host_frame"], workdir)
    finally:
        shutil.rmtree(workdir)

    workdir = tempfile.mkdtemp(prefix="chip_smoke_host_")
    try:
        launches_standalone = phase_standalone(tbt, workdir)
        launches_native_less = phase_native_less(tbt, workdir)
    finally:
        shutil.rmtree(workdir)
    phase_fastcall(tbt)

    print("device busy share by trace (kernels, copies and memsets over the window, from "
          f"complete traces only; card {gpu_line()}): " + ", ".join(
              f"{k} {100 * tr['busy_share']:.2f}% of {tr['window_ms']:.3f} ms"
              if tr["busy_share"] is not None else
              f"{k} incomplete in {len(tr['attempts'])} attempts"
              for k, tr in (("A", trace_a), ("F", trace_f), ("I", trace_i["mesh"]))))
    print(f"registry: {json.dumps(registry_a)}")
    src = "tpu_blosc_torch/csrc/"
    pk = "tpu_blosc/filters/pallas_kernels.py:"
    # the kernels' launches in the main paths A, B, D, E, C, G, H (the two
    # decodes, and the checkpoint load), F, I, J (each rank's two parts),
    # the standalone copy's A and each native-less call
    main_runs = [counts for _, _, counts in results] + [
        launches_c, launches_g, launches_h, launches_h_load, launches_f, launches_i,
        *launches_j, launches_standalone, *launches_native_less]

    def shuffle_entry(kernel: str, key: str, replaces: str) -> dict:
        """The JSON entry of one shuffle kernel; ``key`` names its times."""
        t4 = kern["times"][f"ts4 (64, {MIB})"]
        return {
            "name": f"tpbt_{kernel}", "route": "cuda", "source": src + "shuffle.cu",
            "replaces": replaces, "launches": sum(c[kernel] for c in main_runs),
            "launches_by_path": {p: sum(c[f"{kernel}.{p}"] for c in main_runs)
                                 for p in kernels.SHUFFLE_PATHS},
            "max_abs_err": kern["max_abs_err"],
            "ms": t4[key], "plain_ms": t4[f"{key}_plain"],
            # each byte read once and written once; nothing is computed
            **bound(2 * 64 * MIB, 0), "library_ms": t4[f"{key}_library"],
            # mean device ms of its launches in the traces of A, F and I
            "trace_ms": {k: tr["kernels"][f"tpbt_{kernel}"]["mean_ms"]
                         for k, tr in (("A", trace_a), ("F", trace_f),
                                       ("I, 20 back to back", trace_i["x20"]))
                         if f"tpbt_{kernel}" in tr["kernels"]},
            "times": {g: {"path": row["path"], "ms": row[key],
                          "plain_ms": row[f"{key}_plain"],
                          "library_ms": row[f"{key}_library"]}
                      for g, row in kern["times"].items()},
        }

    def bit_entry(name: str, kernel: str, key: str, line: int) -> dict:
        """The JSON entry of one bit-shuffle kernel (``kernel`` its launch
        count's name); ``key`` names its times."""
        t4 = bit_k["times"][f"ts4 (64, {MIB})"]
        return {
            "name": name, "route": "cuda", "source": src + "bitshuffle.cu",
            "replaces": f"tpu_blosc/filters/batched.py:{line}",
            "launches": sum(c[kernel] for c in main_runs),
            "max_abs_err": bit_k["max_abs_err"],
            "ms": t4[key], "plain_ms": t4[f"{key}_plain"],
            # each byte read once and written once; an 8x8 bit transpose
            # moves every bit once: 8 operations a byte
            **bound(2 * 64 * MIB, 8 * 64 * MIB), "library_ms": None,
            "times": {g: {"ms": row[key], "plain_ms": row[f"{key}_plain"],
                          "offset4_ms": row[f"{key}_offset4"]}
                      for g, row in bit_k["times"].items()},
        }

    probe_entry = {"name": "tpbt_probe_tiles", "route": "cuda", "source": src + "probe.cu",
                   "launches": launches_adv["probe_tiles"],
                   "max_abs_err": probe_k["max_abs_err"],
                   "ms": probe_k["ms"], "plain_ms": probe_k["plain_ms"],
                   # 64 MiB read once (the per-tile sums are 512 bytes); one
                   # add and one compare a byte
                   **bound(64 * MIB + 512, 2 * 64 * MIB), "library_ms": None}
    print(json.dumps({"kernels": [
        shuffle_entry("shuffle_blocks", "shuffle", pk + "293"),
        shuffle_entry("unshuffle_blocks", "unshuffle", pk + "315"),
        {"name": "tpbt_match_nibble", "route": "cuda", "source": src + "match.cu",
         "replaces": pk + "463", "launches": launches_c["match_nibble"],
         **match_c["nibble"], "library_ms": None,
         "max_abs_err": max(match_k["max_abs_err"], match_c["nibble"]["max_abs_err"])},
        {"name": "tpbt_match_count", "route": "cuda", "source": src + "match.cu",
         "replaces": "tpu_blosc/device.py:303", "launches": launches_c["match_count"],
         **match_c["count"], "library_ms": None,
         "max_abs_err": max(match_k["count_max_abs_err"], match_c["count"]["max_abs_err"])},
        {**probe_entry, "replaces": pk + "125"},
        {**probe_entry, "replaces": pk + "126"},
        bit_entry("tpbt_bitshuffle_blocks", "bit_shuffle_blocks", "shuffle", 65),
        bit_entry("tpbt_bitunshuffle_blocks", "bit_unshuffle_blocks", "unshuffle", 74),
        {"name": "tpbt_seg_run_counts", "route": "cuda", "source": src + "rle.cu",
         "replaces": "tpu_blosc/device.py:165",
         "launches": sum(c["seg_run_counts"] for c in main_runs),
         **rle_g["counts"],
         "trace_ms": {"I, 20 back to back": trace_i["x20"]["kernels"][
             "tpbt_seg_run_counts"]["mean_ms"]},
         "max_abs_err": max(rle_k["counts_max_abs_err"], rle_g["counts"]["max_abs_err"])},
        {"name": "tpbt_rows_rle", "route": "cuda", "source": src + "rle.cu",
         "replaces": "tpu_blosc/device.py:184", "launches": launches_g["rows_rle"],
         **rle_g["rows"],
         "max_abs_err": max(rle_k["rows_max_abs_err"], rle_g["rows"]["max_abs_err"])},
        {"name": "tpbt_match_fill", "route": "cuda", "source": src + "fill.cu",
         "replaces": "tpu_blosc/device.py:1248",
         "launches": launches_h["match_fill"] + launches_h_load["match_fill"], **fill_h,
         "max_abs_err": max(fill_k["max_abs_err"], fill_h["max_abs_err"])},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def parse_args():
    import argparse

    parser = argparse.ArgumentParser(description="Drive the port's main paths on one GPU.")
    parser.add_argument("--rank", type=int, help="run as this rank of path J (set by the script)")
    parser.add_argument("--world", type=int, default=J_WORLD)
    parser.add_argument("--store", help="path J's FileStore")
    parser.add_argument("--workdir", help="path J's directory")
    return parser.parse_args()


if __name__ == "__main__":
    args = parse_args()
    if args.rank is not None:
        sys.exit(worker_main(args.rank, args.world, args.store, args.workdir))
    sys.exit(main())
