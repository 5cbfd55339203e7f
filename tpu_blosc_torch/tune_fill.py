"""Time variants of the fill kernel (csrc/fill.cu) on one CUDA GPU.

    python3 -m tpu_blosc_torch.tune_fill [name:kConst=value,...]... \\
        [--against other_fill.cu] [--offsets 256,1,3] [--stores]

Every ``name:kConst=value,...`` builds a copy of ``csrc/fill.cu`` with
those ``constexpr int`` constants replaced (``base:`` is the source as it
is; ``t256:kThreads=256`` the same kernel at 256 threads); ``--against``
adds another source with the same C interface, as "other" (an earlier
revision of the file, say).  Each build prints what ``ptxas -v`` reports,
is held to ``filters.fill.match_fill_plain`` at ten segment lengths (both
paths, views 1 and 4 bytes off alignment, literals on both sides of the
tile edges, dense and empty rows), and is then timed on synthetic records
of (1024, 262144) segments with 2.2% literals at each of ``--offsets``,
two turns of 20 launches, vec16 and generic path.  Offset 0 times a row
that gets its literals and zeros (records placed, nothing filled); a
negative offset -d times offset d with no record at all.

``--stores`` times, beside them, a kernel that does nothing but store
8192-byte tiles in the fill kernel's order (one block a row, tile after
tile), with ordinary 16-byte stores and with one bulk asynchronous store a
tile: what the card allows a kernel of this shape.

It is a tuning aid: nothing in the package calls it, and it needs nvcc and
a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

from .filters import fill as ff
from .filters import kernels

NSEG, SEG, DENSITY = 1024, 262144, 0.022
CHECK_OFFSETS = (1, 2, 3, 6, 4, 12, 24, 8, 20, 16, 48, 256, 768, 1024, 7, 250, 255, 257,
                 1023, 1020, 512, 96, 33, 31, 32, 36, 132, 128, 124)

STORES_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
template <bool kBulk>
__global__ void __launch_bounds__(256, 8) rows(uint8_t *out, int seg) {
  __shared__ __align__(128) uint8_t buf[2][8192];
  const int tid = threadIdx.x;
  for (int k = 0; k < seg / 8192; ++k) {
    uint8_t *o = out + (size_t)blockIdx.x * seg + (size_t)k * 8192;
    const uint4 v = make_uint4(k, tid, blockIdx.x, 0);
    if (!kBulk) {
      ((uint4 *)o)[tid] = v;
      ((uint4 *)o)[tid + 256] = v;
    } else {
      ((uint4 *)buf[k & 1])[tid] = v;
      ((uint4 *)buf[k & 1])[tid + 256] = v;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncthreads();
      if (tid == 0)
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
            "cp.async.bulk.commit_group;\n" ::"l"(__cvta_generic_to_global(o)),
            "r"((uint32_t)__cvta_generic_to_shared(buf[k & 1])), "r"(8192)
            : "memory");
    }
  }
  if (kBulk && tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
extern "C" int store_rows(void *out, int nseg, int seg, int bulk, void *stream) {
  if (bulk)
    rows<true><<<nseg, 256, 0, (cudaStream_t)stream>>>((uint8_t *)out, seg);
  else
    rows<false><<<nseg, 256, 0, (cudaStream_t)stream>>>((uint8_t *)out, seg);
  return (int)cudaGetLastError();
}
"""


def variant_source(base: str, spec: str) -> tuple[str, str]:
    """(name, source) of ``name:kConst=value,...``."""
    name, _, subs = spec.partition(":")
    src = base
    for sub in filter(None, subs.split(",")):
        const, value = sub.split("=")
        src, hits = re.subn(rf"(constexpr int {const} = )\d+;", rf"\g<1>{int(value)};", src)
        if hits != 1:
            raise SystemExit(f"{spec}: no constant {const} in fill.cu")
    return name, src


def build(sources: dict[str, str], workdir: str) -> dict[str, ctypes.CDLL]:
    """One nvcc a source, all at once; prints each build's ptxas lines."""
    procs = []
    for name, src in sources.items():
        path = os.path.join(workdir, name + ".cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(workdir, name + ".so")
        procs.append((name, lib, subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", path, "-o", lib],
            stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, lib, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{err[-6000:]}")
        used = [line.split("ptxas info    : ")[-1].strip() for line in err.splitlines()
                if "Used" in line or "spill" in line]
        print(f"{name} ptxas: " + " | ".join(used))
        libs[name] = ctypes.CDLL(lib)
    return libs


def bind_fill(lib: ctypes.CDLL):
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.tpbt_match_fill.restype = ctypes.c_int
    lib.tpbt_match_fill.argtypes = [p, p, p, p, p, i64, i64, ctypes.c_int, p]

    def launch(args, out, nseg, seg, path):
        rc = lib.tpbt_match_fill(*[a.data_ptr() for a in args], out.data_ptr(), nseg, seg,
                                 kernels.FILL_PATHS[path],
                                 torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"tpbt_match_fill returned CUDA error {rc}")
    return launch


def records(gen, nseg: int, seg: int, row_d: torch.Tensor, density: float, shape=None) -> list:
    """(pos, vals, row_first, row_d) on the card: each row's first d bytes
    and ``density`` of the rest literal; ``shape`` may edit the flags."""
    lit = torch.rand((nseg, seg), device="cuda", generator=gen) < density
    for r, d in enumerate(row_d.tolist()):
        lit[r, :d] = True
    if shape is not None:
        shape(lit)
    pos = torch.nonzero(lit.view(-1)).view(-1).to(torch.int32)
    vals = torch.randint(0, 256, pos.shape, dtype=torch.uint8, device="cuda", generator=gen)
    starts = (torch.arange(nseg + 1, device="cuda", dtype=torch.int64) * seg).to(torch.int32)
    return [pos, vals, torch.searchsorted(pos, starts).to(torch.int64), row_d.cuda()]


def check(launches: dict, gen) -> int:
    """Hold every build to the plain version; returns the mismatches."""
    tile, bad = kernels.FILL_TILE, 0
    for seg in (16, 256, 1000, 4096, tile, tile + 16, 2 * tile, 18440, 3 * tile + 5, SEG):
        offs = [d for d in CHECK_OFFSETS if d < seg]
        row_d = torch.tensor(offs + offs, dtype=torch.int32)
        nseg = len(row_d)

        def shape(lit):
            lit[0] = torch.rand(seg, device="cuda", generator=gen) < 0.3
            lit[len(offs):] = torch.rand((len(offs), seg), device="cuda", generator=gen) < 0.0005
            lit[-1] = False
            for edge in (tile - 1, tile, 2 * tile - 1, 2 * tile):
                if edge < seg:
                    lit[1::2, edge] = True

        args = records(gen, nseg, seg, row_d, 0.02, shape)
        want = ff.match_fill_plain(args[0], args[1], args[3], nseg, seg)
        buf = torch.empty(nseg * seg + 16, dtype=torch.uint8, device="cuda")
        for name, launch in launches.items():
            outs = [(torch.empty_like(want), "generic"),
                    (buf[4: 4 + nseg * seg].view(nseg, seg), "generic"),
                    (buf[1: 1 + nseg * seg].view(nseg, seg), "generic")]
            if seg % 16 == 0:
                outs.append((torch.empty_like(want), "vec16"))
            for out, path in outs:
                out.fill_(0xAA)
                launch(args, out, nseg, seg, path)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    rows = torch.nonzero((out != want).any(dim=1)).view(-1).tolist()
                    print(f"MISMATCH {name} seg={seg} {path} at {out.data_ptr() % 16} bytes off: "
                          f"rows at d={[int(row_d[r]) for r in rows][:12]}")
                    bad += 1
    return bad


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=["base:"])
    ap.add_argument("--against", help="another fill.cu to build and time as 'other'")
    ap.add_argument("--offsets", default="256,1,3,4,16,1024")
    ap.add_argument("--stores", action="store_true")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_fill: no CUDA device is available", file=sys.stderr)
        return 1
    with open(os.path.join(kernels.CSRC, "fill.cu")) as f:
        base = f.read()
    sources = dict(variant_source(base, spec) for spec in opts.variants)
    if opts.against:
        with open(opts.against) as f:
            sources = {"other": f.read(), **sources}
    if opts.stores:
        sources["stores"] = STORES_SOURCE
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    out = torch.empty((NSEG, SEG), dtype=torch.uint8, device="cuda")
    with tempfile.TemporaryDirectory(prefix="tune_fill_") as workdir:
        libs = build(sources, workdir)
        stores = libs.pop("stores", None)
        launches = {name: bind_fill(lib) for name, lib in libs.items()}
        bad = check(launches, gen)
        print(f"every build against the plain version: {bad} mismatches")
        if stores is not None:
            stores.store_rows.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p]
            for turn in range(2):
                ms = [cuda_ms(lambda: stores.store_rows(out.data_ptr(), NSEG, SEG, bulk, None))
                      for bulk in (0, 1)]
                print(f"stores only, ({NSEG}, {SEG}): ordinary {ms[0]:.4f} ms, bulk {ms[1]:.4f} "
                      f"ms; out.zero_() {cuda_ms(out.zero_):.4f} ms")
        for d in [int(x) for x in opts.offsets.split(",")]:
            density, filled = (0.0, -d) if d < 0 else (DENSITY, d)
            args = records(gen, NSEG, SEG, torch.full((NSEG,), max(d, 0), dtype=torch.int32),
                           density)
            args[3] = torch.full((NSEG,), filled, dtype=torch.int32, device="cuda")
            for turn in range(2):
                times = [f"{name} {cuda_ms(lambda: launch(args, out, NSEG, SEG, 'vec16')):.4f}/"
                         f"{cuda_ms(lambda: launch(args, out, NSEG, SEG, 'generic')):.4f}"
                         for name, launch in launches.items()]
                print(f"d={filled} records={args[0].numel()} ms vec16/generic: "
                      + "  ".join(times))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
