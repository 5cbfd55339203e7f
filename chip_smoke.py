#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

Run from the root of the repository, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the native host codec (g++) and the CUDA shuffle kernels (nvcc)
from the sources in the checkout into tpu_blosc_torch/_build/, then:

1. prints the card, its power limit, torch, CUDA and nvcc versions and
   the build times;
2. holds each kernel against its plain PyTorch version on the card
   (random bytes, type sizes 2, 3, 4, 8 and 16, three shapes each) and
   times both at (64, 1 MiB) for type sizes 4 and 8;
3. main path A: a 64 MiB float32 ramp, LZ4 level 5, byte shuffle;
4. main path B: 64 MB of float64 signal, ZSTD level 5, byte shuffle,
   with one 1 MiB block of random bytes (memcpy fallback) and a ragged
   tail;
5. prints the kernels' JSON line and, last, the ok line.

Each main path runs compress_array on the CUDA tensor and
decompress_array(strategy="device"), and must give the frame of the host
path (compress_with_options on the tensor's bytes) and the tensor back
exactly, with both kernels launched.  Any failure raises, so the script
exits non-zero without the ok line.  It imports nothing of JAX and exits
non-zero when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
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


def phase_environment() -> None:
    from tpu_blosc_torch.filters import kernels
    from tpu_blosc_torch.native import backend

    print(gpu_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([kernels.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    backend.lib()
    t1 = time.perf_counter()
    kernels.lib()
    t2 = time.perf_counter()
    print(f"build: host codec {backend.build_seconds:.1f} s compiling "
          f"({t1 - t0:.1f} s to load), shuffle kernels "
          f"{kernels.build_seconds:.1f} s compiling ({t2 - t1:.1f} s to load)")


def phase_kernels(rng) -> dict:
    """Each kernel against its plain version; returns the largest error
    and the times at (64, 1 MiB), ts 4 (for the JSON line)."""
    from tpu_blosc_torch.filters import batched, kernels

    worst = 0
    for ts in (2, 3, 4, 8, 16):
        big = MIB // (8 * ts) * (8 * ts)
        for nb, bs in ((1, 8 * ts), (7, 4096 * ts), (64, big)):
            x = torch.from_numpy(rng.integers(0, 256, (nb, bs), dtype=np.uint8)).cuda()
            keep = torch.from_numpy(rng.random(nb) < 0.5).cuda()
            keep[0] = nb > 1  # a raw row and, where nb > 1, a filtered one
            got = kernels.shuffle_blocks(x, ts)
            back = kernels.unshuffle_blocks(got, ts)
            kept = kernels.unshuffle_blocks(got, ts, keep_raw=keep)
            torch.cuda.synchronize()
            want = batched.shuffle_blocks_plain(x, ts)
            pairs = (
                (got, want),
                (back, batched.unshuffle_blocks_plain(got, ts)),
                (back, x),
                (kept, batched.unshuffle_blocks_plain(got, ts, keep)),
            )
            for a, b in pairs:
                check(torch.equal(a, b), f"kernel vs plain, ts={ts} shape={(nb, bs)}")
                worst = max(worst, int((a.int() - b.int()).abs().max()))
            check(torch.equal(kept[keep], got[keep]), f"keep_raw rows, ts={ts}")
        print(f"kernels: ts={ts} equal to the plain versions at (1, {8 * ts}), "
              f"(7, {4096 * ts}), (64, {big})")

    times = {}
    for ts in (4, 8):
        bs = MIB // (8 * ts) * (8 * ts)
        x = torch.from_numpy(rng.integers(0, 256, (64, bs), dtype=np.uint8)).cuda()
        s = kernels.shuffle_blocks(x, ts)
        nbytes = x.numel()
        row = {
            "shuffle": cuda_ms(lambda: kernels.shuffle_blocks(x, ts)),
            "shuffle_plain": cuda_ms(lambda: batched.shuffle_blocks_plain(x, ts)),
            "unshuffle": cuda_ms(lambda: kernels.unshuffle_blocks(s, ts)),
            "unshuffle_plain": cuda_ms(lambda: batched.unshuffle_blocks_plain(s, ts)),
        }
        times[ts] = row
        print(f"kernel times (64, {bs}) ts={ts}: " + ", ".join(
            f"{k} {v:.4f} ms = {nbytes / v / 1e6:.1f} GB/s" for k, v in row.items()
        ) + " (GB/s of input bytes; each byte is read once and written once)")
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
    case, on the card; returns (frame, decoded) per case."""
    results = []
    for _, x, opts in cases:
        frame = tbt.compress_array(x, opts)
        y = tbt.decompress_array(frame, x.dtype, device=DEVICE, strategy="device")
        torch.cuda.synchronize()
        results.append((frame, y))
    return results


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
    t_shuf = host_s(lambda: tbt.filters.shuffle_blocks(
        blocks, opts.type_size, out=staged[: nb_full * bs].view(nb_full, bs)))
    t_d2h = host_s(lambda: staged.cpu())
    filtered = dev._device_filter_fetch(flat, opts.type_size, nb_full, bs)
    t_codec = host_s(lambda: dev._compress_array_stage2(filtered, opts, bs))
    native = chunk.native_pipeline_codec(header.codec, 1)
    t_decode = host_s(lambda: dev._decode_filtered_blocks(frame, header, n, native[0]))
    host_stream, _ = dev._decode_filtered_blocks(frame, header, n, native[0])
    t_h2d = host_s(lambda: host_stream.to(DEVICE))
    on_dev = host_stream.to(DEVICE)
    t_unshuf = host_s(lambda: tbt.filters.unshuffle_blocks(
        on_dev[: nb_full * bs].view(nb_full, bs), opts.type_size))

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
    print(f"{name} stages (ms, medians of 5): compress = shuffle kernel "
          f"{t_shuf * 1e3:.3f} + device-to-host copy {t_d2h * 1e3:.3f} + host codec "
          f"and frame {t_codec * 1e3:.3f}; decompress = host codec "
          f"{t_decode * 1e3:.3f} + host-to-device copy {t_h2d * 1e3:.3f} + "
          f"unshuffle kernel {t_unshuf * 1e3:.3f}")
    return n_raw


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

    phase_environment()
    kern = phase_kernels(rng)
    cases = make_cases(tbt, rng)

    kernels.reset_launches()
    results = run_main_path(tbt, cases)
    launches = dict(kernels.launches)
    print(f"main path launches: {launches}")
    check(launches["shuffle_blocks"] >= len(cases), "shuffle kernel launched by compress_array")
    check(launches["unshuffle_blocks"] >= len(cases), "unshuffle kernel launched by decompress_array")

    for (name, x, opts), (frame, y) in zip(cases, results):
        n_raw = check_and_time_case(tbt, name, x, opts, frame, y)
        if name.startswith("B"):
            check(n_raw >= 1, "B: the random block took the memcpy fallback")

    t4 = kern["times"][4]
    print(json.dumps({"kernels": [
        {"name": "tpbt_shuffle_blocks", "route": "cuda",
         "source": "tpu_blosc_torch/csrc/shuffle.cu",
         "replaces": "tpu_blosc/filters/pallas_kernels.py:293",
         "launches": launches["shuffle_blocks"],
         "max_abs_err": kern["max_abs_err"],
         "ms": t4["shuffle"], "plain_ms": t4["shuffle_plain"]},
        {"name": "tpbt_unshuffle_blocks", "route": "cuda",
         "source": "tpu_blosc_torch/csrc/shuffle.cu",
         "replaces": "tpu_blosc/filters/pallas_kernels.py:315",
         "launches": launches["unshuffle_blocks"],
         "max_abs_err": kern["max_abs_err"],
         "ms": t4["unshuffle"], "plain_ms": t4["unshuffle_plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
