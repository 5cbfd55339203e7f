#!/usr/bin/env python3
"""One run of one benchmark cell of tpu_blosc_torch on this machine's CUDA devices.

Run from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's ``workloads``.  The run makes its
data on the device from ``--seed``, warms up (the set-up, ``setup_s``),
then drives the cell's loop for ``--seconds`` and reports the cell's
end-to-end metrics; with ``--trace 1`` it runs a bounded number of the
same calls under torch.profiler instead and reports the cell's per-layer
metrics, from a complete trace only.  Either way it then judges the
outputs against the plain reference (``correct``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (``--trace 1``: with
``busy_s`` and ``window_s``; and ``breakdown``), and last ``checks``, each
number compared beside its limit, which also close standard error.  Lines
before it give the card, the host, the frame's ratio, call times and
sample counts, the trace's attempts and the port's kernel launches.

It exits 2, printing no result, without a CUDA device or with fewer than
the cell asks for, and 3 when jax, jaxlib, flax or tpu_blosc (top-level
names, compared whole) was loaded in the process.  Build caches stay in
the checkout: the port's own in ``tpu_blosc_torch/_build/``, and
``TORCH_EXTENSIONS_DIR`` and ``TRITON_CACHE_DIR`` under ``.bench_cache/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_blosc"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    load (compared whole: tpu_blosc_torch is not tpu_blosc)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi unavailable"


def _ms(values) -> str:
    """A call time's spread: deciles, the 95th percentile, the extremes."""
    if len(values) < 2:
        return "too few calls"
    d = statistics.quantiles(values, n=20, method="inclusive")
    return (f"n {len(values)}, ms min {min(values) * 1e3:.4f} p10 {d[1] * 1e3:.4f} "
            f"p50 {d[9] * 1e3:.4f} p90 {d[17] * 1e3:.4f} p95 {d[18] * 1e3:.4f} "
            f"max {max(values) * 1e3:.4f}")


def report(cell, args, out: dict, device_name: str) -> None:
    """The earlier lines, for people: what ran, on what, and how it went."""
    import torch

    print(f"card: {device_name}; nvidia-smi: {_card()}; host cores {os.cpu_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"cell {cell.name}: config {cell.config['name']}, traffic "
          f"{json.dumps(cell.traffic, sort_keys=True)}, seed {args.seed}")
    if out["frame_bytes"]:
        n = cell.traffic["tensor_bytes"]
        print(f"frame: {out['frame_bytes']} bytes for {n} (ratio {n / out['frame_bytes']:.4f})")
    print(f"setup_s {out['setup_s']:.4f}; memory peak {out['memory_peak_bytes']} bytes; "
          f"port kernel launches after set-up {out['launches']}")
    if out["record"]:
        rec = out["record"]
        print(f"window: {rec['round_trips']} round trips in {rec['window_s']:.4f} s; "
              f"encode {_ms(rec['ops']['encode'])}; decode {_ms(rec['ops']['decode'])}")
    for a in out["attempts"]:
        print(f"trace attempt {a['attempt']}: {a['calls']} calls that put work on the card, "
              f"{a['lost']} without their device event {a['lost_first']}; port kernels' "
              f"events of their launches {a['kernels_kept']}; complete {a['complete']}")
    if args.trace and not out["complete"]:
        print("trace incomplete after every attempt: no per-layer metric is given")
    print(f"check: {out['judged']['sampled']} sampled round trips, "
          f"{out['judged']['frames_read']} distinct frames read by the reference, "
          f"{out['judged']['bad']} wrong; {out['attempted']} attempted")
    if out["first_error"]:
        print("first error in a call:\n" + out["first_error"], file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = harness.execute(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device_info.update(busy_s=out["busy_s"], window_s=out["window_s"])
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": device_info}
    if args.trace and out["complete"] and out["breakdown"]:
        result["breakdown"] = out["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    report(cell, args, out, device_info["kind"])
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
