"""Build a shared library from sources in the checkout, once per change.

The port builds two libraries at first use: the native host codec (g++,
native/backend.py) and the CUDA kernels (nvcc, filters/kernels.py).
Both land in ``tpu_blosc_torch/_build/``, which git ignores.  Several
processes may import the port at once (test workers), so a build holds an
exclusive ``fcntl`` lock next to its output and writes to a temporary name
that ``os.replace`` moves into place: a reader never sees half a library.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import time

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

# placeholder in a build command for the (temporary) output path
OUT = "{out}"


def _fresh(out: str, sources: list[str]) -> bool:
    if not os.path.exists(out):
        return False
    built = os.path.getmtime(out)
    return all(os.path.getmtime(s) <= built for s in sources)


def _run_together(commands: list[list[str]]) -> None:
    """Start every command at once and wait for all; raise RuntimeError
    with the stderr of each that failed."""
    procs = [
        subprocess.Popen(argv, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                         text=True)
        for argv in commands
    ]
    failures = []
    for argv, proc in zip(commands, procs):
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            failures.append(" ".join(argv) + "\n" + err[-4000:])
    if failures:
        raise RuntimeError("build step failed:\n" + "\n".join(failures))


def ensure_built(out: str, sources: list[str], commands: list[list[str]],
                 together: list[list[str]] = ()) -> float:
    """Build ``out`` unless it is newer than every file in ``sources``.

    The ``together`` commands (one compile per source, say) run first,
    all at once; then ``commands`` are tried in order (a flag ladder), and
    the first to exit 0 wins.  Returns the seconds spent building, 0.0
    when ``out`` was already up to date.  Raises RuntimeError with the
    stderr of each failed command.
    """
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh(out, sources):
            return 0.0
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        failures = []
        try:
            _run_together(together)
            for cmd in commands:
                argv = [tmp if a == OUT else a for a in cmd]
                proc = subprocess.run(
                    argv, capture_output=True, text=True, timeout=900
                )
                if proc.returncode == 0:
                    os.replace(tmp, out)
                    return time.perf_counter() - t0
                failures.append(" ".join(argv) + "\n" + proc.stderr[-4000:])
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        raise RuntimeError(
            f"building {os.path.basename(out)} failed:\n" + "\n".join(failures)
        )
