"""Build a shared library from sources in the checkout, once per change.

The port builds two libraries at first use: the native host codec (g++,
native/backend.py) and the CUDA shuffle kernels (nvcc, filters/kernels.py).
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


def ensure_built(out: str, sources: list[str], commands: list[list[str]]) -> float:
    """Build ``out`` unless it is newer than every file in ``sources``.

    ``commands`` are tried in order (a flag ladder); the first to exit 0
    wins.  Returns the seconds spent building, 0.0 when ``out`` was
    already up to date.  Raises RuntimeError with each command's stderr
    when none succeeds.
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
