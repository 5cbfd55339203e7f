"""tpu_blosc_torch.buildlib: one build per source change, safe under
concurrent processes (the test workers all import the port at once)."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

from tpu_blosc_torch import buildlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a stand-in compiler: logs that it ran, takes a moment, writes the output
FAKE_CC = textwrap.dedent("""
    import sys, time
    out, log = sys.argv[1], sys.argv[2]
    with open(log, "a") as f:
        f.write("built\\n")
    time.sleep(0.3)
    with open(out, "wb") as f:
        f.write(b"library")
""")

BUILDER = textwrap.dedent("""
    import sys
    from tpu_blosc_torch import buildlib
    out, src, log, cc = sys.argv[1:5]
    print(buildlib.ensure_built(out, [src], [[sys.executable, cc, buildlib.OUT, log]]))
""")


def _paths(tmp_path):
    src = tmp_path / "lib.c"
    src.write_text("source")
    cc = tmp_path / "cc.py"
    cc.write_text(FAKE_CC)
    return str(tmp_path / "build" / "lib.so"), str(src), str(tmp_path / "log"), str(cc)


def test_concurrent_processes_build_once(tmp_path):
    out, src, log, cc = _paths(tmp_path)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", BUILDER, out, src, log, cc],
            cwd=REPO, stdout=subprocess.PIPE, text=True,
        )
        for _ in range(4)
    ]
    seconds = [float(p.communicate(timeout=120)[0]) for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert open(log).read() == "built\n"
    assert sum(s > 0 for s in seconds) == 1
    assert open(out, "rb").read() == b"library"
    assert not [f for f in os.listdir(os.path.dirname(out)) if f.endswith(".tmp")]


def test_rebuilds_only_when_a_source_is_newer(tmp_path):
    out, src, log, cc = _paths(tmp_path)
    cmd = [[sys.executable, cc, buildlib.OUT, log]]
    assert buildlib.ensure_built(out, [src], cmd) > 0
    assert buildlib.ensure_built(out, [src], cmd) == 0.0
    later = os.path.getmtime(out) + 10
    os.utime(src, (later, later))
    assert buildlib.ensure_built(out, [src], cmd) > 0
    assert open(log).read() == "built\nbuilt\n"


def test_ladder_takes_the_first_command_that_succeeds(tmp_path):
    out, src, log, cc = _paths(tmp_path)
    failing = [sys.executable, "-c", "import sys; sys.exit('no such flag')"]
    assert buildlib.ensure_built(
        out, [src], [failing, [sys.executable, cc, buildlib.OUT, log]]
    ) > 0
    assert open(out, "rb").read() == b"library"


def test_failed_build_raises_with_each_commands_stderr(tmp_path):
    out, src, _, _ = _paths(tmp_path)
    cmds = [
        [sys.executable, "-c", f"import sys; sys.exit('rung {i} failed')"]
        for i in range(2)
    ]
    with pytest.raises(RuntimeError) as info:
        buildlib.ensure_built(out, [src], cmds)
    assert "rung 0 failed" in str(info.value) and "rung 1 failed" in str(info.value)
    assert not os.path.exists(out)


# a build step that needs its partner running at the same time: it marks
# itself started, then waits for the other's mark
STEP = textwrap.dedent("""
    import os, sys, time
    mine, other = sys.argv[1], sys.argv[2]
    open(mine, "w").close()
    deadline = time.time() + 60
    while not os.path.exists(other):
        if time.time() > deadline:
            sys.exit("partner step never started")
        time.sleep(0.01)
""")


def test_together_commands_run_at_once_before_the_ladder(tmp_path):
    out, src, log, cc = _paths(tmp_path)
    step = tmp_path / "step.py"
    step.write_text(STEP)
    a, b = str(tmp_path / "a.o"), str(tmp_path / "b.o")
    together = [[sys.executable, str(step), a, b], [sys.executable, str(step), b, a]]
    assert buildlib.ensure_built(
        out, [src], [[sys.executable, cc, buildlib.OUT, log]], together=together
    ) > 0
    assert os.path.exists(a) and os.path.exists(b)
    assert open(out, "rb").read() == b"library"
    # up to date: no step runs again
    os.remove(a)
    assert buildlib.ensure_built(out, [src], [], together=together) == 0.0
    assert not os.path.exists(a)


def test_failed_together_command_raises_and_skips_the_ladder(tmp_path):
    out, src, log, cc = _paths(tmp_path)
    together = [
        [sys.executable, "-c", "pass"],
        [sys.executable, "-c", "import sys; sys.exit('compile of b.cu failed')"],
    ]
    with pytest.raises(RuntimeError, match="compile of b.cu failed"):
        buildlib.ensure_built(
            out, [src], [[sys.executable, cc, buildlib.OUT, log]], together=together
        )
    assert not os.path.exists(out) and not os.path.exists(log)
