"""The port's CLI against tpu_blosc's, on the CPU.

≙ tests/test_cli.py.  Each subcommand runs through
``tpu_blosc_torch.__main__.main`` and through ``tpu_blosc.__main__.main``
on copies of the same files, in two directories: the files each writes
are byte-identical, the lines each prints are the same but for the
directory and the timing numbers, and the exit codes are equal, errors
included.  ``python -m tpu_blosc_torch`` runs in a subprocess without
importing jax.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb
import tpu_blosc_torch as tb
from tpu_blosc import api as japi
from tpu_blosc.__main__ import main as jmain
from tpu_blosc_torch import api as tapi
from tpu_blosc_torch.__main__ import main as tmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the timing of compress and decompress: "12.3 ms (4.56 GB/s)"
TIMING = re.compile(r"[0-9.]+ ms \([0-9.]+ GB/s\)")


def _inputs(root) -> None:
    """The files every case reads, written into ``root``."""
    root.mkdir()
    (root / "ramp.bin").write_bytes(np.arange(50_000, dtype=np.float32).tobytes())
    walk = np.cumsum(np.random.default_rng(1).integers(-3, 4, (5 << 20) // 8)).astype(np.float64)
    (root / "walk.bin").write_bytes(walk.tobytes())
    (root / "noise.bin").write_bytes(np.random.default_rng(2).integers(0, 256, 70_000,
                                                                       np.uint8).tobytes())
    (root / "odd.bin").write_bytes(bytes(range(251)) * 41)
    np.save(root / "m.npy", np.arange(6000, dtype=np.float32).reshape(60, 100))
    np.save(root / "f.npy", np.asfortranarray(np.arange(3000, dtype=np.int16).reshape(30, 100)))
    np.save(root / "b.npy", np.arange(1000) % 3 == 0)
    np.save(root / "e.npy", np.zeros((0, 4), np.float64))
    (root / "junk.bl2").write_bytes(b"\x02\x01\x00\x04" + b"\xff" * 40)


@pytest.fixture
def dirs(tmp_path):
    """(the port's directory, tpu_blosc's), holding the same files."""
    mine, theirs = tmp_path / "t", tmp_path / "j"
    _inputs(mine)
    shutil.copytree(mine, theirs)
    return mine, theirs


def _run(main, root, argv, capsys) -> tuple[int, str, str]:
    """``main`` on ``argv`` with its file names taken in ``root``; the exit
    code and the output with the directory and the timings taken out."""
    argv = [str(root / a[1:]) if a.startswith("@") else a for a in argv]
    capsys.readouterr()
    rc = main(argv)
    out, err = capsys.readouterr()
    norm = [TIMING.sub("<t>", s.replace(str(root), "<dir>")) for s in (out, err)]
    return rc, norm[0], norm[1]


def _both(dirs, argv, capsys) -> tuple[int, str, str]:
    """Run both CLIs; their exit codes and outputs must be equal, and so
    must every file in the two directories."""
    mine, theirs = dirs
    got = _run(tmain, mine, argv, capsys)
    want = _run(jmain, theirs, argv, capsys)
    assert got == want
    names = sorted(os.listdir(mine))
    assert names == sorted(os.listdir(theirs))
    for name in names:
        assert (mine / name).read_bytes() == (theirs / name).read_bytes(), name
    return got


CODECS = ["blosclz", "lz4", "lz4hc", "snappy", "zlib", "zstd"]


@pytest.mark.parametrize("shuffle", ["none", "byte", "bit"])
@pytest.mark.parametrize("codec", CODECS)
def test_compress_and_decompress_write_the_same_files(dirs, capsys, codec, shuffle):
    rc, out, err = _both(dirs, ["compress", "@ramp.bin", "@walk.bin", "--codec", codec,
                                "--shuffle", shuffle, "--level", "7"], capsys)
    assert rc == 0 and "2 file(s)" in out and "ratio" in out
    rc, out, _ = _both(dirs, ["decompress", "@ramp.bin.bl2", "@walk.bin.bl2"], capsys)
    assert rc == 0
    mine = dirs[0]
    assert (mine / "walk.bin.bl2.out").read_bytes() == (mine / "walk.bin").read_bytes()
    frame = (mine / "walk.bin.bl2").read_bytes()
    assert tb.get_info(frame).is_split


@pytest.mark.parametrize("argv", [
    ["compress", "@ramp.bin", "-o", "@r.bl2"],
    ["compress", "@ramp.bin", "-o", "@r.bl2", "--codec", "zstd", "--level", "7", "--shuffle",
     "bit", "--typesize", "4", "--block", "16384"],
    ["compress", "@odd.bin", "--typesize", "3", "--block", "4096", "--level", "12"],
    ["compress", "@noise.bin", "--shuffle", "none", "--typesize", "1"],
    ["compress", "@ramp.bin", "@walk.bin", "@noise.bin", "--auto", "--level", "9"],
    ["compress", "@walk.bin", "--auto", "--block", "65536", "--typesize", "8"],
    ["compress", "@ramp.bin", "--shuffle", "bit"],  # the bit-shuffle hint
    ["compress", "@noise.bin", "--shuffle", "bit", "--typesize", "1"],
])
def test_compress_options_write_the_same_frame(dirs, capsys, argv):
    rc, out, err = _both(dirs, argv, capsys)
    assert rc == 0 and "file(s)" in out
    if argv[-2:] == ["--shuffle", "bit"]:
        assert err.startswith("hint: the probe prefers byte shuffle")


def test_the_compress_file_equals_compress_batch_with_options(dirs, capsys):
    mine = dirs[0]
    _both(dirs, ["compress", "@ramp.bin", "@odd.bin", "--codec", "lz4hc", "--level", "4"],
          capsys)
    datas = [(mine / n).read_bytes() for n in ("ramp.bin", "odd.bin")]
    frames = tb.compress_batch_with_options(
        datas, tb.Options(codec=tb.LZ4HC, level=4, type_size=4))
    assert [(mine / n).read_bytes() for n in ("ramp.bin.bl2", "odd.bin.bl2")] == frames


@pytest.mark.parametrize("argv", [
    ["compress", "@ramp.bin", "@walk.bin", "-o", "@x.bl2"],
    ["decompress", "@ramp.bin", "@walk.bin", "-o", "@x"],
])
def test_output_with_several_inputs_is_refused_with_2(dirs, capsys, argv):
    rc, _, err = _both(dirs, argv, capsys)
    assert rc == 2 and "requires a single input file" in err


@pytest.mark.parametrize("argv", [
    ["decompress", "@junk.bl2"],
    ["decompress", "@missing.bl2"],
    ["info", "@missing.bl2"],
    ["suggest", "@missing.bin"],
    ["unpack", "@junk.bl2"],
    ["verify", "@ramp.bin"],
    ["verify", "@missing.tpbs"],
])
def test_errors_give_the_same_exit_code_and_message(dirs, capsys, argv):
    rc, out, err = _both(dirs, argv, capsys)
    assert rc == 1 and err.startswith("error: ")


@pytest.mark.parametrize("kind", ["single", "split", "memcpy", "container", "envelope",
                                  "empty envelope"])
def test_info_prints_the_same_lines(dirs, capsys, monkeypatch, kind):
    mine, theirs = dirs
    name = {"single": "ramp.bin", "split": "walk.bin", "memcpy": "noise.bin",
            "container": "walk.bin", "envelope": "m.npy", "empty envelope": "e.npy"}[kind]
    if kind == "container":  # multi-block inputs past this limit take the container
        monkeypatch.setattr(tapi, "FRAME_SAFE_LIMIT", 1 << 20)
        monkeypatch.setattr(japi, "FRAME_SAFE_LIMIT", 1 << 20)
    if name.endswith(".npy"):
        _both(dirs, ["pack", f"@{name}", "-o", "@x"], capsys)
    else:
        _both(dirs, ["compress", f"@{name}", "-o", "@x", "--typesize",
                     "1" if kind == "memcpy" else "4"], capsys)
    rc, out, _ = _both(dirs, ["info", "@x"], capsys)
    assert rc == 0 and "uncompressed" in out or "empty array" in out
    if kind == "envelope":
        assert "dtype: float32" in out and "shape: (60, 100)" in out
    if kind == "container":
        assert "kind: ContainerInfo" in out


@pytest.mark.parametrize("name,ts", [("ramp.bin", 4), ("walk.bin", 8), ("noise.bin", 1),
                                     ("odd.bin", 2)])
def test_suggest_prints_the_same_advice(dirs, capsys, name, ts):
    rc, out, _ = _both(dirs, ["suggest", f"@{name}", "--typesize", str(ts)], capsys)
    assert rc == 0 and "--codec" in out


@pytest.mark.parametrize("args", [[], ["--codec", "zstd", "--level", "3", "--shuffle", "bit"],
                                  ["--shuffle", "none"]])
@pytest.mark.parametrize("name", ["m.npy", "f.npy", "b.npy", "e.npy"])
def test_pack_and_unpack_write_the_same_files(dirs, capsys, name, args):
    rc, out, _ = _both(dirs, ["pack", f"@{name}", *args], capsys)
    assert rc == 0 and "dtype" in out
    rc, out, _ = _both(dirs, ["unpack", f"@{name}.tpba"], capsys)
    assert rc == 0
    arr = np.load(dirs[0] / f"{name}.tpba.npy")
    want = np.load(dirs[0] / name)
    assert arr.dtype == want.dtype and np.array_equal(arr, want)


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("checksum", [False, True])
def test_verify_prints_the_same_lines(dirs, capsys, checksum, deep):
    for root in dirs:
        with tb.StreamWriter(str(root / "s.tpbs"), checksum=checksum) as w:
            w.write(np.arange(10_000, dtype=np.float32).tobytes())
            w.write(b"abc" * 1000)
    rc, out, _ = _both(dirs, ["verify", "@s.tpbs", *(["--deep"] if deep else [])], capsys)
    assert rc == 0 and "2 records ok" in out


def test_each_package_reads_the_others_files(dirs, capsys):
    mine, theirs = dirs
    jmain(["compress", str(theirs / "walk.bin"), "-o", str(theirs / "w.bl2")])
    tmain(["decompress", str(theirs / "w.bl2"), "-o", str(theirs / "w.out")])
    assert (theirs / "w.out").read_bytes() == (theirs / "walk.bin").read_bytes()
    tmain(["pack", str(mine / "f.npy"), "-o", str(mine / "f.tpba")])
    jmain(["unpack", str(mine / "f.tpba"), "-o", str(mine / "f2.npy")])
    assert np.array_equal(np.load(mine / "f2.npy"), np.load(mine / "f.npy"))
    assert jb.unpack_array((mine / "f.tpba").read_bytes()).flags.f_contiguous


def test_python_m_runs_without_jax(dirs):
    mine = dirs[0]
    frame = mine / "r.bl2"
    frame.write_bytes(tb.compress((mine / "ramp.bin").read_bytes()))
    out = subprocess.run([sys.executable, "-m", "tpu_blosc_torch", "info", str(frame)],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "uncompressed: 200,000 bytes" in out.stdout
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['tpu_blosc_torch', 'info', {str(frame)!r}]\n"
        "try:\n"
        "    runpy.run_module('tpu_blosc_torch', run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tpu_blosc.'))"
        " or m == 'tpu_blosc')\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
    usage = subprocess.run([sys.executable, "-m", "tpu_blosc_torch"], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
    assert usage.returncode == 2 and "python -m tpu_blosc_torch" in usage.stderr
