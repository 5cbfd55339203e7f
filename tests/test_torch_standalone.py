"""tpu_blosc_torch stands alone: its own host codec sources, built in a copy.

A copy of ``tpu_blosc_torch/`` alone, in a directory where no copy of
``tpu_blosc`` can be imported, builds its native codec and fastcall module
from the sources inside the copy and writes tpu_blosc's frame.  The
port's copies of the JAX package's host sources stay byte-identical to
theirs: a change to one copy on purpose changes this test and says why.
Every test module of the port that compares with tpu_blosc in its own
process loads tpu_blosc's native code whole first (``torch_jax_native``).
Tolerance: equal bytes.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
from torch_jax_native import jax_native_whole  # noqa: F401  (an autouse fixture)

import tpu_blosc as jb

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r'''
import importlib.util, os, sys
import numpy as np
assert importlib.util.find_spec("tpu_blosc") is None, "a copy of tpu_blosc is importable"
import tpu_blosc_torch as tb
from tpu_blosc_torch.native import backend
here = os.path.realpath(os.getcwd())
for path in (backend.SOURCE, backend.FAST_SOURCE, backend.LIB_PATH, backend.FAST_PATH):
    assert os.path.realpath(path).startswith(here + os.sep), path
data = np.arange(1 << 20, dtype=np.float32).tobytes()
frames = [tb.compress(data, tb.LZ4, 5, tb.SHUFFLE, 4),
          tb.compress_with_options(data, tb.Options(codec=tb.Codec.ZSTD, block_size=1 << 18))]
assert all(tb.decompress(f) == data for f in frames)
assert backend.build_seconds > 0, "the copy did not build its library"
print(backend.fastcall_status())
for f in frames:
    print(f.hex())
'''


def test_a_copy_of_the_port_alone_builds_and_writes_tpu_blosc_frames(tmp_path):
    shutil.copytree(os.path.join(_ROOT, "tpu_blosc_torch"), tmp_path / "tpu_blosc_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=tmp_path, env=env, check=True,
                         timeout=300, capture_output=True, text=True).stdout.splitlines()
    assert out[0] == "fastcall: loaded"
    data = np.arange(1 << 20, dtype=np.float32).tobytes()
    assert bytes.fromhex(out[1]) == jb.compress(data, jb.LZ4, 5, jb.SHUFFLE, 4)
    assert bytes.fromhex(out[2]) == jb.compress_with_options(
        data, jb.Options(codec=jb.Codec.ZSTD, block_size=1 << 18))
    assert (tmp_path / "tpu_blosc_torch" / "_build" / "libtpublosc.so").exists()


@pytest.mark.parametrize("name", ["tpublosc.cpp", "fastmod.c"])
def test_host_sources_equal_the_jax_packages(name):
    mine = os.path.join(_ROOT, "tpu_blosc_torch", "native", name)
    theirs = os.path.join(_ROOT, "tpu_blosc", "native", name)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read(), f"{name} drifted from tpu_blosc's copy"


# a line that imports tpu_blosc, directly or through the registry helper
_COMPARES = re.compile(r"^\s*(import tpu_blosc\b|from tpu_blosc(\.\w+)* import|from torch_registry )",
                       re.M)
_FIXTURE = "from torch_jax_native import jax_native_whole"


@pytest.mark.parametrize("module", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(_ROOT, "tests", "test_torch_*.py"))))
def test_modules_that_compare_with_tpu_blosc_load_it_whole(module):
    with open(os.path.join(_ROOT, "tests", module)) as f:
        text = f.read()
    if _COMPARES.search(text):
        assert _FIXTURE in text, (
            f"{module} compares with tpu_blosc without the jax_native_whole fixture")
