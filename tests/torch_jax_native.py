"""The JAX package's native library and fastcall module, loaded whole in
this test process, for the port's tests that compare against it.

tpu_blosc builds ``libtpublosc.so`` and ``_tpbfast.so`` in place, with no
lock, when it is first imported, and drops either one silently when it
fails to load.  In a fresh checkout every test worker imports it at once
and builds both: a worker may load the library while another one is
rewriting it, or link the fastcall module against a half-written library
(gcc's ``--as-needed`` then drops the dependency, and the module fails to
import on an undefined symbol).  That worker's tpu_blosc then runs its
pure-Python codecs, whose LZ4 streams differ from the native ones, or its
ctypes route, which cannot batch bfloat16 arrays, for the rest of its
life.  By the time a test runs every build has finished: tpu_blosc builds
when it is imported, every worker imports it while it collects, and
pytest-xdist hands out no test before every worker has reported its
collection.  So ``jax_native_whole`` (a module fixture; import it into a
test module to use it) loads again what failed to load: the library, then
the fastcall module, relinked from tpu_blosc's own source into a temporary
name moved into place where the file on disk is the broken one.  It fails
the module's tests, with its reason, where either still does not load.
The dispatch that tpu_blosc memoized meanwhile is dropped.  This reaches
into tpu_blosc's private state (``backend._tried``, ``_LIB_OVERRIDE``, ``_load``,
``_load_fastmod``, ``_fast``, ``chunk._resolve_cache``,
``api._FAST_LANE``, ``filters._probe``) and writes the build product
``tpu_blosc/native/_tpbfast.so``, since no file of tpu_blosc may change;
``tests/test_torch_standalone.py`` fails for a module of the port's tests
that compares with tpu_blosc and does not import the fixture.
"""

from __future__ import annotations

import os
import subprocess
import sysconfig

import pytest

from tpu_blosc import api as japi
from tpu_blosc import chunk as jchunk
from tpu_blosc import filters as jfilters
from tpu_blosc.native import backend as jnb


def _relink_fastmod() -> None:
    out = os.path.join(jnb._HERE, "_tpbfast.so")
    tmp = os.path.join(jnb._HERE, f"_tpbfast.{os.getpid()}.tmp.so")
    subprocess.run(
        ["gcc", "-O2", "-shared", "-fPIC", "-I", sysconfig.get_paths()["include"],
         os.path.join(jnb._HERE, "fastmod.c"), "-o", tmp,
         "-L", jnb._HERE, "-ltpublosc", "-Wl,-rpath,$ORIGIN"],
        check=True, capture_output=True, timeout=120,
    )
    os.replace(tmp, out)


def load_jax_native() -> None:
    """Load tpu_blosc's library and fastcall module where its first load
    failed; environment knobs that turn either off are respected."""
    if os.environ.get("TPU_BLOSC_NO_NATIVE"):
        return
    repaired = False
    if not jnb.available() and not jnb._LIB_OVERRIDE:
        jnb._tried = False
        jnb._load()
        repaired = True
    assert jnb.available(), "tpu_blosc's native library does not load"
    if jnb._fast is None and not jnb._LIB_OVERRIDE and not os.environ.get("TPU_BLOSC_NO_FAST"):
        jnb._load_fastmod()
        if jnb._fast is None:
            _relink_fastmod()
            jnb._load_fastmod()
        assert jnb._fast is not None, "tpu_blosc's fastcall module does not load"
        repaired = True
    if repaired:
        jfilters._probe()
        jchunk._resolve_cache.clear()
        japi._FAST_LANE.clear()


@pytest.fixture(scope="module", autouse=True)
def jax_native_whole():
    load_jax_native()
