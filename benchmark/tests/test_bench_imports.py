"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level names compared whole,
since tpu_blosc_torch begins with tpu_blosc."""

import ast
import os

import pytest

from benchmark import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_blosc"}


def _modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_or_jax_package(path):
    assert not _imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for p in _modules()
                                        if os.sep + "reference" + os.sep in p),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert "tpu_blosc_torch" not in _imported(path)
    assert "benchmark" not in _imported(path)


def test_the_scan_sees_each_form_of_import(tmp_path):
    path = tmp_path / "m.py"
    path.write_text("import jax.numpy\nfrom tpu_blosc import api\nimport tpu_blosc_torch\n"
                    "from . import sibling\n__import__('flax')\n")
    assert _imported(str(path)) == {"jax", "tpu_blosc", "tpu_blosc_torch", "flax"}


def test_loaded_modules_compared_whole(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "tpu_blosc_torch_fake", sys)
    assert not [m for m in run.forbidden_modules() if m.startswith("tpu_blosc_torch")]
    monkeypatch.setitem(sys.modules, "tpu_blosc.api", sys)
    assert "tpu_blosc.api" in run.forbidden_modules()
