"""The import guard: nothing the benchmark runs loads JAX or the JAX
package (top-level names compared whole, as ``repro_torch`` begins with
``repro``), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import BENCH, DATA, ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for d, _, files in os.walk(BENCH):
        if os.sep + "tests" in d[len(BENCH):]:
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {(p, m) for p in _sources() for m in _imports(p) if m.split(".")[0] in BANNED}
    assert not found, found


@pytest.mark.parametrize("path", ["reference.py", "configs", "tests/data/configs"])
def test_the_reference_imports_nothing_of_the_program(path):
    """Neither ``reference.py`` nor a configuration's module (which holds
    its reference and counts) imports the program or the harness."""
    full = os.path.join(BENCH, path)
    files = ([full] if full.endswith(".py") else
             [os.path.join(full, f) for f in sorted(os.listdir(full)) if f.endswith(".py")])
    assert files
    for f in files:
        mods = set(_imports(f))
        assert mods and not {m for m in mods if m.split(".")[0] in BANNED | {"repro_torch"}}, f
        assert not {m for m in mods if m.split(".")[0] in {"harness", "inputs", "devtrace"}}, f


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness, run\n"
        "out = harness.run_cell('tiny-dense.cold', 5, 0.5, False, device='cpu', base=%r)\n"
        "assert out['correct'], out['checks']\n"
        "print('BANNED', run.loaded_banned())\n" % (os.path.join(ROOT, "src"), BENCH, DATA))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "BANNED []" in r.stdout, r.stdout[-500:]
