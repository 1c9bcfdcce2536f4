"""Nothing the harness or the reference imports is JAX or the JAX
package, compared by whole top-level name (``psignn_tpu_torch`` starts
with ``psignn_tpu`` and is the program)."""

import ast
import os
import subprocess
import sys

from benchmark.benchlib.report import FORBIDDEN, forbidden_modules

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax():
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in _sources():
        if os.sep + "reference" + os.sep not in path:
            continue
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert set(tops) <= {"__future__", "importlib", "pickle",
                                 "typing", "numpy", "scipy", "torch"}, \
                (path, tops)


def test_whole_top_level_names():
    assert forbidden_modules(["psignn_tpu_torch", "psignn_tpu_torch.ops",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["psignn_tpu.ops", "jax.numpy", "jaxlib",
                              "flax.linen"]) == sorted(FORBIDDEN)


def test_a_run_loads_no_jax():
    """A whole small run in a fresh process, then ``sys.modules``."""
    code = (
        "import sys, os; sys.path.insert(0, os.path.join(%r, 'tests'));"
        "sys.path.insert(0, os.path.dirname(%r));"
        "from _small import run_small;"
        "from benchmark.benchlib.report import forbidden_modules;"
        "run_small('psignn_dirichlet.sweep', seconds=0.2);"
        "run_small('dsgps_dirichlet.sweep', seconds=0.2);"
        "import benchmark.reference.psignn, benchmark.reference.dsgps;"
        "print('LOADED', forbidden_modules())" % (BENCH, BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"
