"""Import and device guards of the port: it never reaches JAX, its entry
points refuse to fall back to the CPU, and its kernel modules import on a
host without ``nvcc``."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import psignn_tpu_torch
from psignn_tpu_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "psignn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "psignn_tpu")
# imported only inside the function that needs it: the card's host lacks it
FUNCTION_ONLY = ("h5py", "matplotlib", "PIL")
# the only modules that may import the drawing packages (inside functions)
DRAWING = ("matplotlib", "PIL")
DRAWING_MODULES = ("eval/vis.py", "train/plots.py", "eval/curves.py",
                   "eval/figures.py")


SCRIPTS = ROOT / "scripts" / "torch"
NOTEBOOKS = sorted((ROOT / "notebooks").glob("*_torch.ipynb"))


def _port_sources():
    """The port's modules, the smoke script, the rank workers of the
    multi-rank tests (which spawned ranks import) and the port's Python
    scripts."""
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_dist.py",
        *sorted(SCRIPTS.glob("*.py"))]


def _imported_roots(path: Path):
    """Top-level names of every absolute import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _import_time_roots(path: Path):
    """Top-level names of the absolute imports that run when ``path`` is
    imported: every import outside a function body."""
    stack = [ast.parse(path.read_text(), str(path))]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        stack.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    drawing = PORT in path.parents and \
        str(path.relative_to(PORT)) in DRAWING_MODULES
    forbidden = FORBIDDEN if drawing else FORBIDDEN + DRAWING
    bad = sorted(set(_imported_roots(path)) & set(forbidden))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    late = sorted(set(_import_time_roots(path)) & set(FUNCTION_ONLY))
    assert not late, f"{path.relative_to(ROOT)} imports {late} on import"


@pytest.mark.parametrize("path", NOTEBOOKS, ids=lambda p: p.name)
def test_notebook_cells_import_no_jax(path):
    """The code cells of the port's notebooks import neither JAX nor the
    JAX package."""
    cells = ["".join(c["source"]) for c in json.loads(path.read_text())
             ["cells"] if c["cell_type"] == "code"]
    assert cells
    for i, src in enumerate(cells):
        cell = path.parent / f"{path.name}[{i}]"
        cell_roots = set()
        for node in ast.walk(ast.parse(src, str(cell))):
            if isinstance(node, ast.Import):
                cell_roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                cell_roots.add(node.module.split(".")[0])
        assert not cell_roots & set(FORBIDDEN), (cell, src)


@pytest.mark.parametrize("path", sorted(SCRIPTS.glob("*.sh")),
                         ids=lambda p: p.name)
def test_scripts_run_only_the_port(path):
    """A shell script of the port runs the port's modules and its own
    scripts: no ``psignn_tpu.`` module, nothing of ``tools/``, no
    ``bench.py``."""
    code = "\n".join(ln for ln in path.read_text().splitlines()
                     if not ln.lstrip().startswith("#"))
    assert "psignn_tpu_torch." in code or "scripts/torch/" in code
    for bad in ("psignn_tpu.", "tools/", "bench.py"):
        assert bad not in code, (path.name, bad)


def test_package_import_leaves_jax_out():
    """Importing every module of the package (and the smoke script, and
    the rank workers of the multi-rank tests) loads no JAX or optax
    module, nor h5py, matplotlib or Pillow."""
    script = (
        "import importlib, json, pkgutil, sys\n"
        "import psignn_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'tests')\n"
        "import _torch_dist\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in"
        f" {list(FORBIDDEN + FUNCTION_ONLY)!r})))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_scan_covers_every_module():
    """The import checks above read every module of the training slice,
    of the mixed slice, of the DSS and DS-GPS slice, of the multi-device
    slice (and the rank workers), of the Newton slice and of the parity,
    nstep-study and curves slice, of the figures slice and the bench, and
    the three kernel sources exist beside the kernel module.  ``h5py`` is imported
    inside ``meshgen.mesh_from_dolfin_h5`` and nowhere at import time;
    matplotlib and Pillow inside ``vis``'s drawing functions."""
    scanned = {str(p.relative_to(PORT)) for p in _port_sources()
               if PORT in p.parents}
    assert {"deq.py", "cli/main.py", "data/generate.py", "data/reader.py",
            "train/optim.py", "train/step.py", "train/checkpoint.py",
            "train/trainer.py", "kernels/fused_mp.py", "solvers.py",
            "graphs.py", "weights.py", "models/psignn.py", "data/fem.py",
            "data/meshgen.py", "eval/metrics.py", "eval/sweep.py",
            "eval/run_eval.py", "models/dss.py", "models/dsgps.py",
            "dist/__init__.py", "dist/multihost.py", "dist/dp.py",
            "dist/partition.py", "dist/partitioned.py",
            "dist/dryrun.py", "compat.py", "profiling.py",
            "entry.py", "eval/parity.py", "eval/nstep_study.py",
            "eval/curves.py", "eval/registry.py", "eval/vis.py",
            "train/plots.py", "eval/figures.py", "bench.py"} <= scanned
    assert ROOT / "tests" / "_torch_dist.py" in _port_sources()
    assert SCRIPTS / "make_warmae_ckpt.py" in _port_sources()
    assert [p.name for p in NOTEBOOKS] == [
        "comparatives_torch.ipynb", "demo_torch.ipynb",
        "partitioned_torch.ipynb"]
    meshgen = PORT / "data" / "meshgen.py"
    assert "h5py" in set(_imported_roots(meshgen))
    assert "h5py" not in set(_import_time_roots(meshgen))
    vis = PORT / "eval" / "vis.py"
    assert {"matplotlib", "PIL"} <= set(_imported_roots(vis))
    assert not {"matplotlib", "PIL"} & set(_import_time_roots(vis))
    for name in ("fused_mp_fwd", "fused_mp_bwd", "fused_mp_jvp"):
        assert (build.SRC_DIR / f"{name}.cu").is_file()


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_default_device_raises_without_cuda(monkeypatch):
    from psignn_tpu_torch.graphs import batch_graphs
    from _torch_parity import fem_sample
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        psignn_tpu_torch.default_device()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        psignn_tpu_torch.resolve_device(None)
    assert psignn_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    # an entry point given no device does not fall back to the CPU
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        batch_graphs([fem_sample(0, hsize=0.25)])


def test_kernel_module_imports_without_nvcc(tmp_path):
    """With no ``nvcc`` anywhere on PATH the kernel modules import and the
    CPU path runs; nothing is built until a CUDA tensor reaches the
    wrapper."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    script = (
        "import torch\n"
        "from psignn_tpu_torch.kernels import build, fused_mp\n"
        "from psignn_tpu_torch.nn import MLP\n"
        "mlp = MLP([7, 3, 3], generator=torch.Generator().manual_seed(0))\n"
        "csr = fused_mp.pack_csr([0, 1, 1], [1, 0, 1], [[1.], [2.], [3.]],\n"
        "                        2, 'to')\n"
        "(l1, l2) = mlp.layers\n"
        "h = torch.ones(2, 3, requires_grad=True)\n"
        "out = fused_mp.fused_message_passing(l1.weight, l1.bias, l2.weight,\n"
        "                                     l2.bias, h, csr)\n"
        "out.sum().backward()\n"
        "vjp = fused_mp.fused_mp_vjp(l1.weight, l1.bias, l2.weight, l2.bias,\n"
        "                            h, csr, torch.ones(2, 3))\n"
        "assert out.shape == (2, 3) and h.grad.shape == (2, 3)\n"
        "jvp = fused_mp.fused_mp_jvp(l1.weight, l1.bias, l2.weight, l2.bias,\n"
        "                            h, csr, torch.ones(2, 3))\n"
        "assert len(vjp) == 5 and jvp.shape == (2, 3)\n"
        "assert fused_mp.LAUNCHES == 0 and fused_mp.BWD_LAUNCHES == 0\n"
        "assert fused_mp.JVP_LAUNCHES == 0\n"
        "assert not build._LIBS\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_library_path_follows_source(monkeypatch, tmp_path):
    """The build is keyed by a hash of the source and flags, so an edited
    source gets a new library name and an unchanged one reuses the old."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// one\n")
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    first = build.library_path("k")
    assert build.library_path("k") == first
    (src / "k.cu").write_text("// two\n")
    assert build.library_path("k") != first
    assert first.parent == tmp_path / "build"
    assert not first.parent.exists()     # computing the name builds nothing


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """The smoke exits non-zero and prints no result without a card, and in
    a directory that holds the script and nothing else of the repo."""
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", lone / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (ROOT, lone):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0, (cwd, proc.stdout)
        assert proc.stdout == "", (cwd, proc.stdout)
