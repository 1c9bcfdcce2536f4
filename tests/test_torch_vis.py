"""The port's figures (``eval/vis.py``, ``train/plots.py``) against the
JAX package's ``psignn_tpu/eval/vis.py`` and ``psignn_tpu/train/plots.py``:
each drawing function, fed the same seeded numpy inputs in both packages,
writes an image whose decoded pixels equal JAX's (tolerance 0; every frame
of a GIF).  Without matplotlib or Pillow every port module still imports
and a drawing call raises an ``ImportError`` naming the missing package."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from matplotlib.image import imread
from PIL import Image, ImageSequence

from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu.eval import vis as jax_vis
from psignn_tpu.train import plots as jax_plots
from psignn_tpu_torch.data.fem import solve_poisson, solve_poisson_mixed
from psignn_tpu_torch.data.meshgen import blob_mesh, mixed_blob_mesh
from psignn_tpu_torch.eval import vis
from psignn_tpu_torch.train import plots

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGS = {name: os.path.join(ROOT, "results", run, "logs", "train_metrics.csv")
        for name, run in (("psignn", "psignn_dirichlet"),
                          ("dss", "dss_dirichlet"))}
LOSS_KEYS = ("loss", "residual_loss", "jacobian_loss", "encoder_loss",
             "autoencoder_loss", "mse_loss")


@pytest.fixture(scope="module")
def inp(tmp_path_factory):
    """Seeded inputs: a Dirichlet and a mixed radius-1 mesh (about 60
    nodes), fields and traces on the first, the logs and CSVs the readers
    take, and a few frames for the GIF."""
    rng = np.random.default_rng(0)
    mesh = blob_mesh(radius=1.0, hsize=0.25, rng=rng)
    s = solve_poisson(mesh, 1.0, rng)
    mixed = solve_poisson_mixed(
        mixed_blob_mesh(radius=1.0, hsize=0.25, rng=rng), 1.0, rng)
    pos, sol = s["coordinates"], s["sol"].reshape(-1, 1)
    n = len(pos)
    u_trace = (sol[None] * np.linspace(0.2, 1.0, 6)[:, None, None]
               + 0.05 * rng.normal(size=(6, n, 1))).astype(np.float32)
    res = np.geomspace(1.0, 1e-4, 6) * (1 + 0.1 * rng.random(6))
    tmp = tmp_path_factory.mktemp("inputs")
    srad = tmp / "spectral_radius.csv"
    srad.write_text("Spectral Radius\n" + "\n".join(
        f"{v}" for v in 0.9 + 0.2 * rng.random(8)) + "\nnot a number\n")
    csv_dir = tmp / "csv"
    csv_dir.mkdir()
    radii = (0.6, 1.0, 2.0)
    for fam in ("psignn", "dsgps", "dss"):
        rows = [",".join(["metric", *map(str, radii)])]
        for metric in ("mse", "rel", "nstep", "time"):
            rows.append(",".join([metric, *(f"{v:.6g}" for v in
                                            rng.random(3) + 0.01)]))
        (csv_dir / f"{fam}_results.csv").write_text("\n".join(rows) + "\n")
    frames = tmp / "frames"
    frame_paths = jax_vis.plot_iteration_frames(pos, u_trace[:3],
                                                str(frames))
    return dict(
        pos=pos, sol=sol, u=u_trace[-1], tags=s["tags"],
        triangles=mesh.triangles, mixed_pos=mixed["coordinates"],
        mixed_tags=mixed["tags"], u_trace=u_trace, res=res,
        mse=res * 0.3, srad=str(srad), csv_dir=str(csv_dir),
        frames=frame_paths,
        metrics={"res": res, "mse": res * 0.3, "bound_mse": res * 0.01,
                 "inter_mse": res * 0.2},
        summary={fam: {r: {"mse": float(v)} for r, v in
                       zip(radii, rng.random(3) + 0.01)}
                 for fam in ("psignn", "dss")},
        rows=[{"n_nodes": int(a), "nstep": int(b)} for a, b in
              zip(rng.integers(100, 10000, 8), rng.integers(20, 500, 8))],
        zoo={name: {"pos": pos, "sol": sol * k} for k, name in
             enumerate(("heart", "star", "ring"), 1)},
        hist={k: list(np.geomspace(1, 1e-2, 4) * (i + 1))
              for i, k in enumerate(LOSS_KEYS)},
        grads={f"function/layers/0/phi_to/{i}/{w}": float(i + 1 + (w == "w"))
               for i in range(2) for w in ("b", "w")})


# name → draw(module of vis, module of plots, inputs, out directory): the
# image files it wrote, in order
CASES = {
    "plot_solution_map": lambda v, p, i, d: [v.plot_solution_map(
        i["pos"], i["u"], f"{d}/a.png", title="u")],
    "plot_error_map": lambda v, p, i, d: [v.plot_error_map(
        i["pos"], i["u"], i["sol"], f"{d}/a.png", triangles=i["triangles"])],
    "plot_node_types": lambda v, p, i, d: [v.plot_node_types(
        i["mixed_pos"], i["mixed_tags"], f"{d}/a.png")],
    "plot_convergence": lambda v, p, i, d: [v.plot_convergence(
        i["res"], f"{d}/a.png", mse_trace=i["mse"])],
    "plot_iteration_frames": lambda v, p, i, d: v.plot_iteration_frames(
        i["pos"], i["u_trace"], f"{d}/frames", sol=i["sol"], every=2),
    "assemble_gif": lambda v, p, i, d: [v.assemble_gif(
        i["frames"], f"{d}/a.gif")],
    "iteration_gif": lambda v, p, i, d: [v.iteration_gif(
        i["pos"], i["u_trace"][:3], f"{d}/a.gif", sol=i["sol"])],
    "plot_spectral_radius": lambda v, p, i, d: [v.plot_spectral_radius(
        i["srad"], f"{d}/a.png")],
    "plot_radius_sweep": lambda v, p, i, d: [v.plot_radius_sweep(
        i["summary"], f"{d}/a.png")],
    "plot_radius_comparison": lambda v, p, i, d: [v.plot_radius_comparison(
        i["csv_dir"], f"{d}/a.png")],
    "plot_sample_panel": lambda v, p, i, d: [v.plot_sample_panel(
        i["mixed_pos"], i["mixed_pos"][:, :1], i["mixed_pos"][:, 1:],
        i["mixed_tags"], f"{d}/a.png", title="panel")],
    "plot_iteration_metrics": lambda v, p, i, d: [v.plot_iteration_metrics(
        i["metrics"], f"{d}/a.png", nstep=5)],
    "plot_nstep_vs_nodes": lambda v, p, i, d: [v.plot_nstep_vs_nodes(
        i["rows"], f"{d}/a.png")],
    "plot_zoo_grid": lambda v, p, i, d: [v.plot_zoo_grid(
        i["zoo"], f"{d}/a.png")],
    "plot_iterative_montage": lambda v, p, i, d: [v.plot_iterative_montage(
        i["pos"], i["u_trace"], f"{d}/a.png", sol=i["sol"],
        res_trace=i["res"], ncols=3, title="montage")],
    "plot_paper_figure": lambda v, p, i, d: [v.plot_paper_figure(
        i["pos"], i["tags"], i["u_trace"], i["sol"], f"{d}/a.png",
        res_trace=i["res"], nstep=5, title="paper",
        triangles=i["triangles"])],
    "plot_training_comparison": lambda v, p, i, d: [
        v.plot_training_comparison(LOGS, f"{d}/a.png", ref_runs={
            "psignn": LOGS["dss"], "dsgps": f"{d}/absent.csv"},
            key="MSE")],
    "plot_losses": lambda v, p, i, d: [
        p.plot_losses(i["hist"], i["hist"], d),
        f"{d}/track_losses.png"][1:],
    "plot_gradients": lambda v, p, i, d: [
        p.plot_gradients(i["grads"], 3, d), f"{d}/gradients.png"][1:],
}


def _pixels(path):
    """The decoded image: every frame of a GIF, else the PNG's array."""
    if path.endswith(".gif"):
        with Image.open(path) as im:
            return [np.asarray(f.convert("RGBA"))
                    for f in ImageSequence.Iterator(im)]
    return [imread(path)]


def test_every_drawing_function_has_a_case():
    """The cases cover every public function of JAX's ``vis.py`` and
    ``plots.py`` but the two readers, and the port has each by name."""
    import inspect
    public = {name for mod in (jax_vis, jax_plots)
              for name, f in vars(mod).items()
              if inspect.isfunction(f) and f.__module__ == mod.__name__
              and not name.startswith("_")}
    assert public - set(CASES) == {"load_sweep_csv", "parse_val_curve"}
    assert len(CASES) == 19
    for name in public:
        mine = getattr(vis, name, None) or getattr(plots, name)
        theirs = getattr(jax_vis, name, None) or getattr(jax_plots, name)
        assert inspect.signature(mine) == inspect.signature(theirs), name


@pytest.mark.parametrize("name", list(CASES))
def test_figure_pixels_equal_jax(name, inp, tmp_path):
    draw = CASES[name]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = draw(jax_vis, jax_plots, inp, str(tmp_path / "jax"))
    got = draw(vis, plots, inp, str(tmp_path / "port"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert got
    for a, b in zip(got, want):
        fa, fb = _pixels(a), _pixels(b)
        assert len(fa) == len(fb) >= 1
        for x, y in zip(fa, fb):
            assert x.shape == y.shape and x.size > 0
            np.testing.assert_array_equal(x, y, err_msg=a)


def test_gradient_plot_without_norms_draws_nothing(tmp_path):
    plots.plot_gradients({}, 0, str(tmp_path))
    assert not list(tmp_path.iterdir())


def test_modules_import_without_matplotlib_or_pillow():
    """With ``matplotlib`` and ``PIL`` blocked, every module of the port
    (and the smoke script) imports; a drawing call then raises an
    ``ImportError`` naming matplotlib, the GIF's naming Pillow."""
    script = (
        "import importlib, json, pkgutil, sys\n"
        "sys.modules['matplotlib'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import psignn_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,\n"
        "                                               p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from psignn_tpu_torch.eval import vis\n"
        "from psignn_tpu_torch.train import plots\n"
        "out = {'modules': len(names)}\n"
        "for key, call in (\n"
        "        ('map', lambda: vis.plot_solution_map(None, None, 'x')),\n"
        "        ('losses', lambda: plots.plot_losses({}, {}, '.')),\n"
        "        ('gif', lambda: vis.assemble_gif([], 'x.gif'))):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        out[key] = [e.name, str(e)]\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["modules"] >= 40
    for key in ("map", "losses"):
        assert out[key][0] == "matplotlib" and "matplotlib" in out[key][1]
    assert out["gif"][0] == "PIL" and "Pillow" in out["gif"][1]
    assert not os.path.exists(os.path.join(ROOT, "x"))
