"""Figures: solution and error maps, node types, iterate frames, GIFs and
montages, convergence and training curves, the growing-geometry
comparison and the paper composite.

Port of ``psignn_tpu/eval/vis.py`` with its names, signatures, defaults,
figure sizes, dpi, colormaps, levels, titles and file names: the same
numpy arrays give the same image.  Inputs are numpy arrays (callers
holding tensors pass ``.detach().cpu().numpy()``); nothing here touches
torch.  matplotlib is imported inside each drawing function, through
``load_pyplot``, and Pillow inside ``assemble_gif``: the module imports
on a host without either (the card's), and a drawing call there raises
an ``ImportError`` that names the missing package (its ``name`` too).
The two log readers, ``load_sweep_csv`` and ``parse_val_curve``, draw
nothing and need neither.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np


def load_pyplot():
    """(``matplotlib.pyplot``, ``matplotlib.tri``) on the Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("drawing a figure needs matplotlib, which is not "
                          "installed here", name="matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import matplotlib.tri as mtri
    return plt, mtri


def _triangulation(mtri, pos, triangles=None):
    """The mesh's triangles, or Delaunay's of ``pos`` when None."""
    return mtri.Triangulation(pos[:, 0], pos[:, 1], triangles)


def plot_solution_map(pos, u, path, title="Solution", cmap="viridis",
                      triangles=None):
    """Tricontour map of a nodal field (vis.py solution maps)."""
    plt, mtri = load_pyplot()
    tri = _triangulation(mtri, pos, triangles)
    fig, ax = plt.subplots(figsize=(6, 5))
    tc = ax.tricontourf(tri, np.asarray(u).ravel(), levels=30, cmap=cmap)
    fig.colorbar(tc, ax=ax)
    ax.set_title(title)
    ax.set_aspect("equal")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_error_map(pos, u, sol, path, title="|u - sol|", triangles=None):
    err = np.abs(np.asarray(u).ravel() - np.asarray(sol).ravel())
    return plot_solution_map(pos, err, path, title=title, cmap="magma",
                             triangles=triangles)


def plot_node_types(pos, tags, path, title="Node types"):
    """Scatter map of interior / Dirichlet / Neumann nodes
    (vis.py node-type maps)."""
    plt, _ = load_pyplot()
    tags = np.asarray(tags)
    fig, ax = plt.subplots(figsize=(6, 5))
    if tags.shape[-1] == 3:
        kinds = [("interior", tags[:, 0] == 1, "tab:gray"),
                 ("dirichlet", tags[:, 1] == 1, "tab:blue"),
                 ("neumann", tags[:, 2] == 1, "tab:red")]
    else:
        t = tags.ravel()
        kinds = [("interior", t == 0, "tab:gray"),
                 ("dirichlet", t == 1, "tab:blue")]
    for name, m, c in kinds:
        ax.scatter(pos[m, 0], pos[m, 1], s=8, c=c, label=name)
    ax.legend()
    ax.set_aspect("equal")
    ax.set_title(title)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_convergence(res_trace: Sequence[float], path,
                     mse_trace: Optional[Sequence[float]] = None,
                     title="Convergence"):
    """Residual (and MSE) vs iteration curves (vis.py residual/MSE
    iteration plots; psignn iterative_inference output)."""
    plt, _ = load_pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogy(np.asarray(res_trace), label="residual")
    if mse_trace is not None:
        ax.semilogy(np.asarray(mse_trace), label="MSE vs FEM")
    ax.set_xlabel("iteration")
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_iteration_frames(pos, u_trace, out_dir, prefix="iter",
                          sol: Optional[np.ndarray] = None,
                          every: int = 1, triangles=None) -> List[str]:
    """Per-iteration solution frames (the reference renders GIF frames from
    ``iterative_inference``, vis.py)."""
    plt, mtri = load_pyplot()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    u_trace = np.asarray(u_trace)
    vmin = float(u_trace.min()) if sol is None else float(np.min(sol))
    vmax = float(u_trace.max()) if sol is None else float(np.max(sol))
    tri = _triangulation(mtri, pos, triangles)
    for k in range(0, len(u_trace), every):
        fig, ax = plt.subplots(figsize=(5, 4))
        tc = ax.tricontourf(tri, u_trace[k].ravel(), levels=30,
                            vmin=vmin, vmax=vmax, cmap="viridis")
        fig.colorbar(tc, ax=ax)
        ax.set_title(f"iteration {k}")
        ax.set_aspect("equal")
        p = os.path.join(out_dir, f"{prefix}_{k:04d}.png")
        fig.savefig(p, dpi=80, bbox_inches="tight")
        plt.close(fig)
        paths.append(p)
    return paths


def assemble_gif(frame_paths: Sequence[str], out_path: str,
                 duration_ms: int = 120, loop: int = 0) -> str:
    """Assemble per-iteration frames into an animated GIF (the reference
    builds convergence GIFs from its iteration frames,
    dirichlet/psignn/test/vis.py GIF sections)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("assembling a GIF needs Pillow (PIL), which is "
                          "not installed here", name="PIL") from e
    frames = [Image.open(p).convert("P", palette=Image.ADAPTIVE)
              for p in frame_paths]
    if not frames:
        raise ValueError("no frames to assemble")
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=duration_ms, loop=loop)
    return out_path


def iteration_gif(pos, u_trace, out_path: str, sol=None, every: int = 1,
                  triangles=None, duration_ms: int = 120) -> str:
    """One-call GIF of an ``iterative_inference`` trace."""
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        paths = plot_iteration_frames(pos, u_trace, td, sol=sol, every=every,
                                      triangles=triangles)
        return assemble_gif(paths, out_path, duration_ms=duration_ms)


def plot_spectral_radius(csv_path: str, out_path: str):
    """Spectral-radius history from the trainer's CSV log
    (utilities/vis.py:836)."""
    plt, _ = load_pyplot()
    vals = []
    with open(csv_path) as f:
        for line in f.readlines()[1:]:
            line = line.strip()
            if line:
                try:
                    vals.append(float(line))
                except ValueError:
                    pass
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(vals)
    ax.axhline(1.0, color="r", linestyle="--", label="ρ = 1")
    ax.set_xlabel("validation batch")
    ax.set_ylabel("spectral radius")
    ax.legend()
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_radius_sweep(summary: Dict[str, Dict[float, Dict[str, float]]],
                      out_path: str, metric: str = "mse"):
    """Cross-model growing-geometry comparison plot
    (tests/txtresults/plot_results.ipynb analog)."""
    plt, _ = load_pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, per_radius in summary.items():
        rs = sorted(per_radius.keys())
        ax.semilogy(rs, [per_radius[r][metric] for r in rs], "o-",
                    label=name)
    ax.set_xlabel("radius")
    ax.set_ylabel(metric)
    ax.legend()
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path


def load_sweep_csv(path: str) -> Dict[float, Dict[str, float]]:
    """Parse a ``growing_geometry_sweep`` CSV (metric rows × radius cols)."""
    with open(path) as f:
        lines = [l.strip().split(",") for l in f if l.strip()]
    radii = [float(x) for x in lines[0][1:]]
    out = {r: {} for r in radii}
    for row in lines[1:]:
        for r, v in zip(radii, row[1:]):
            out[r][row[0]] = float(v)
    return out


REF_TIME = {  # tests/txtresults/*_results.csv row 6/9 (BASELINE.md)
    "psignn": {0.6: 0.089, 1.0: 0.166, 2.0: 0.501, 4.0: 2.13, 5.0: 3.18},
    "dss": {0.6: 0.048, 1.0: 0.047, 2.0: 0.050, 4.0: 0.051, 5.0: 0.052},
    "dsgps": {0.6: 0.248, 1.0: 0.255, 2.0: 0.259, 4.0: 0.263, 5.0: 0.278},
}


def plot_radius_comparison(csv_dir: str, out_path: str,
                           families=("psignn", "dsgps", "dss")):
    """The comparative figure table (reference ``plot_radius.ipynb`` /
    ``tests/txtresults/plot_results.ipynb``): per-radius MSE, relative L2,
    iteration count, and wall-clock for every family, ours (solid) overlaid
    on the reference's published sweep (dashed)."""
    from .parity import BASELINE_MSE, BASELINE_NSTEP

    plt, _ = load_pyplot()
    colors = {"psignn": "#2a7de1", "dsgps": "#e1742a", "dss": "#3cb371"}
    panels = [("mse", "MSE vs FEM", True), ("rel", "relative L2", True),
              ("nstep", "fixed-point iterations", False),
              ("time", "inference wall-clock (s)", True)]
    fig, axes = plt.subplots(1, 4, figsize=(20, 4))
    for ax, (metric, title, logy) in zip(axes, panels):
        plotted = False
        for fam in families:
            path = os.path.join(csv_dir, f"{fam}_results.csv")
            if not os.path.exists(path):
                continue
            data = load_sweep_csv(path)
            rs = sorted(data)
            c = colors.get(fam, None)
            vals = [data[r].get(metric, float("nan")) for r in rs]
            if metric == "nstep" and fam != "psignn":
                continue
            if not np.isfinite(vals).any():
                continue
            plotted = True
            ax.plot(rs, vals, "o-", color=c, label=f"{fam} (ours)")
            ref = None
            if metric == "mse":
                ref = BASELINE_MSE.get(fam)
            elif metric == "time":
                ref = REF_TIME.get(fam)
            elif metric == "nstep" and fam == "psignn":
                ref = BASELINE_NSTEP
            if ref:
                rr = sorted(ref)
                plotted = True
                ax.plot(rr, [ref[r] for r in rr], "s--", color=c,
                        alpha=0.55, label=f"{fam} (reference)")
        if not plotted:
            ax.axis("off")
            continue
        if logy:
            ax.set_yscale("log")
        ax.set_xlabel("radius")
        ax.set_title(title)
        ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def _node_type_scatter(ax, pos, tags, sizes):
    """Interior, Dirichlet (and Neumann) nodes of ``tags`` (one column or
    one-hot [interior, dirichlet, neumann]) at marker sizes
    (interior, boundary)."""
    tags = np.asarray(tags).reshape(len(pos), -1)
    bnd = tags[:, 0] == 1 if tags.shape[1] == 1 else tags[:, 1] == 1
    ax.scatter(pos[~bnd, 0], pos[~bnd, 1], s=sizes[0], c="tab:gray",
               label="interior")
    ax.scatter(pos[bnd, 0], pos[bnd, 1], s=sizes[1], c="tab:blue",
               label="dirichlet")
    if tags.shape[1] == 3:
        neu = tags[:, 2] == 1
        ax.scatter(pos[neu, 0], pos[neu, 1], s=sizes[1], c="tab:red",
                   label="neumann")


def plot_sample_panel(pos, u, sol, tags, path, title="", triangles=None):
    """The reference's paper/poster 4-panel figure (vis.py:23-1266 figure
    families): FEM ground truth, model solution, absolute error, node
    types — one mesh, one row."""
    plt, mtri = load_pyplot()
    tri = _triangulation(mtri, pos, triangles)
    u = np.asarray(u).ravel()
    sol = np.asarray(sol).ravel()
    fig, axes = plt.subplots(1, 4, figsize=(20, 4.5))
    for ax, field, name, cmap in (
            (axes[0], sol, "FEM solution", "viridis"),
            (axes[1], u, "model solution", "viridis"),
            (axes[2], np.abs(u - sol), "|u − sol|", "magma")):
        tc = ax.tricontourf(tri, field, levels=30, cmap=cmap)
        fig.colorbar(tc, ax=ax, shrink=0.85)
        ax.set_title(name)
        ax.set_aspect("equal")
    _node_type_scatter(axes[3], pos, tags, (4, 6))
    axes[3].set_title("node types")
    axes[3].set_aspect("equal")
    axes[3].legend(fontsize=7)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_iteration_metrics(trace_metrics: Dict[str, np.ndarray], path,
                           nstep: Optional[int] = None,
                           title="Ψ-GNN iterate metrics"):
    """Residual / MSE / boundary / interior MSE vs fixed-point iteration
    (the reference's iterate-inspection curves, vis.py residual/MSE-vs-
    iteration family).  ``trace_metrics``: psignn_iterative_inference's
    ``trace`` dict (arrays indexed by iterate)."""
    plt, _ = load_pyplot()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for key, label in (("res", "residual ‖Au−b‖²"), ("mse", "MSE vs FEM"),
                       ("bound_mse", "boundary MSE"),
                       ("inter_mse", "interior MSE")):
        if key in trace_metrics:
            vals = np.asarray(trace_metrics[key]).ravel()
            if nstep is not None:
                vals = vals[:nstep]
            ax.semilogy(np.arange(1, len(vals) + 1), vals, label=label)
    ax.set_xlabel("fixed-point iteration")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_nstep_vs_nodes(rows: Sequence[Dict[str, float]], path,
                        title="Adaptive iteration count"):
    """nstep-vs-mesh-size scatter (the DEQ's selling point: iterations grow
    with domain diameter, psignn_results.csv:7).  ``rows``: dicts with
    ``n_nodes`` and ``nstep`` (e.g. collected from test_sample)."""
    plt, _ = load_pyplot()
    n = [r["n_nodes"] for r in rows]
    s = [r["nstep"] for r in rows]
    fig, ax = plt.subplots(figsize=(6, 4.5))
    ax.scatter(n, s, s=18, c="#2a7de1")
    ax.set_xscale("log")
    ax.set_xlabel("mesh nodes")
    ax.set_ylabel("fixed-point iterations")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_zoo_grid(samples: Dict[str, Dict[str, np.ndarray]], path,
                  field: str = "sol", title="Geometry zoo"):
    """Solution maps across the OOD geometry zoo in one grid (the
    reference's special-geometry figure tables).  ``samples``:
    {shape_name: dict with pos + the plotted nodal field}."""
    plt, mtri = load_pyplot()
    names = sorted(samples)
    ncol = 4
    nrow = -(-len(names) // ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(4.2 * ncol, 3.6 * nrow))
    axes = np.atleast_2d(axes)
    for i, name in enumerate(names):
        ax = axes[i // ncol][i % ncol]
        s = samples[name]
        pos = np.asarray(s["pos"])
        tri = _triangulation(mtri, pos)
        tc = ax.tricontourf(tri, np.asarray(s[field]).ravel(), levels=25,
                            cmap="viridis")
        fig.colorbar(tc, ax=ax, shrink=0.8)
        ax.set_title(name, fontsize=9)
        ax.set_aspect("equal")
    for j in range(len(names), nrow * ncol):
        axes[j // ncol][j % ncol].axis("off")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_iterative_montage(pos, u_trace, path, sol=None, iters=None,
                           res_trace=None, ncols=4, title="",
                           triangles=None, cmap="viridis"):
    """Per-iteration solution-map montage — the reference's
    ``plot_iterative_updates`` (vis.py:148-242): a grid of decoded iterates
    U_k on the mesh, labeled with iteration index (and residual when
    given), sharing ONE color scale so magnitude reads across panels.

    ``u_trace``: (T, N, 1) decoded iterates (psignn_iterative_inference
    ``trace["u"]`` / dsgps_iterative_inference); ``iters``: which iterate
    indices to show (default: ~ncols*2 evenly spaced incl. first/last)."""
    plt, mtri = load_pyplot()
    u_trace = np.asarray(u_trace)
    T = u_trace.shape[0]
    if iters is None:
        n_show = min(T, ncols * 2)
        iters = sorted({int(i) for i in np.linspace(0, T - 1, n_show)})
    tri = _triangulation(mtri, pos, triangles)
    fields = [u_trace[i].ravel() for i in iters]
    if sol is not None:
        fields.append(np.asarray(sol).ravel())
    vmin = min(f.min() for f in fields)
    vmax = max(f.max() for f in fields)
    levels = np.linspace(vmin, vmax, 31)
    n_panels = len(iters) + (1 if sol is not None else 0)
    nrows = -(-n_panels // ncols)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(3.6 * ncols, 3.1 * nrows))
    axes = np.atleast_1d(axes).ravel()
    tc = None
    for ax, it in zip(axes, iters):
        tc = ax.tricontourf(tri, u_trace[it].ravel(), levels=levels,
                            cmap=cmap)
        lab = f"iteration {it}"
        if res_trace is not None:
            lab += f"  (res {float(np.asarray(res_trace)[it]):.2e})"
        ax.set_title(lab, fontsize=9)
        ax.set_aspect("equal")
        ax.set_xticks([]); ax.set_yticks([])
    if sol is not None:
        ax = axes[len(iters)]
        tc = ax.tricontourf(tri, np.asarray(sol).ravel(), levels=levels,
                            cmap=cmap)
        ax.set_title("FEM solution", fontsize=9)
        ax.set_aspect("equal")
        ax.set_xticks([]); ax.set_yticks([])
    for ax in axes[n_panels:]:
        ax.axis("off")
    if tc is not None:
        fig.colorbar(tc, ax=list(axes), shrink=0.8, fraction=0.03)
    if title:
        fig.suptitle(title)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_paper_figure(pos, tags, u_trace, sol, path, res_trace=None,
                      nstep=None, title="", triangles=None):
    """Paper-style composite — the reference's ``plot_paper`` /
    ``plot_paper_2`` (vis.py:705-962): node types, initial state, two
    intermediate iterates, final solution vs FEM ground truth, error map,
    and the residual convergence curve, in one figure."""
    plt, mtri = load_pyplot()
    u_trace = np.asarray(u_trace)
    sol = np.asarray(sol).ravel()
    T = u_trace.shape[0]
    last = (int(nstep) if nstep is not None else T) - 1
    last = max(0, min(last, T - 1))
    # clamp to the trace: a 1-2 iterate run has no distinct mid panels
    mids = sorted({min(max(1, last // 3), last),
                   min(max(2, (2 * last) // 3), last)} - {0, last}) \
        if last > 1 else []
    tri = _triangulation(mtri, pos, triangles)
    u_final = u_trace[last].ravel()
    fields = [u_trace[0].ravel(), *(u_trace[m].ravel() for m in mids),
              u_final, sol]
    vmin = min(f.min() for f in fields); vmax = max(f.max() for f in fields)
    levels = np.linspace(vmin, vmax, 31)

    fig = plt.figure(figsize=(19, 8.5))
    gs = fig.add_gridspec(2, 4, hspace=0.25, wspace=0.2)
    panels = [
        ("initial state $U_0$", u_trace[0].ravel(), levels, "viridis"),
        *[(f"iteration {m}", u_trace[m].ravel(), levels, "viridis")
          for m in mids],
        (f"final (iteration {last})", u_final, levels, "viridis"),
        ("FEM solution", sol, levels, "viridis"),
        ("|u − sol|", np.abs(u_final - sol), None, "magma"),
    ]
    tc_main = None
    for i, (name, field, lv, cmap) in enumerate(panels):
        ax = fig.add_subplot(gs[i // 4, i % 4])
        tc = ax.tricontourf(tri, field, levels=(lv if lv is not None
                                                else 30), cmap=cmap)
        if lv is not None:
            tc_main = tc
        else:
            fig.colorbar(tc, ax=ax, shrink=0.85)
        ax.set_title(name, fontsize=10)
        ax.set_aspect("equal")
        ax.set_xticks([]); ax.set_yticks([])
    # node types
    ax = fig.add_subplot(gs[1, 2])
    _node_type_scatter(ax, pos, tags, (3, 5))
    ax.set_title("node types", fontsize=10)
    ax.set_aspect("equal"); ax.set_xticks([]); ax.set_yticks([])
    ax.legend(fontsize=7, loc="upper right")
    # convergence curve
    ax = fig.add_subplot(gs[1, 3])
    if res_trace is not None:
        r = np.asarray(res_trace).ravel()[:last + 1]
        ax.semilogy(np.arange(1, len(r) + 1), r, lw=1.8, color="tab:blue")
        ax.set_xlabel("iteration"); ax.set_ylabel("residual ‖Au−b‖²")
        ax.set_title("convergence", fontsize=10)
        ax.grid(alpha=0.25)
    else:
        ax.axis("off")
    if tc_main is not None:
        fig.colorbar(tc_main, ax=fig.axes[:len(panels) - 1], shrink=0.7,
                     fraction=0.02)
    if title:
        fig.suptitle(title, fontsize=13)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


# fixed categorical assignment for run-comparison curves: color follows the
# run identity everywhere these figures appear (never re-cycled per plot)
RUN_COLORS = {
    "psignn": "#1f77b4", "dsgps": "#d62728", "dss": "#2ca02c",
    "psignn_mixed": "#9467bd", "dsgps_mixed": "#e377c2",
    "reference": "#7f7f7f",
}


def parse_val_curve(csv_path: str, key: str = "Res"):
    """(epochs, values) of a per-epoch validation metric from a
    train_metrics.csv (ours or the reference's — same line format).

    Watchdog/resume restarts append duplicate 'Validation Epoch N' lines
    (the running checkpoint lags the log by up to an epoch), so epochs
    are deduplicated keeping the LAST occurrence and returned sorted —
    position in the returned arrays is NOT the epoch number; use the
    epoch column."""
    by_epoch = {}
    pat = re.compile(r"Validation Epoch (\d+) :(.*)")
    kpat = re.compile(rf"{key} : ([0-9.eE+-]+)")
    with open(csv_path) as f:
        for line in f:
            m = pat.search(line)
            if not m:
                continue
            km = kpat.search(m.group(2))
            if km:
                by_epoch[int(m.group(1))] = float(km.group(1))
    eps = np.asarray(sorted(by_epoch))
    return eps, np.asarray([by_epoch[e] for e in eps])


def plot_training_comparison(runs: Dict[str, str], path,
                             ref_runs: Optional[Dict[str, str]] = None,
                             key: str = "Res",
                             title="Validation residual vs epoch"):
    """Multi-run training-curve comparison — the reference's
    ``visualize_losses`` / ``plot_multi_residual`` (vis.py:1197-1262):
    each run's per-epoch validation metric on ONE log axis; our runs in
    the fixed run colors, reference curves dashed in the same hue."""
    plt, _ = load_pyplot()
    fig, ax = plt.subplots(figsize=(8.5, 5))
    for name, csv in runs.items():
        if not os.path.exists(csv):
            continue
        eps, vals = parse_val_curve(csv, key)
        if len(eps) == 0:
            continue
        c = RUN_COLORS.get(name, "#17becf")
        ax.semilogy(eps, vals, lw=1.8, color=c, label=f"{name} (ours)")
    for name, csv in (ref_runs or {}).items():
        if not os.path.exists(csv):
            continue
        eps, vals = parse_val_curve(csv, key)
        if len(eps) == 0:
            continue
        c = RUN_COLORS.get(name, "#7f7f7f")
        ax.semilogy(eps, vals, lw=1.4, ls="--", color=c, alpha=0.8,
                    label=f"{name} (reference)")
    ax.set_xlabel("epoch")
    ax.set_ylabel(f"val {key} (log)")
    ax.set_title(title)
    ax.grid(alpha=0.25, which="both")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
