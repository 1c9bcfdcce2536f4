"""The port's training-curve readers (``eval/curves.py``) and run registry
(``eval/registry.py``) against the JAX package's ``eval/curves.py``,
``eval/vis.py`` and ``eval/registry.py``, on the ``OURS`` text of
``tests/test_curves.py``, on every ``results/*/logs/train_metrics.csv`` of
the repository and on a log the port's trainer writes.  Parsing is exact
(tolerance 0); ``--plot`` draws JAX's figure from the same data, its
legend naming the port's device."""

import glob
import os

import numpy as np
import pytest

from psignn_tpu.eval import curves as jax_curves
from psignn_tpu.eval import registry as jax_registry
from psignn_tpu.eval import vis as jax_vis
from psignn_tpu_torch.data.generate import generate_data
from psignn_tpu_torch.data.reader import (GraphLoader, load_dataset,
                                          split_dataset)
from psignn_tpu_torch.eval import curves, registry
from psignn_tpu_torch.eval.sweep import growing_geometry_sweep
from psignn_tpu_torch.models import PsignnConfig
from psignn_tpu_torch.train import TrainConfig, Trainer
from test_curves import OURS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGS = sorted(glob.glob(os.path.join(ROOT, "results", "*", "logs",
                                     "train_metrics.csv")))


@pytest.fixture
def ours(tmp_path):
    path = tmp_path / "train_metrics.csv"
    path.write_text(OURS)
    return str(path)


def _same_rows(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a == b


def test_repository_has_its_logs():
    assert len(LOGS) == 13


@pytest.mark.parametrize("path", LOGS, ids=lambda p: p.split(os.sep)[-3])
def test_parsers_match_jax_on_repository_logs(path):
    assert curves.parse_val(path) == jax_curves.parse_val(path)
    assert curves.parse_epoch_times(path) == jax_curves.parse_epoch_times(
        path)
    for key in ("Res", "MSE", "Train"):
        got, want = curves.parse_val_curve(path, key), \
            jax_vis.parse_val_curve(path, key)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # each log against the repository's Ψ-GNN Dirichlet run
    ref = os.path.join(ROOT, "results/psignn_dirichlet/logs/"
                       "train_metrics.csv")
    _same_rows(curves.compare(path, ref)[0], jax_curves.compare(path, ref)[0])


def test_parsers_match_jax_on_our_text(ours):
    assert curves.parse_val(ours) == jax_curves.parse_val(ours) == {
        0: (0.4, 30.0), 1: (0.2, 15.0)}
    assert curves.parse_epoch_times(ours) == jax_curves.parse_epoch_times(
        ours) == {0: 42.5, 1: 40.0}
    ref = LOGS[0]
    got, want = curves.compare(ours, ref, (0, 1, 5)), \
        jax_curves.compare(ours, ref, (0, 1, 5))
    _same_rows(got[0], want[0])
    assert got[1:] == want[1:]


def test_write_report_matches_jax_but_the_device(ours, tmp_path):
    ref = os.path.join(ROOT, "results/dss_dirichlet/logs/train_metrics.csv")
    rows, ov, rv = curves.compare(ours, ref)
    times = curves.parse_epoch_times(ours)
    mine = curves.write_report(rows, ov, rv, "dss", str(tmp_path / "a.md"),
                               times, device="cpu")
    theirs = jax_curves.write_report(rows, ov, rv, "dss",
                                     str(tmp_path / "b.md"), times)
    mine, theirs = (open(p).read().splitlines() for p in (mine, theirs))
    diff = [i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b]
    assert len(mine) == len(theirs) and diff == [2]
    assert mine[2] == "Epoch time (steady state): 40.0s/epoch on CPU."


def test_load_sweep_csv_matches_jax(tmp_path):
    from psignn_tpu_torch.eval.parity import build_predictors
    growing_geometry_sweep(
        {"dss": build_predictors(source="trained", device="cpu")["dss"]},
        radii=(0.6, 1.0), n_meshes=1, hsize=0.2, out_dir=str(tmp_path),
        device="cpu")
    path = str(tmp_path / "dss_results.csv")
    got = curves.load_sweep_csv(path)
    assert got == jax_vis.load_sweep_csv(path)
    assert set(got) == {0.6, 1.0} and "mse" in got[0.6]


def test_port_trainer_log_parses(tmp_path):
    data = str(tmp_path / "data")
    generate_data(data, n_mesh=2, n_samples=5, hsize=0.25, seed=21,
                  verbose=False)
    train, val, _ = split_dataset(load_dataset(data))
    tr = Trainer(TrainConfig(
        model_cfg=PsignnConfig(fw_tol=1e-3, fw_thres=25, bw_tol=1e-5,
                               bw_thres=25),
        max_epochs=2, path_results=str(tmp_path / "run"), device="cpu"),
        GraphLoader(train, batch_size=3, shuffle=True, seed=0, device="cpu"),
        GraphLoader(val, batch_size=3, device="cpu"))
    tr.train_model()
    log = str(tmp_path / "run" / "logs" / "train_metrics.csv")
    vals = curves.parse_val(log)
    assert vals == jax_curves.parse_val(log)
    assert sorted(vals) == [0, 1]
    for e, (res, mse) in vals.items():
        # the log's %.5e of the values the trainer kept
        assert res == float(f"{tr.hist_val['residual_loss'][e]:.5e}")
        assert mse == float(f"{tr.hist_val['mse_loss'][e]:.5e}")
    assert sorted(curves.parse_epoch_times(log)) == [0, 1]


def _below(root, paths):
    return {k: os.path.relpath(v, root) for k, v in paths.items()}


def test_registry_paths_match_jax():
    """The same run names and paths as JAX's; the reference's runs below
    the port's ``REF``, inside the checkout, as below JAX's fixed path."""
    assert registry.REPO == jax_registry.REPO == ROOT
    assert registry.OUR_CURVES == jax_registry.OUR_CURVES
    assert registry.REF == os.path.join(ROOT, "reference")
    assert _below(registry.REF, registry.REF_CURVES) == \
        _below(jax_registry.REF, jax_registry.REF_CURVES)


def _drawn(monkeypatch, draw):
    """The figures ``draw()`` closes, kept open to be read."""
    import matplotlib.pyplot as plt
    figs = []
    monkeypatch.setattr(plt, "close", figs.append)
    draw()
    monkeypatch.undo()
    for fig in figs:
        plt.close(fig)
    return figs


def test_plot_exits_2(ours, tmp_path, monkeypatch, capsys):
    """``--plot``, which exited 2 while the port drew no figures, draws
    JAX's overlay: the same lines (x and y data, colours), scales, labels
    and title; only the legend's device differs, and names no TPU."""
    ref = os.path.join(ROOT, "results/dss_dirichlet/logs/train_metrics.csv")
    path = tmp_path / "c.png"
    (mine,) = _drawn(monkeypatch, lambda: curves.main(
        ["--ours", ours, "--ref", ref, "--label", "dss", "--plot",
         str(path)]))
    assert path.stat().st_size > 0
    assert capsys.readouterr().out.splitlines()[-1] == f"wrote {path}"
    (theirs,) = _drawn(monkeypatch, lambda: jax_curves.plot(
        curves.parse_val(ours), curves.parse_val(ref), "dss",
        str(tmp_path / "j.png")))
    (a,), (b,) = mine.axes, theirs.axes
    assert len(a.get_lines()) == len(b.get_lines()) == 2
    for la, lb in zip(a.get_lines(), b.get_lines()):
        np.testing.assert_array_equal(la.get_xydata(), lb.get_xydata())
        assert la.get_color() == lb.get_color()
    for get in ("get_xscale", "get_yscale", "get_xlabel", "get_ylabel",
                "get_title"):
        assert getattr(a, get)() == getattr(b, get)(), get
    labels = [t.get_text() for t in a.get_legend().get_texts()]
    assert labels == [f"psignn_tpu_torch ({curves.device_name()})",
                      "reference (2 GPUs)"]
    assert [t.get_text() for t in b.get_legend().get_texts()][1:] == \
        labels[1:]
    assert not any("TPU" in t for t in labels)


def test_main_prints_rows_and_writes_report(ours, tmp_path, capsys):
    ref = os.path.join(ROOT, "results/dss_dirichlet/logs/train_metrics.csv")
    out = tmp_path / "curves.md"
    curves.main(["--ours", ours, "--ref", ref, "--label", "dss", "--out",
                 str(out)])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("epoch 0 (ours 0): val res 4.000e-01")
    assert printed[-1] == f"wrote {out}"
    assert out.read_text().startswith("# Training-curve parity — dss")
