"""The port's notebooks (``notebooks/*_torch.ipynb``) run end to end on
the CPU, every code cell in order, drawing cells included: the first
cell's constants replaced by ``DEVICE = "cpu"``, small sizes and an
output directory under the test's own temporary directory.

Held beyond running: the demo's dataset equals the JAX factory's at the
same seed and sizes, array by array; the partitioned request agrees with
the one process's within ``dist.dryrun``'s limits; the comparatives'
tables are finite and complete.
"""

import os
import re

import numpy as np
import pytest

import chip_smoke
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu.data.generate import add_dss_variable as jax_add_dss
from psignn_tpu.data.generate import generate_data as jax_generate_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(name: str, tmp_path, **constants) -> dict:
    """Every code cell of ``notebooks/<name>.ipynb`` on the CPU, from the
    repository's root; the namespace they leave."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        return chip_smoke.run_cells(chip_smoke.notebook_cells(name), name,
                                    DEVICE="cpu", OUT=str(tmp_path),
                                    **constants)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("name", ["demo_torch", "comparatives_torch",
                                  "partitioned_torch"])
def test_first_cell_names_the_card(name):
    """The first code cell holds the device and the sizes as constants,
    ``DEVICE = "cuda"``; no cell holds an output; exactly the cells that
    draw or display carry the tag ``draw``."""
    import json
    with open(os.path.join(ROOT, "notebooks", name + ".ipynb")) as f:
        nb = json.load(f)
    code = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert 'DEVICE = "cuda"' in "".join(code[0]["source"])
    assert all(not c["outputs"] and c["execution_count"] is None
               for c in code)
    for c in code:
        drawn = bool(re.search(r"\bvis\.|iteration_gif|plot_radius_sweep|"
                               r"IPython", "".join(c["source"])))
        assert drawn == ("draw" in c["metadata"].get("tags", [])), c


def test_demo_runs_and_generates_the_jax_dataset(tmp_path):
    ns = run("demo_torch", tmp_path / "port", N_MESH=2, N_SAMPLES=5)
    jax_dir = str(tmp_path / "jax")
    jax_generate_data(jax_dir, n_mesh=2, n_samples=5, hsize=ns["HSIZE"],
                      seed=0, verbose=False)
    jax_add_dss(jax_dir)
    names = sorted(n for n in os.listdir(jax_dir) if n.endswith(".npy"))
    assert names == sorted(n for n in os.listdir(ns["DATA"])
                           if n.endswith(".npy"))
    for n in names:
        want = np.load(os.path.join(jax_dir, n), allow_pickle=True)
        got = np.load(os.path.join(ns["DATA"], n), allow_pickle=True)
        assert got.shape == want.shape and got.dtype == want.dtype, n
        for g, w in zip(got.ravel() if got.dtype == object else [got],
                        want.ravel() if want.dtype == object else [want]):
            if hasattr(g, "toarray"):
                g, w = g.toarray(), w.toarray()
            np.testing.assert_array_equal(g, w, err_msg=n)
    assert len(ns["trainer"].hist_val["loss"]) == ns["EPOCHS"]
    assert all(np.isfinite(v) for v in ns["results"].values())
    assert int(ns["trace"]["nstep"]) > 0
    for png in ("demo_convergence.png", "demo_heart.png",
                "demo_heart_error.png"):
        assert os.path.getsize(tmp_path / "port" / png) > 0


def test_comparatives_runs(tmp_path):
    ns = run("comparatives_torch", tmp_path)
    assert sorted(ns["preds"]) == ["dsgps", "dss", "psignn"]
    for per_r in ns["summary"].values():
        assert sorted(per_r) == sorted(ns["RADII"])
        assert all(np.isfinite(m["mse"]) for m in per_r.values())
    assert sorted(ns["zoo"]) == sorted(ns["ZOO_SHAPES"])
    assert ns["us"].shape[0] == int(ns["trace"]["trace_len"])
    assert sorted(ns["robust"]) == ["default", "random", "solution", "zero"]
    for name in ("sweep.png", "convergence.gif"):
        assert os.path.getsize(tmp_path / name) > 0


def test_partitioned_runs_and_agrees_with_one_process(tmp_path):
    """dp 1 × 2 parts: the partitioned request of the trained Ψ-GNN is
    the one process's within the dry run's limits (``_against_one_
    process``: |Δnstep| ≤ 1, u within 1e-2 relative and 2e-3 absolute,
    the residual within 1e-3), on each rank and gathered; the train steps
    are finite."""
    ns = run("partitioned_torch", tmp_path, N_PARTS=2, DP=1, TRAIN_PARTS=2)
    assert [r["partitioned_agrees"] for r in ns["ranks"]] == [True, True]
    assert abs(ns["ranks"][0]["nstep"] - ns["one"].nstep) <= 1
    np.testing.assert_allclose(ns["u_parts"], ns["u_one"], rtol=1e-2,
                               atol=2e-3)
    assert len(ns["steps"]) == 2 and len(ns["steps"][0]) == ns["STEPS"]
    assert np.isfinite(np.array(ns["steps"][0], dtype=float)).all()
    assert ns["steps"][0] == ns["steps"][1]
