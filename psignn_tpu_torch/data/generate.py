"""Dataset factory: n_mesh meshes × n_samples RHS samples → .npy archives.

Port of ``psignn_tpu/data/generate.py``, in the reference's format
(``dirichlet/dataset/generate_data.py:25-98``): seven pickled object arrays
(A_sparse_matrix, b_matrix, sol, prb_data, tags, coordinates, distance),
an eighth (unit_normal_vector) in the mixed variant, and a
``dataset_info.csv``.  The same seed draws the same numbers in the same
order as the JAX package's factory, so both write the same dataset.  A
Dirichlet dataset also gets DSS's encoding (``add_dss_variable``:
``A_prime.npy``, ``b_prime.npy`` and four more lines of
``dataset_info.csv``).

    python -m psignn_tpu_torch.data.generate --path_data data/ \\
        --n_mesh 200 --n_samples 50 [--variant mixed]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np

from .fem import solve_poisson, solve_poisson_mixed
from .meshgen import blob_mesh, mixed_blob_mesh
from .reader import dss_system

KEYS = ("A_sparse_matrix", "b_matrix", "sol", "prb_data", "tags",
        "coordinates", "distance")


def generate_data(path_data: str, n_mesh: int = 200, n_samples: int = 50,
                  radius: float = 1.0, hsize: float = 0.08,
                  nb_bound_points: int = 10, seed: int = 1234,
                  variant: str = "dirichlet",
                  verbose: bool = True) -> Dict[str, list]:
    if variant == "mixed":
        keys, make_mesh, solve = (KEYS + ("unit_normal_vector",),
                                  mixed_blob_mesh, solve_poisson_mixed)
    elif variant == "dirichlet":
        keys, make_mesh, solve = KEYS, blob_mesh, solve_poisson
    else:
        raise ValueError(f"variant must be 'dirichlet' or 'mixed', "
                         f"not {variant!r}")
    rng = np.random.default_rng(seed)
    lists = {k: [] for k in keys}
    fem_key = {"A_sparse_matrix": "A", "b_matrix": "b"}

    for n in range(n_mesh):
        mesh = make_mesh(radius=radius, hsize=hsize,
                         nb_bound_points=nb_bound_points, rng=rng)
        for _ in range(n_samples):
            s = solve(mesh, radius, rng)
            for k in keys:
                lists[k].append(s[fem_key.get(k, k)])
        if verbose and (n + 1) % 10 == 0:
            print(f"mesh {n + 1}/{n_mesh} ({mesh.n_points} nodes)")

    os.makedirs(path_data, exist_ok=True)
    for k, v in lists.items():
        _save_objects(path_data, k, v)

    _write_info(path_data, lists, n_mesh, n_samples)
    return lists


def _write_info(path_data, lists, n_mesh, n_samples):
    seq_nodes = [len(c) for c in lists["coordinates"]]
    prb = np.vstack(lists["prb_data"])
    dist = np.vstack(lists["distance"])
    with open(os.path.join(path_data, "dataset_info.csv"), "w") as f:
        f.write("Number of different meshes : %d\n" % n_mesh)
        f.write("Number of samples per meshes : %d\n" % n_samples)
        f.write("Total number of instances : %d\n" % (n_mesh * n_samples))
        f.write("Mean of prb_data : %s\n" % list(np.around(prb.mean(0), 4)))
        f.write("Std of prb_data : %s\n" % list(np.around(prb.std(0), 4)))
        f.write("Mean of distance : %s\n" % list(np.around(dist.mean(0), 4)))
        f.write("Std of distance : %s\n" % list(np.around(dist.std(0), 4)))
        f.write("Mean number of nodes : %d\n" % int(np.mean(seq_nodes)))
        f.write("Std number of nodes : %d\n" % int(np.std(seq_nodes)))
        f.write("Min number of nodes : %d\n" % int(np.min(seq_nodes)))
        f.write("Max number of nodes : %d\n" % int(np.max(seq_nodes)))


def _save_objects(path_data: str, name: str, items) -> None:
    arr = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        arr[i] = item
    np.save(os.path.join(path_data, f"{name}.npy"), arr, allow_pickle=True)


def add_dss_variable(path_data: str) -> None:
    """DSS's encoded system of every sample of a Dirichlet dataset
    (generate_data.py:100-143): ``A_prime.npy`` (A without its diagonal)
    and ``b_prime.npy`` (``reader.dss_system``), and their statistics
    appended to ``dataset_info.csv``."""
    list_a = np.load(os.path.join(path_data, "A_sparse_matrix.npy"),
                     allow_pickle=True)
    list_b = np.load(os.path.join(path_data, "b_matrix.npy"),
                     allow_pickle=True)
    a_prime, b_prime = zip(*(dss_system(a, b) for a, b in zip(list_a, list_b)))
    _save_objects(path_data, "b_prime", b_prime)
    _save_objects(path_data, "A_prime", a_prime)
    with open(os.path.join(path_data, "dataset_info.csv"), "a") as f:
        a = np.hstack([m.data for m in a_prime])
        bp = np.vstack(b_prime)
        f.write("Mean of a_ij : %s\n" % np.around(a.mean(), 4))
        f.write("Std of a_ij : %s\n" % np.around(a.std(), 4))
        f.write("Mean of b_prime : %s\n" % list(np.around(bp.mean(0), 4)))
        f.write("Std of b_prime : %s\n" % list(np.around(bp.std(0), 4)))


def main(argv=None):
    p = argparse.ArgumentParser(description="psignn_tpu_torch dataset factory")
    p.add_argument("--path_data", type=str, default="data/")
    p.add_argument("--n_mesh", type=int, default=200)
    p.add_argument("--n_samples", type=int, default=50)
    p.add_argument("--radius", type=float, default=1.0)
    p.add_argument("--hsize", type=float, default=0.08)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--variant", type=str, default="dirichlet",
                   choices=["dirichlet", "mixed"])
    args = p.parse_args(argv)
    generate_data(args.path_data, args.n_mesh, args.n_samples, args.radius,
                  args.hsize, seed=args.seed, variant=args.variant)
    if args.variant == "dirichlet":
        add_dss_variable(args.path_data)


if __name__ == "__main__":
    main()
