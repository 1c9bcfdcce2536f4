"""The general traffic generator: a mix's data file → its inputs.

A mix names a pool of meshes (``radii``, ``meshes_per_radius``,
``hsize``) drawn with the frozen generator from its ``pool_seed``, radius
by radius and mesh by mesh, each mesh FEM-solved (``rhs_per_mesh`` times,
a training pool's right-hand sides) from the same stream as the program's
sweep draws them (``eval.sweep.growing_geometry_sweep``).  The pool is
the same for every run seed, so every run does the same work; the run
seed draws the order in which the requests or batches come.  A checkout's first run draws the
pool in a child process, which keeps it in ``benchmark/.cache/pools/``;
every run then reads it from there, so that what a run's process has
allocated and freed before its window is the same in the first run and
in the runs after it.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from typing import Callable, Dict, List

import numpy as np

from . import gen

# the pool does not depend on the run seed, so the first run of a checkout
# draws it and keeps it here for the next runs (a few MB)
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, ".cache", "pools")
KEYS = ("x", "b", "sol", "prb_data", "tags", "pos", "senders", "receivers",
        "a_ij", "edge_attr")


def _rng(seed: int) -> np.random.Generator:
    """A generator for any whole seed (negative and wider than 64 bits
    too)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def _draw(traffic: dict) -> List[Dict[str, np.ndarray]]:
    """Mesh by mesh, ``rhs_per_mesh`` (default 1) FEM solves of each."""
    rng = _rng(traffic["pool_seed"])
    out = []
    for radius in traffic["radii"]:
        for _ in range(traffic["meshes_per_radius"]):
            mesh = gen.blob_mesh(radius, traffic["hsize"], rng)
            for _ in range(traffic.get("rhs_per_mesh", 1)):
                out.append(gen.psignn_sample_from_fem(
                    gen.solve_poisson(mesh, radius, rng)))
    return out


FIELDS = ("radii", "meshes_per_radius", "rhs_per_mesh", "hsize",
          "pool_seed")


def _path(fields: dict) -> str:
    """The cache file of a pool: the key hashes the mix's pool fields and
    the generator's source."""
    with open(gen.__file__, "rb") as f:
        src = f.read()
    key = hashlib.sha256(json.dumps(fields, sort_keys=True).encode()
                         + src).hexdigest()[:16]
    return os.path.join(CACHE, key + ".npz")


def _keep(fields: dict) -> None:
    """Draw the pool and write it to its cache file."""
    path = _path(fields)
    samples = _draw(fields)
    os.makedirs(CACHE, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, count=len(samples),
             **{f"{i}.{k}": s[k] for i, s in enumerate(samples) for k in KEYS})
    os.replace(tmp, path)


def _cached(traffic: dict) -> List[Dict[str, np.ndarray]]:
    """``_draw(traffic)``, read from the checkout's pool cache, which a
    child process fills first where no earlier run did."""
    fields = {k: traffic[k] for k in FIELDS if k in traffic}
    path = _path(fields)
    if not os.path.exists(path):
        subprocess.run([sys.executable, "-m", "benchmark.benchlib.pool",
                        json.dumps(fields)], cwd=ROOT, check=True)
    with np.load(path) as z:
        n = int(z["count"])
        return [{k: z[f"{i}.{k}"] for k in KEYS} for i in range(n)]


def mesh_pool(traffic: dict) -> List[Dict]:
    """[{"radius", "sample", "senders", "receivers", "n", "e"}] in pool
    order; ``sample`` is the mesh-order graph sample."""
    samples = _cached(traffic)
    radii = [r for r in traffic["radii"]
             for _ in range(traffic["meshes_per_radius"]
                            * traffic.get("rhs_per_mesh", 1))]
    return [dict(radius=r, sample=s, senders=s["senders"],
                 receivers=s["receivers"], n=int(s["x"].shape[0]),
                 e=int(np.count_nonzero(s["senders"] != s["receivers"])))
            for r, s in zip(radii, samples)]


def request_order(n: int, seed: int) -> Callable[[int], int]:
    """``order(k)``: the pool index of the k-th request of the window, a
    fresh permutation of the ``n`` pool entries each cycle."""
    rng = _rng(seed)
    perms: List[np.ndarray] = []

    def order(k: int) -> int:
        while len(perms) <= k // n:
            perms.append(rng.permutation(n))
        return int(perms[k // n][k % n])

    return order


if __name__ == "__main__":
    _keep(json.loads(sys.argv[1]))
