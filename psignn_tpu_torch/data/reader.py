"""FEM sample → Ψ-GNN graph sample, with the reference normalisation.

Port of ``REF_STATS`` and ``psignn_sample_from_fem`` from
``psignn_tpu/data/reader.py``.  Loading ``.npy`` datasets, ``GraphLoader``
and the DSS sample form are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.sparse as sp

# Hard-coded reference statistics (psignn reader.py:73-77, dss
# reader.py:63-67, mixed reader.py:74-81 of the reference code base).
REF_STATS = {
    ("dirichlet", "psignn"): dict(
        prb_mean=[0.0464, -0.0006], prb_std=[9.6267, 3.2935],
        dist_mean=[0.0, 0.0, 0.0655], dist_std=[0.0507, 0.0507, 0.0293],
    ),
    ("dirichlet", "dss"): dict(
        aij_mean=-0.5838, aij_std=0.0924,
        bprime_mean=[0.0002, 0.1435, -0.0006],
        bprime_std=[0.0507, 0.3506, 3.2935],
    ),
    ("mixed", "psignn"): dict(
        prb_mean=[-0.4319, 0.0289, -0.0189], prb_std=[8.4245, 2.1942, 2.8585],
        dist_mean=[0.0, 0.0, 0.0572], dist_std=[0.0445, 0.0443, 0.0258],
        normal_mean=[0.0007, -0.0004], normal_std=[0.2773, 0.2959],
    ),
}
REF_STATS[("dirichlet", "dsgps")] = REF_STATS[("dirichlet", "psignn")]
REF_STATS[("mixed", "dsgps")] = REF_STATS[("mixed", "psignn")]

GraphSample = Dict[str, np.ndarray]


def psignn_sample_from_fem(s: Dict[str, np.ndarray],
                           variant: str = "dirichlet",
                           dtype=np.float32) -> GraphSample:
    """One ``data.fem.solve_poisson`` output → a Ψ-GNN graph sample: COO
    edges over the nonzeros of A (``A[senders, receivers] = a_ij``),
    normalised problem data and edge distances, and the initial condition
    x = 0 inside, x = b on Dirichlet nodes."""
    st = REF_STATS[(variant, "psignn")]
    prb_mean = np.array(st["prb_mean"])
    prb_std = np.array(st["prb_std"])
    dist_mean = np.array(st["dist_mean"])
    dist_std = np.array(st["dist_std"])
    c = sp.find(s["A"])
    b = np.asarray(s["b"], dtype).reshape(-1, 1)
    sol = np.asarray(s["sol"], dtype).reshape(-1, 1)
    tags = np.asarray(s["tags"], dtype).reshape(len(sol), -1)
    x = np.zeros_like(sol)
    bnd = tags[:, 0] == 1 if tags.shape[1] == 1 else tags[:, 1] == 1
    x[bnd] = b[bnd]
    return dict(
        x=x, b=b, sol=sol,
        prb_data=((s["prb_data"] - prb_mean) / prb_std).astype(dtype),
        tags=tags, pos=np.asarray(s["coordinates"], dtype),
        senders=c[0].astype(np.int32), receivers=c[1].astype(np.int32),
        a_ij=c[2].reshape(-1, 1).astype(dtype),
        edge_attr=((s["distance"] - dist_mean) / dist_std).astype(dtype))
