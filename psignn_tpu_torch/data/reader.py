"""Datasets and FEM samples → graph samples and batches of all three model
families.

Port of ``psignn_tpu/data/reader.py``: ``REF_STATS``,
``psignn_sample_from_fem``, ``dss_sample_from_fem``, ``load_dataset`` of a
reference-format ``.npy`` directory, the 60/20/20 ``split_dataset``, a
``GraphLoader`` of concatenated ``Graph`` batches and ``prefetch``, which
builds a loader's next batches on a background thread.

* ``family='psignn'|'dsgps'``: the full system A (diagonal included) with
  x/b/sol/prb_data/tags/pos/edge_attr/a_ij; the mixed variant adds the
  normalised ``unit_normal_vector`` and 3-column one-hot ``tags``, and its
  split is shuffled by ``np.random.RandomState(seed)`` as the JAX
  package's is.
* ``family='dss'`` (Dirichlet only): the off-diagonal system A′ and the
  BC-encoded b′ of ``dss_system``, with the reference reader's quirks
  kept: ``x = sol``, ``b = 0``, two zero columns of ``prb_data``, zero
  ``edge_attr``; its split is ordered train | test | val.

The port needs no padding caps (PyTorch runs eagerly), and the loader
keeps the JAX loader's shuffle, ``np.random.RandomState(seed + epoch)``, so
both packages see the same batches; ``stacked=True`` pads a short last
batch by cyclic repetition of its samples, as the JAX loader's stacked
batches are padded (``reader.py:358-377``).  ``dtype="bfloat16"`` (the
``precision`` of ``load_dataset``) gives the JAX loader's bfloat16
samples, carried as float32 (``_caster``).  ``n_devices`` > 1 with
``rank`` gives one data-parallel rank its shard of every batch, dealt as
the JAX loader's ``_build_sharded`` deals it (``shard_samples``): every
rank shuffles with the same seed and rank d's shard is JAX's shard d.
``rcm`` (each sample in reverse Cuthill-McKee order) and
``cache_batches`` (every batch built once, kept on the device, its
membership frozen) are the JAX loader's options of the same names.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from .. import resolve_device
from ..graphs import Graph, batch_graphs

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


def _caster(dtype):
    """(cast, full): ``cast(a)`` is ``np.asarray(a, dtype)``, and ``full``
    the dtype of the fields the JAX loader keeps in float32 whatever its
    dtype (the matrix values of ``_coo``, JAX ``reader.py:64-66``).  For
    ``dtype="bfloat16"`` (JAX's ``--precision bfloat16``) ``cast`` rounds to
    bfloat16 through float32, as ml_dtypes' cast does, and holds the result
    as float32, which JAX's ``batch_graphs`` widens it back to."""
    if isinstance(dtype, str) and dtype == "bfloat16":
        def cast(a):
            t = torch.from_numpy(np.asarray(a, np.float32))
            return t.to(torch.bfloat16).float().numpy()
        return cast, np.float32
    return (lambda a: np.asarray(a, dtype)), dtype


def _psignn_sample(A, b, sol, prb_data, tags, coordinates, distance,
                   stats: Dict[str, np.ndarray], dtype,
                   normals=None) -> GraphSample:
    """COO edges over the nonzeros of A (``A[senders, receivers] = a_ij``),
    normalised problem data and edge distances, and the initial condition
    x = 0 inside, x = b on Dirichlet nodes (reader.py:107-116); with
    ``normals``, the normalised ``unit_normal_vector`` of the mixed
    variant."""
    cast, full = _caster(dtype)
    c = sp.find(A)
    b = cast(b).reshape(-1, 1)
    sol = cast(sol).reshape(-1, 1)
    tags = cast(tags).reshape(len(sol), -1)
    x = np.zeros_like(sol)
    bnd = tags[:, 0] == 1 if tags.shape[1] == 1 else tags[:, 1] == 1
    x[bnd] = b[bnd]
    out = dict(
        x=x, b=b, sol=sol,
        prb_data=cast((np.asarray(prb_data) - stats["prb_mean"])
                      / stats["prb_std"]),
        tags=tags, pos=cast(coordinates),
        senders=c[0].astype(np.int32), receivers=c[1].astype(np.int32),
        a_ij=c[2].reshape(-1, 1).astype(full),
        edge_attr=cast((np.asarray(distance) - stats["dist_mean"])
                       / stats["dist_std"]))
    if normals is not None:
        out["unit_normal_vector"] = cast(
            (np.asarray(normals) - stats["normal_mean"])
            / stats["normal_std"])
    return out


def _reference_stats(variant: str = "dirichlet") -> Dict[str, np.ndarray]:
    return {k: np.array(v) for k, v in REF_STATS[(variant, "psignn")].items()}


def _dss_reference_stats() -> Dict[str, object]:
    # the a_ij statistics stay Python floats, so that (v − mean) / std is
    # computed in v's f32 as the JAX reader computes it
    st = REF_STATS[("dirichlet", "dss")]
    return dict(aij_mean=st["aij_mean"], aij_std=st["aij_std"],
                bprime_mean=np.array(st["bprime_mean"]),
                bprime_std=np.array(st["bprime_std"]))


def dss_system(A, b) -> tuple:
    """(A′, b′) of DSS's BC encoding (reference ``generate_data.py:100-143``).

    The Dirichlet rows are the rows of A holding an entry exactly 1.  A′ is
    A without its diagonal, as CSR with sorted indices and no stored zeros;
    b′ = [b·(1−d), d, b·d] per node, d the Dirichlet flag, in b's precision
    or wider.  Built sparsely: the JAX package goes through a dense copy of
    A (N² · 8 bytes), and gets the same arrays."""
    rows, cols, vals = sp.find(A)
    dirichlet = np.unique(rows[vals == 1])
    off = rows != cols
    a_prime = sp.csr_matrix((vals[off], (rows[off], cols[off])),
                            shape=A.shape)
    a_prime.sort_indices()
    b = np.asarray(b).reshape(-1)
    bp = np.c_[b, np.zeros(len(b)), np.zeros(len(b))]
    bp[dirichlet, 2] = bp[dirichlet, 0]
    bp[dirichlet, 1] = 1.0
    bp[dirichlet, 0] = 0.0
    return a_prime, bp


def _dss_sample(a_prime, b_prime, sol, tags, coordinates, stats, dtype
                ) -> GraphSample:
    """A DSS graph sample: COO edges over the nonzeros of A′, the 1-wide
    normalised ``a_ij_norm`` they carry into message passing, b′ and its
    normalised form (dss reader.py:89-93)."""
    cast, full = _caster(dtype)
    c = sp.find(a_prime)
    v = c[2].astype(full)
    sol = cast(sol).reshape(-1, 1)
    bp = cast(b_prime)
    return dict(
        x=sol, b=np.zeros_like(sol), sol=sol,
        prb_data=np.zeros((len(sol), 2), full),
        tags=cast(tags).reshape(len(sol), -1),
        pos=cast(coordinates),
        senders=c[0].astype(np.int32), receivers=c[1].astype(np.int32),
        a_ij=v.reshape(-1, 1),
        a_ij_norm=cast(((v - stats["aij_mean"]) / stats["aij_std"]
                        ).reshape(-1, 1)),
        b_prime=bp,
        b_prime_norm=cast((bp - stats["bprime_mean"]) / stats["bprime_std"]),
        edge_attr=np.zeros((len(c[0]), 3), full))


def dss_sample_from_fem(s: Dict[str, np.ndarray],
                        dtype=np.float32) -> GraphSample:
    """One ``data.fem.solve_poisson`` output → a DSS graph sample (A′ and
    b′ of ``dss_system`` from the f32 right-hand side), normalised with the
    reference statistics."""
    a_prime, bp = dss_system(s["A"], np.asarray(s["b"], dtype))
    return _dss_sample(a_prime, bp, s["sol"], s["tags"], s["coordinates"],
                       _dss_reference_stats(), dtype)


def psignn_sample_from_fem(s: Dict[str, np.ndarray],
                           variant: str = "dirichlet",
                           dtype=np.float32) -> GraphSample:
    """One ``data.fem.solve_poisson`` (or, with ``variant='mixed'``,
    ``solve_poisson_mixed``) output → a Ψ-GNN graph sample, normalised
    with the reference statistics.  The mixed sample also carries the
    normals, which the JAX package's on-the-fly form leaves out."""
    return _psignn_sample(s["A"], s["b"], s["sol"], s["prb_data"], s["tags"],
                          s["coordinates"], s["distance"],
                          _reference_stats(variant), dtype,
                          s["unit_normal_vector"] if variant == "mixed"
                          else None)


def _load(path_data: str, name: str) -> np.ndarray:
    return np.load(os.path.join(path_data, name + ".npy"), allow_pickle=True)


def load_dataset(path_data: str, family: str = "psignn",
                 variant: str = "dirichlet", stats: str = "reference",
                 dtype=np.float32,
                 precision: str = "float32") -> List[GraphSample]:
    """Every sample of a reference-format data directory as a graph sample.

    ``stats='reference'`` normalises with ``REF_STATS``; ``'auto'`` with
    the mean and std of the loaded data (edge offsets stay centred).  The
    mixed variant also reads ``unit_normal_vector.npy``; the DSS family
    reads ``A_prime.npy`` and ``b_prime.npy`` (``generate.add_dss_variable``)
    instead of the full system.  ``precision="bfloat16"`` gives the JAX
    loader's ``dtype=bfloat16`` samples (``--precision bfloat16``, JAX
    ``cli/main.py:195-201``), held as float32 (``_caster``): the model's
    arithmetic stays float32, as JAX's float32 parameters promote it."""
    _check(family, variant)
    if stats not in ("reference", "auto"):
        raise ValueError(f"stats must be 'reference' or 'auto', not {stats!r}")
    if precision not in ("float32", "bfloat16"):
        raise ValueError(f"precision must be 'float32' or 'bfloat16', not "
                         f"{precision!r}")
    if precision == "bfloat16":
        dtype = "bfloat16"
    if family == "dss":
        return _load_dss(path_data, stats, dtype)
    keys = ["A_sparse_matrix", "b_matrix", "sol", "prb_data", "tags",
            "coordinates", "distance"]
    if variant == "mixed":
        keys.append("unit_normal_vector")
    arrays = {k: _load(path_data, k) for k in keys}
    if stats == "reference":
        st = _reference_stats(variant)
    else:
        st = {}
        for key, name in (("prb_data", "prb"), ("distance", "dist"),
                          ("unit_normal_vector", "normal")):
            if key in arrays:
                stacked = np.vstack(arrays[key])
                st[name + "_mean"] = stacked.mean(axis=0)
                st[name + "_std"] = stacked.std(axis=0)
        st["dist_mean"][0] = st["dist_mean"][1] = 0.0
    return [_psignn_sample(*(arrays[k][i] for k in keys[:7]), stats=st,
                           dtype=dtype,
                           normals=(arrays["unit_normal_vector"][i]
                                    if variant == "mixed" else None))
            for i in range(len(arrays["A_sparse_matrix"]))]


def _load_dss(path_data: str, stats: str, dtype) -> List[GraphSample]:
    arrays = {k: _load(path_data, k) for k in
              ("A_prime", "b_prime", "sol", "tags", "coordinates")}
    if stats == "reference":
        st = _dss_reference_stats()
    else:
        aij = np.hstack([sp.find(a)[2] for a in arrays["A_prime"]])
        bp = np.vstack(arrays["b_prime"])
        st = dict(aij_mean=aij.mean(), aij_std=aij.std(),
                  bprime_mean=bp.mean(axis=0), bprime_std=bp.std(axis=0))
    return [_dss_sample(*(arrays[k][i] for k in arrays), stats=st,
                        dtype=dtype)
            for i in range(len(arrays["A_prime"]))]


FAMILIES = ("psignn", "dsgps", "dss")


def _check(family: str, variant: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, not {family!r}")
    if variant not in ("dirichlet", "mixed"):
        raise ValueError(f"variant must be 'dirichlet' or 'mixed', "
                         f"not {variant!r}")
    if family == "dss" and variant != "dirichlet":
        raise ValueError("the DSS family has a Dirichlet variant only")


def split_dataset(samples: Sequence, family: str = "psignn",
                  variant: str = "dirichlet", seed: int = 1234):
    """(train, val, test), 60/20/20: ordered [0:.6 | .6:.8 | .8:1] in the
    Dirichlet variant (reader.py:120-121), shuffled first by
    ``np.random.RandomState(seed)`` in the mixed one (mixed reader.py:128-129
    splits with ``shuffle=True``).  DSS orders train | test | val: its val
    is the last part and its test the middle one (dss reader.py:97-98)."""
    _check(family, variant)
    n = len(samples)
    idx = np.arange(n)
    if variant == "mixed":
        np.random.RandomState(seed).shuffle(idx)
    n_test = int(n * 0.2)
    n_val = int((n - n_test) * 0.25)
    n_train = n - n_test - n_val
    picked = [samples[i] for i in idx]
    train, mid, last = (picked[:n_train], picked[n_train:n_train + n_val],
                        picked[n_train + n_val:])
    return (train, last, mid) if family == "dss" else (train, mid, last)


def _empty_sample(template: GraphSample) -> GraphSample:
    """A zero-node, zero-edge sample with the template's field widths."""
    return {k: np.zeros((0,) + np.asarray(v).shape[1:], np.asarray(v).dtype)
            for k, v in template.items()}


def shard_samples(chunk: Sequence[GraphSample], batch_size: int,
                  n_devices: int) -> List[List[GraphSample]]:
    """One batch's samples dealt over ``n_devices`` data-parallel ranks as
    JAX's ``GraphLoader._build_sharded`` deals them (``reader.py:
    379-409``): a chunk shorter than ``n_devices`` is first repeated
    cyclically; then it is padded with empty samples to
    ``ceil(batch_size / n)·n`` and dealt round-robin, so every shard holds
    at least one real sample (its losses are means over its own nodes) and
    no sample is dropped."""
    target = -(-batch_size // n_devices) * n_devices
    chunk = list(chunk)
    if len(chunk) < n_devices:
        chunk = [chunk[i % len(chunk)] for i in range(n_devices)]
    chunk += [_empty_sample(chunk[0])] * (target - len(chunk))
    return [chunk[d::n_devices] for d in range(n_devices)]


@dataclasses.dataclass
class GraphLoader:
    """Minibatches of concatenated ``Graph``s on ``device`` (default:
    ``default_device()``).  With ``shuffle``, epoch k deals the samples in
    the order of ``np.random.RandomState(seed + k)``.  With ``stacked``
    (batches for per-graph solves), a short last batch is filled up to
    ``batch_size`` graphs by repeating its own samples cyclically.  With
    ``n_devices`` > 1, each batch is rank ``rank``'s shard of it
    (``shard_samples``).

    As the JAX loader does (``reader.py:269-334``): ``rcm`` puts each
    sample's nodes in reverse Cuthill-McKee order once, at construction
    (``dist.partition.rcm_ordered``); ``cache_batches`` builds the batches
    of epoch 0 (shuffle seed ``seed``) on ``device`` at the first
    ``__iter__`` and keeps them, so batch membership is frozen after the
    first shuffle: epoch 0 yields them in build order, epoch k > 0 in the
    order of ``np.random.RandomState(seed + k).shuffle``.  Every epoch
    yields the stored graphs themselves; no batch is built or copied
    again."""

    samples: List[GraphSample]
    batch_size: int = 50
    shuffle: bool = False
    seed: int = 0
    drop_last: bool = False
    device: Optional[object] = None
    stacked: bool = False
    n_devices: int = 0
    rank: int = 0
    rcm: bool = False
    cache_batches: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._epoch = 0
        self._cached: Optional[List[Graph]] = None
        if self.n_devices > 1 and self.stacked:
            raise ValueError("stacked batches are not dealt over ranks "
                             "(JAX refuses --stacked_batch with data "
                             "parallelism)")
        if self.n_devices > 1 and not 0 <= self.rank < self.n_devices:
            raise ValueError(f"rank {self.rank} of {self.n_devices}")
        if self.rcm:
            from ..dist.partition import rcm_ordered
            self.samples = [rcm_ordered(s) for s in self.samples]

    def __len__(self):
        n = len(self.samples)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _deal(self, epoch: int) -> List[np.ndarray]:
        """The sample indices of each batch dealt by epoch ``epoch``'s
        shuffle."""
        order = np.arange(len(self.samples))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        out = [order[i:i + self.batch_size]
               for i in range(0, len(order), self.batch_size)]
        if self.drop_last and out and len(out[-1]) < self.batch_size:
            out.pop()
        if self.stacked and out and len(out[-1]) < self.batch_size:
            last = out[-1]
            out[-1] = last[np.arange(self.batch_size) % len(last)]
        return out

    def _cache_order(self, epoch: int, n: int) -> np.ndarray:
        """The order epoch ``epoch`` yields ``n`` cached batches in."""
        order = np.arange(n)
        if self.shuffle and epoch > 0:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        return order

    def batch_order(self, epoch: int) -> List[np.ndarray]:
        """The sample indices of each batch epoch ``epoch`` yields."""
        if not self.cache_batches:
            return self._deal(epoch)
        dealt = self._deal(0)
        return [dealt[i] for i in self._cache_order(epoch, len(dealt))]

    def _build(self, sel: np.ndarray) -> Graph:
        chunk = [self.samples[j] for j in sel]
        if self.n_devices > 1:
            chunk = shard_samples(chunk, self.batch_size,
                                  self.n_devices)[self.rank]
        return batch_graphs(chunk, device=self.device)

    def __iter__(self) -> Iterator[Graph]:
        epoch = self._epoch
        self._epoch += 1
        if not self.cache_batches:
            for sel in self._deal(epoch):
                yield self._build(sel)
            return
        if self._cached is None:
            self._cached = [self._build(sel) for sel in self._deal(0)]
        for i in self._cache_order(epoch, len(self._cached)):
            yield self._cached[i]


def prefetch(iterable, depth: int = 2):
    """Yield the items of ``iterable``, in order, from a background thread
    that runs up to ``depth`` items ahead (JAX ``reader.py:411-441``).

    Around a ``GraphLoader`` the thread runs the loader's own ``__iter__``,
    so the host packing and the host→device copy of batch k+1 overlap the
    solver's dispatch of batch k.  The copy goes on the thread's current
    stream, the device's default stream, which the consumer's kernels also
    use, so a batch is ready before any kernel that reads it.  The worker's
    exception is raised in the consumer after the items before it.  Closing
    the generator early (a consumer that stops, or fails) stops the worker,
    joins it (it ends once the item it is building is done) and drops the
    items it queued, so no device batch is left behind."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()
    err = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for x in iterable:
                if not put(x):
                    return
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        put(end)

    t = threading.Thread(target=worker, name="prefetch", daemon=True)
    t.start()
    try:
        while True:
            x = q.get()
            if x is end:
                break
            yield x
        if err:
            raise err[0]
    finally:
        stop.set()
        t.join()
        while not q.empty():
            q.get_nowait()
