"""Plain reference of a Ψ-GNN request (Dirichlet): the encoder, the
update function f_θ, the decoder, and a plain Broyden solve of the fixed
point, in PyTorch over the checkpoint's JAX-layout parameters.

The benchmark judges each sampled request by what the program returned:
its latent fixed point z* (the decoder's input), its decoded u, and the
residual it reports.  ``judge`` recomputes, from the mesh-order sample
and the checkpoint alone,

* ``residual``: ‖f(z*) − z*‖ / (‖f(z*)‖ + 1e-9), the solver's own stop
  measure, of the program's z* under the reference's f_θ and encoding;
* ``residual_gap``: |that − the residual the program reports|;
* ``decode_gap``: max |u − decoder(z*)| / max |decoder(z*)|.

``aggregate`` holds every judged request's residual, in two classes by
the mesh's size (the configuration's ``judge.converged_below_nodes``):
``converged_residual``, the worst of the meshes that a sound solve brings
to ``fw_tol`` within ``fw_thres`` steps, and ``worst_residual``, the worst
of all, which the large meshes set where they run out of their steps; and
the worst request's gaps.

A fixed-point solve is judged by its residual and not by a second solve's
answer: Broyden's path is chaotic, and two sound solves of one radius-5
mesh can stop at answers some percent apart.  ``solve`` (plain Broyden,
the reference code base's algorithm) is the control: the reference put
in the program's place.

A training run is judged the same way (``judge_steps``): the reference
follows the program's first steps from the checkpoint at the program's
own h* of each step, measures its residual, and works out the loss, the
adjoint solve's gradient and both Adams from there.  ``solve_steps``,
which solves each step's fixed point itself, is the training control.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .common import (Edges, layer_norm, linear, message_passing, mlp,
                     node_tensors, to_device)


class Model:
    """The checkpoint's Ψ-GNN, on ``device``."""

    def __init__(self, params, device, precision: str = "f32"):
        self.p = to_device(params, device)
        self.device = device
        self.precision = precision

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self.p["autoencoder"]["encoder"], x, self.precision)

    def decode(self, h: torch.Tensor) -> torch.Tensor:
        return mlp(self.p["autoencoder"]["decoder"], h, self.precision)

    def f(self, h: torch.Tensor, h0: torch.Tensor, prb: torch.Tensor,
          dmask: torch.Tensor, edges: Edges) -> torch.Tensor:
        fn, pr = self.p["function"], self.precision
        last = len(fn["layers"]) - 1
        for k, layer in enumerate(fn["layers"]):
            mp_to = message_passing(layer["phi_to"], h, edges, "to", pr)
            mp_from = message_passing(layer["phi_from"], h, edges, "from", pr)
            concat = torch.cat([h, mp_to, mp_from, prb], -1)
            alpha = torch.sigmoid(linear(fn["alpha"], concat, pr))
            h_next = h + alpha * mlp(layer["update"], concat, pr)
            if k == last:
                h_next = layer_norm(fn["laynorm"], h_next)
            h = torch.where(dmask > 0, h0, h_next)
        return h


def _rel(g: torch.Tensor, fx: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(g)
                 / (torch.linalg.vector_norm(fx) + 1e-9))


def judge(model: Model, sample: Dict[str, np.ndarray], answer: dict,
          cfg: dict) -> Dict[str, float]:
    """The three numbers of one request; ``answer`` holds the program's
    ``z`` (N, D) and ``u`` (N,) in mesh order and the residual it
    ``reported``."""
    dev, z, u = model.device, answer["z"], answer["u"]
    reported = answer["reported"]
    with torch.no_grad():
        x, prb, dmask = node_tensors(sample, dev)
        edges = Edges(sample, dev)
        h0 = model.encode(x)
        zt = torch.as_tensor(np.asarray(z, np.float32), device=dev)
        fz = model.f(zt, h0, prb, dmask, edges)
        res = _rel(fz - zt, fz)
        u_ref = model.decode(zt)[:, 0].cpu().numpy().astype(np.float64)
    scale = max(float(np.max(np.abs(u_ref))), 1e-6)
    return dict(nodes=int(zt.shape[0]), residual=res,
                residual_gap=abs(res - float(reported)),
                decode_gap=float(np.max(np.abs(np.asarray(u, np.float64)
                                               - u_ref)) / scale))


def aggregate(per_request: List[Dict[str, float]], config: dict
              ) -> Dict[str, float]:
    """The cell's numbers from the judged requests' numbers."""
    def worst(rows, k):
        v = [r[k] for r in rows]
        return float("nan") if any(np.isnan(v)) else max(v)
    small = config["judge"]["converged_below_nodes"]
    converged = [r for r in per_request if r["nodes"] < small]
    out = {"converged_residual": worst(converged, "residual")} \
        if converged else {}
    out.update(worst_residual=worst(per_request, "residual"),
               residual_gap=worst(per_request, "residual_gap"),
               decode_gap=worst(per_request, "decode_gap"))
    return out


def broyden(g, x0: torch.Tensor, threshold: int, eps: float
            ) -> Tuple[torch.Tensor, float, int]:
    """Plain Broyden on g(x) = 0 from x0 (flat), the reference code base's
    ``broyden`` without line search: relative stop measure, best iterate,
    plateau break and divergence guard.  Returns (best x, its residual,
    its step)."""
    d = x0.numel()
    Us = torch.zeros(threshold, d, device=x0.device)
    VTs = torch.zeros(threshold, d, device=x0.device)

    def matvec(k, v):         # (-I + Σ u vᵀ) v
        return -v + Us[:k].T @ (VTs[:k] @ v) if k else -v

    def rmatvec(k, v):        # vᵀ (-I + Σ u vᵀ)
        return -v + VTs[:k].T @ (Us[:k] @ v) if k else -v

    x = x0.clone()
    gx = g(x)
    update = -matvec(0, gx)
    lowest, lowest_x, lowest_step = float("inf"), x, 0
    trace: List[float] = []
    nstep = 0
    while nstep < threshold:
        x_new = x + update
        gx_new = g(x_new)
        dx, dgx = x_new - x, gx_new - gx
        x, gx = x_new, gx_new
        nstep += 1
        rel = _rel(gx, gx + x)
        trace.append(rel)
        if rel < lowest:
            lowest, lowest_x, lowest_step = rel, x.clone(), nstep
        if rel < eps:
            break
        window = trace[-30:]
        if rel < 3 * eps and nstep > 30 and max(window) / min(window) < 1.3:
            break
        if rel > trace[0] * 1e3:
            break
        k = nstep - 1
        vT = rmatvec(k, dx)
        u = (dx - matvec(k, dgx)) / torch.dot(vT, dgx)
        VTs[k] = torch.nan_to_num(vT, nan=0.0)
        Us[k] = torch.nan_to_num(u, nan=0.0)
        update = -matvec(k + 1, gx)
    return lowest_x, lowest, lowest_step


def solve(model: Model, sample: Dict[str, np.ndarray], fw_tol: float,
          fw_thres: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """A request answered by the reference itself: (z*, u, residual) in
    mesh order, as the program answers it."""
    dev = model.device
    with torch.no_grad():
        x, prb, dmask = node_tensors(sample, dev)
        edges = Edges(sample, dev)
        h0 = model.encode(x)
        shape = h0.shape

        def g(v):
            h = v.reshape(shape)
            return (model.f(h, h0, prb, dmask, edges) - h).reshape(-1)

        z, res, _ = broyden(g, h0.reshape(-1), fw_thres, fw_tol)
        z = z.reshape(shape)
        u = model.decode(z)[:, 0]
    return z.cpu().numpy(), u.cpu().numpy(), res


def request_flops(cfg: dict, n: int, e: int, fw_calls: int,
                  mp_flops) -> float:
    """Model operations of one request: ``fw_calls`` evaluations of f_θ
    (per layer two message passings at ``mp_flops(n, e)`` and the node
    MLPs, the gate and the LayerNorm), the encoder and the decoder."""
    D, P = cfg["latent_dim"], 2
    c = 3 * D + P
    node = (2 * c * 1 + 4              # alpha linear, sigmoid
            + 2 * c * D + 2 * D * D + D  # update MLP and its ReLU
            + 3 * D)                   # h + α·update, Dirichlet reset
    f_call = cfg["n_layers"] * (2 * mp_flops(n, e) + n * node) + n * 8 * D
    autoenc = n * (2 * 1 * D + D + 2 * D * D) + n * (2 * D * D + D + 2 * D)
    return fw_calls * f_call + autoenc


# ----------------------------------------------------------------- training

class Batch:
    """Samples concatenated as the program's batch is (same order, node
    offsets added), as the reference's own tensors."""

    def __init__(self, samples, device):
        cat = np.concatenate
        n = [int(np.asarray(s["x"]).shape[0]) for s in samples]
        off = np.concatenate([[0], np.cumsum(n)[:-1]])
        snd = cat([np.asarray(s["senders"], np.int64) + o
                   for s, o in zip(samples, off)])
        rcv = cat([np.asarray(s["receivers"], np.int64) + o
                   for s, o in zip(samples, off)])
        merged = dict(
            x=cat([np.asarray(s["x"], np.float32) for s in samples]),
            prb_data=cat([np.asarray(s["prb_data"], np.float32)
                          for s in samples]),
            tags=cat([np.asarray(s["tags"], np.float32) for s in samples]),
            senders=snd, receivers=rcv,
            edge_attr=cat([np.asarray(s["edge_attr"], np.float32)
                           for s in samples]))
        self.x, self.prb, self.dmask = node_tensors(merged, device)
        self.edges = Edges(merged, device)
        self.b = torch.as_tensor(cat([np.asarray(s["b"], np.float32)
                                      for s in samples]), device=device)
        self.a_ij = torch.as_tensor(cat([np.asarray(s["a_ij"], np.float32)
                                         for s in samples]), device=device)
        self.snd = torch.as_tensor(snd, device=device)
        self.rcv = torch.as_tensor(rcv, device=device)
        self.n = int(sum(n))

    def spmv(self, u: torch.Tensor) -> torch.Tensor:
        """A u over every nonzero, the diagonal included."""
        out = torch.zeros_like(u)
        return out.index_add_(0, self.snd, self.a_ij * u[self.rcv])


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"function/layers/0/phi_to/0/w": tensor, ...} of a parameter tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def with_leaves(tree, values: Dict[str, torch.Tensor], prefix: str = ""):
    """``tree`` with each leaf replaced by the one ``values`` has at its
    path (the names of ``leaves``)."""
    if isinstance(tree, dict):
        return {k: with_leaves(v, values, f"{prefix}/{k}" if prefix
                               else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [with_leaves(v, values, f"{prefix}/{k}" if prefix else str(k))
                for k, v in enumerate(tree)]
    return values[prefix]


def _adam(params, grads, state, lr, t, b1=0.9, b2=0.999, eps=1e-8):
    """torch.optim.Adam's step, written out."""
    for k, p in params.items():
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        g = grads[k]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / np.sqrt(1 - b2 ** t)) + eps
        p.data.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def _steps(model: Model, batches, probes, cfg: dict, tcfg: dict,
           equilibrium, measured_under=None) -> dict:
    """The program's first training steps followed from the checkpoint.
    Each step takes its forward fixed point z from ``equilibrium(t,
    g_fw, h0)``, measures its residual ‖f(z) − z‖ / (‖f(z)‖ + 1e-9) by
    the reference's f_θ and encoding under the parameters
    ``measured_under[t − 1]`` (by leaf; without it, its own), runs one
    tracked f_θ at z whose incoming gradient g is replaced by the
    solution y of y = Jᵀy + g
    (plain Broyden, ``bw_tol`` / ``bw_thres``: a linear system), and takes
    the loss = residual + jac_weight · ‖vᵀJ‖²/size at z (the probe ``v``
    of ``probes(step, shape)``) + encoder + autoencoder, the joint clip
    and the two Adams (function; encoder and decoder).  Returns the
    losses, the residuals, each step's z and its parameters at the start
    (``starts``), the clipped first gradient and the parameters before and
    after the steps, by leaf."""
    params = leaves(model.p)
    for p in params.values():
        p.requires_grad_(True)
    state: Dict[str, tuple] = {}
    losses, residuals, zs, starts, first_grad = [], [], [], [], None
    for t, batch in enumerate(batches, start=1):
        starts.append({k: p.detach().clone() for k, p in params.items()})
        h_init = model.encode(batch.x)
        shape = h_init.shape
        h0 = h_init.detach()

        def g_fw(v):
            h = v.reshape(shape)
            return (model.f(h, h0, batch.prb, batch.dmask, batch.edges)
                    - h).reshape(-1)

        with torch.no_grad():
            z = equilibrium(t, g_fw, h0).reshape(shape)
            m = model if measured_under is None else Model(
                with_leaves(model.p, measured_under[t - 1]), model.device,
                model.precision)
            fz = m.f(z, m.encode(batch.x), batch.prb, batch.dmask,
                     batch.edges)
            residuals.append(_rel(fz - z, fz))
        zs.append(z)
        h = z.detach().requires_grad_()
        new_h = model.f(h, h_init, batch.prb, batch.dmask, batch.edges)

        def adjoint(grad):
            handle.remove()            # the VJPs below start at new_h too

            def g_bw(y):
                return torch.autograd.grad(new_h, h, y.reshape(shape),
                                           retain_graph=True)[0].reshape(-1) \
                    + grad.reshape(-1) - y
            with torch.no_grad():      # no graph of the VJPs themselves
                y, _, _ = broyden(g_bw, torch.zeros_like(grad).reshape(-1),
                                  cfg["bw_thres"], cfg["bw_tol"])
            return y.reshape(shape)

        handle = new_h.register_hook(adjoint)
        u = model.decode(new_h)
        res = torch.mean(torch.square(batch.spmv(u) - batch.b))
        hj = z.detach().requires_grad_()
        out = model.f(hj, h0, batch.prb, batch.dmask, batch.edges)
        (vj,) = torch.autograd.grad(out, hj, probes(t, shape),
                                    create_graph=True)
        jac = torch.sum(torch.square(vj)) / hj.numel()
        u_det, h_det = u.detach(), new_h.detach()
        enc = torch.mean(torch.square(model.encode(u_det) - h_det))
        auto = torch.mean(torch.square(
            model.decode(model.encode(u_det).detach()) - u_det))
        loss = res + tcfg["jac_weight"] * jac + enc + auto
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(p)).detach()
                 for (k, p), g in zip(params.items(), grads)}
        total = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        coef = tcfg["gradient_clip"] / (float(total) + 1e-6)
        if coef < 1:
            grads = {k: g * coef for k, g in grads.items()}
        if first_grad is None:
            first_grad = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            for group, lr in (("function", tcfg["lr_deq"]),
                              ("autoencoder", tcfg["lr_ae"])):
                sel = {k: p for k, p in params.items()
                       if k.startswith(group + "/")}
                _adam(sel, grads, state, lr, t)
        losses.append(float(loss.detach()))
    after = {k: p.detach().clone() for k, p in params.items()}
    return dict(losses=losses, residuals=residuals, h_stars=zs,
                starts=starts, grad=first_grad, before=starts[0], after=after)


def judge_steps(model: Model, batches, h_stars, starts, probes, cfg: dict,
                tcfg: dict) -> dict:
    """The steps of ``_steps`` at the side's own equilibria: step t takes
    ``h_stars[t − 1]`` (the side's h* of that step, in the batch's node
    order) and solves no forward fixed point.  A second solve is no
    yardstick: Broyden is chaotic, and where the reference's solve ended
    elsewhere than the program's, every later number followed it.  Each
    h*'s residual is measured under the side's own parameters at the
    start of its step (``starts``, by leaf): the f_θ whose fixed point
    the side solved.  The reference's own parameters move on by its own
    Adams, and ``change_gap`` judges where they end."""
    dev = model.device
    return _steps(model, batches, probes, cfg, tcfg,
                  lambda t, _g, _h0: torch.as_tensor(h_stars[t - 1],
                                                     device=dev),
                  measured_under=starts)


def solve_steps(model: Model, batches, probes, cfg: dict, tcfg: dict
                ) -> dict:
    """The steps of ``_steps`` with each forward fixed point solved here
    by plain Broyden from the encoding (``fw_tol`` / ``fw_thres``): the
    reference in the program's place, as the control runs it."""
    def solve(_t, g_fw, h0):
        z, _, _ = broyden(g_fw, h0.reshape(-1), cfg["fw_thres"],
                          cfg["fw_tol"])
        return z

    return _steps(model, batches, probes, cfg, tcfg, solve)


def train_numbers(side: dict, ref: dict) -> Dict[str, float]:
    """A training run's first steps (``side``: ``losses``, the first
    ``grad`` and the ``change`` after the steps, by leaf) against the
    reference's at the side's own equilibria (``ref``: ``judge_steps``'s
    with the ``change``): ``train_residual``, the median step's residual
    of the side's h* by the reference's f_θ and encoding under the side's
    parameters of that step (the configured Broyden may end a sound solve
    above ``fw_tol``: on a plateau under 3 · ``fw_tol``, at ``fw_thres``
    or by its divergence guard, as the first step of two seeds in 39 did
    on the card; a stop changed from the first step on moves all three);
    ``first_loss_gap``, the first step's
    |L − L_ref| / |L_ref|; ``grad_gap`` and ``change_gap``, the worst
    leaf's gap between the two norms over the larger of the reference's
    norm of that leaf and of the median leaf.  Leaves whose reference
    gradient is under a thousandth of the median leaf's (moved by
    round-off alone) are left out."""
    def norms(tree):
        return {k: float(torch.linalg.vector_norm(v)) for k, v in
                tree.items()}

    def worst_leaf(a, r, keep):
        med = float(np.median([r[k] for k in keep]))
        return max(abs(a[k] - r[k]) / max(r[k], med) for k in keep)

    g, g_ref = norms(side["grad"]), norms(ref["grad"])
    g_med = float(np.median(list(g_ref.values())))
    keep = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]
    first, first_ref = side["losses"][0], ref["losses"][0]
    return {"train_residual": float(np.median(ref["residuals"])),
            "first_loss_gap": abs(first - first_ref) / abs(first_ref),
            "grad_gap": worst_leaf(g, g_ref, keep),
            "change_gap": worst_leaf(norms(side["change"]),
                                     norms(ref["change"]), keep)}
