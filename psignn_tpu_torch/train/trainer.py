"""Experiment runner: train and validation epochs, CSV logs, checkpoints.

Port of ``psignn_tpu/train/trainer.py`` for the three families, Dirichlet
or mixed (the model config's ``bc_mode``, with loaders of that variant), on
one device with one concatenated batch per step:

* Ψ-GNN: two Adams (update function, autoencoder) with their plateau
  schedulers (training_class.py:52-58), loss = residual +
  jac_weight·jacobian + encoder + autoencoder, and the LR-floor stop at
  1e-7 (training_class.py:291-294);
* DS-GPS and DSS: one Adam at ``lr`` over every parameter, loss = the
  model's ``train_loss``, no scheduler and no LR-floor stop
  (dsgps/training_class.py:49-51, 144);
* the joint global-norm clip (``train/step.py``);
* ``train_metrics.csv`` lines at 25/50/75 % of each epoch and at its end
  (a loss a family does not have reads 0),
  ``forward_iteration.csv`` / ``backward_iteration.csv`` (lowest, nstep of
  each Ψ-GNN step's two solves), ``spectral_radius.csv`` from the Ψ-GNN
  validation power method, ``model_config.csv``;
* running/best/final checkpoints keyed on the validation residual
  (training_class.py:296-333), ``--spike_guard`` and resume, from a
  checkpoint the port wrote or from one of the JAX package (its optax Adam
  state mapped onto torch's Adam, ``_adam_state_from_optax``);
* ``stacked_batch`` (Ψ-GNN): one DEQ solve per graph of each batch, losses
  averaged over the graphs (``psignn_forward_stacked``), in training and
  validation; the loaders should pad a short last batch as
  ``GraphLoader(stacked=True)`` does.  The iteration logs then hold each
  step's means over the graphs, as the JAX trainer writes them.

* both loops draw their batches through ``data.reader.prefetch``, as the
  JAX trainer's do (``trainer.py:345-346``, ``:385-388``): the next batch
  is packed and copied to the device while the step runs; each
  data-parallel rank prefetches its own shard.  Over a loader with
  ``cache_batches`` the thread yields the loader's stored graphs: no
  batch is built or copied again after the first epoch's, and no step
  writes into a batch's tensors.

* ``data_parallel``: one process a rank (``dist.multihost``; the CLI's
  ``--num_devices``), the loaders giving each rank its shard; the train
  steps and the validation losses are averaged over the ranks (JAX
  ``trainer.py:236-258``: validation drives the schedulers, early stopping
  and the best checkpoint), so every rank takes the same decisions and
  keeps the same parameters.  Only rank 0 writes logs and checkpoints.
  The Hutchinson probes come from a generator seeded from (seed, rank),
  as JAX folds the rank into its key.

* every ``plot_every`` epochs rank 0 draws ``track_losses.png`` and
  ``gradients.png`` into the logs (``train/plots.py``; JAX
  ``trainer.py:487-493``), the bars the ℓ2 norm of each parameter's
  clipped gradient from the epoch's last batch, named by its JAX tree
  path (``_last_grad_norms``).  Without matplotlib (the card's host) one
  line of ``train_metrics.csv`` says so and training goes on; JAX
  swallows every exception of its plots, the port only that one.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data.reader import prefetch
from ..dist.dp import make_mesh
from ..models.psignn import psignn_forward, psignn_forward_stacked
from ..weights import FAMILIES
from .checkpoint import (load_checkpoint, optimizer_state_from_numpy,
                         optimizer_state_to_numpy, save_checkpoint)
from .optim import PlateauScheduler, make_adam, make_optimizers
from .plots import plot_gradients, plot_losses
from .step import (psignn_loss, train_step, unrolled_forward,
                   unrolled_train_step)

LOSS_KEYS = ["loss", "residual_loss", "jacobian_loss", "encoder_loss",
             "autoencoder_loss", "mse_loss"]


@dataclasses.dataclass
class TrainConfig:
    family: str = "psignn"                  # 'psignn' | 'dsgps' | 'dss'
    model_cfg: Any = None
    max_epochs: int = 500
    lr: float = 0.01                        # dsgps/dss single optimizer
    lr_deq: float = 0.01
    lr_ae: float = 0.05
    sched_step_deq: float = 0.5
    sched_step_ae: float = 0.5
    gradient_clip: float = 0.1
    jac_weight: float = 1.0
    min_loss_save: float = 1e10
    path_results: str = "results/psignn_torch_run/"
    seed: int = 1234
    plot_every: int = 2
    val_sradius: bool = True
    lr_floor: float = 1e-7
    data_parallel: bool = False
    stacked_batch: bool = False
    # on a sustained validation-residual spike (> spike_factor × the best
    # for spike_patience epochs) reload the best checkpoint and halve the
    # effective learning rates (the JAX trainer's opt-in guard)
    spike_guard: bool = False
    spike_factor: float = 3.0
    spike_patience: int = 2
    device: Optional[str] = None     # default: the first CUDA device


class Trainer:

    def __init__(self, config: TrainConfig, loader_train, loader_val,
                 model: Optional[torch.nn.Module] = None):
        if config.family not in FAMILIES:
            raise ValueError(f"family must be one of {sorted(FAMILIES)}, "
                             f"not {config.family!r}")
        if config.data_parallel and config.stacked_batch:
            raise ValueError("stacked_batch is not data-parallel (JAX "
                             "refuses --stacked_batch with data parallelism)")
        if config.stacked_batch and config.family != "psignn":
            raise ValueError("stacked_batch solves Ψ-GNN's DEQ per graph; "
                             f"the {config.family} family has no solve")
        self.c = config
        self.loader_train = loader_train
        self.loader_val = loader_val
        self.family = config.family
        self.psignn = config.family == "psignn"
        model_cls, cfg_cls, self._from_jax, self._to_jax = \
            FAMILIES[config.family]
        self.mc = config.model_cfg or cfg_cls()
        self.device = resolve_device(config.device)
        # the data-parallel mesh of the world's ranks (one rank: None)
        self.mesh = (make_mesh(device=self.device) if config.data_parallel
                     else None)
        rank = self.mesh.rank if self.mesh else 0
        self.writer = rank == 0          # logs and checkpoints: rank 0 only

        self.path_ckpt = os.path.join(config.path_results, "ckpt")
        self.path_logs = os.path.join(config.path_results, "logs")
        if self.writer:
            os.makedirs(self.path_ckpt, exist_ok=True)
            os.makedirs(self.path_logs, exist_ok=True)
            self._init_log_files()

        if model is None:
            model = model_cls(
                self.mc, generator=torch.Generator().manual_seed(config.seed),
                device=self.device)
        self.model = model
        if self.psignn:
            self.opts = make_optimizers(model, config.lr_deq, config.lr_ae)
            self.sched_deq = PlateauScheduler(config.lr_deq,
                                              config.sched_step_deq)
            self.sched_ae = PlateauScheduler(config.lr_ae,
                                             config.sched_step_ae)
        else:
            self.opts = (make_adam(model, config.lr),)
        # the optimizers' names in a checkpoint's torch_optim
        self.opt_keys = ("deq", "ae") if self.psignn else ("adam",)

        self.hist_train = {k: [] for k in LOSS_KEYS}
        self.hist_val = {k: [] for k in LOSS_KEYS}
        self.min_loss_save = config.min_loss_save
        self.lr_scale = 1.0          # halved by the spike guard
        self._spike_count = 0
        self.training_time = 0.0
        self._last_grad_norms: Dict[str, float] = {}
        self._can_plot = True       # False once matplotlib was missing
        # Hutchinson and power-method probes, decorrelated over the ranks
        self.generator = torch.Generator().manual_seed(
            config.seed + 1 + 1_000_003 * rank)
        if self.writer:
            self._dump_model_config()

    # ------------------------------------------------------------------ setup

    def _log(self, name: str, text: str) -> None:
        if not self.writer:
            return
        with open(os.path.join(self.path_logs, name), "a") as f:
            f.write(text)

    def _init_log_files(self):
        for name, header in [("train_metrics.csv", "Train Metrics"),
                             ("forward_iteration.csv", "Residual \t Iterations"),
                             ("backward_iteration.csv", "Residual \t Iterations"),
                             ("spectral_radius.csv", "Spectral Radius")]:
            if not os.path.exists(os.path.join(self.path_logs, name)):
                self._log(name, header)

    def _dump_model_config(self):
        n_params = sum(p.numel() for p in self.model.parameters())
        with open(os.path.join(self.path_logs, "model_config.csv"), "w") as f:
            n_dev = self.mesh.world if self.mesh else 1
            f.write(f"Number of devices used : {n_dev} ({self.device}) \n\n")
            f.write("Includes {} train samples, {} val samples \n".format(
                len(self.loader_train.samples), len(self.loader_val.samples)))
            f.write(f"Batch size {self.loader_train.batch_size} \n\n")
            f.write("Model configuration : \n{\n")
            for fld in dataclasses.fields(self.mc):
                f.write(f"'{fld.name}':'{getattr(self.mc, fld.name)}'\n")
            f.write("}\n\nTraining configuration : \n{\n")
            for fld in dataclasses.fields(self.c):
                if fld.name == "model_cfg":
                    continue
                f.write(f"'{fld.name}':'{getattr(self.c, fld.name)}'\n")
            f.write("}\n\n")
            f.write(f"Number of parameters : {n_params} \n")

    # -------------------------------------------------------------- epoch ops

    def train_loop(self, epoch: int):
        c = self.c
        accum = {k: 0.0 for k in LOSS_KEYS}
        n_batches = len(self.loader_train)
        lrs = ((self.sched_deq.lr * self.lr_scale,
                self.sched_ae.lr * self.lr_scale) if self.psignn
               else (c.lr * self.lr_scale,))
        marks = {math.ceil(f * n_batches) for f in (0.25, 0.5, 0.75)}
        pending = []          # StepResults since the last log line

        def flush():
            for name, attr in (("forward_iteration.csv", "fw"),
                               ("backward_iteration.csv", "bw")):
                # a stacked step's per-graph stats log as their means
                self._log(name, "".join(
                    "\n{} \t {}".format(float(np.mean(s.lowest)),
                                         int(np.mean(s.nstep)))
                    for s in (getattr(r, attr) for r in pending)
                    if s is not None))
            sums = {k: sum(r.loss if k == "loss" else r.losses.get(k, 0.0)
                           for r in pending) for k in LOSS_KEYS}
            n = len(pending)
            pending.clear()
            return sums, n

        for i, graph in enumerate(prefetch(self.loader_train)):
            if self.psignn:
                res = train_step(self.model, self.opts, graph, self.mc, lrs,
                                 c.gradient_clip, c.jac_weight,
                                 self.generator, stacked=c.stacked_batch,
                                 mesh=self.mesh)
            else:
                res = unrolled_train_step(self.model, self.opts[0], graph,
                                          self.mc, lrs[0], c.gradient_clip,
                                          mesh=self.mesh)
            pending.append(res)
            if i in marks:
                run, cumul = flush()
                for k in LOSS_KEYS:
                    accum[k] += run[k]
                self._log("train_metrics.csv",
                          "\nEpoch {}, {:d}% \t Loss : {:.4e} \t Res : {:.4e}"
                          " \t Jac : {:.4e} \t Enc : {:.4e} \t AEnc : {:.4e}"
                          " \t MSE : {:.4e}".format(
                              epoch, int(i * 100 / n_batches),
                              *(run[k] / max(cumul, 1) for k in LOSS_KEYS)))
        run, _ = flush()
        for k in LOSS_KEYS:
            accum[k] += run[k]
            self.hist_train[k].append(accum[k] / n_batches)
        self._last_grad_norms = self._grad_norms()
        self._log("train_metrics.csv",
                  "\nTraining Epoch {} : \t Train : {:.5e} \t Res : {:.5e}"
                  " \t Jac : {:.5e} \t Enc : {:.5e} \t AE : {:.5e}"
                  " \t MSE : {:.5e}".format(
                      epoch, *(self.hist_train[k][-1] for k in LOSS_KEYS)))

    def validation_loop(self, epoch: int):
        n_batches = len(self.loader_val)
        vecs, srads = [], []
        for graph in prefetch(self.loader_val):
            with torch.no_grad():
                if self.psignn:
                    forward = (psignn_forward_stacked if self.c.stacked_batch
                               else psignn_forward)
                    out = forward(self.model, graph, self.mc, self.generator,
                                  training=not self.c.val_sradius)
                    loss = psignn_loss(out.losses, self.c.jac_weight)
                else:
                    out = unrolled_forward(self.model, graph, self.mc)
                    loss = out.losses["train_loss"]
            zero = torch.zeros_like(loss)
            vecs.append(torch.stack([loss] + [out.losses.get(k, zero)
                                              for k in LOSS_KEYS[1:]]))
            if self.psignn and self.c.val_sradius:
                srads.append(out.losses["sradius"])
        sums = torch.stack(vecs).sum(0)
        srads = torch.stack(srads) if srads else sums[:0]
        if self.mesh:           # the means over the ranks' shards
            both = self.mesh.all_reduce(torch.cat([sums, srads]))
            both = both / self.mesh.world
            sums, srads = both[:len(sums)], both[len(sums):]
        sums = sums.cpu().tolist()
        if len(srads):
            self._log("spectral_radius.csv", "".join(
                "\n{}".format(s) for s in srads.cpu().tolist()))
        for k, v in zip(LOSS_KEYS, sums):
            self.hist_val[k].append(v / n_batches)
        self._log("train_metrics.csv",
                  "\nValidation Epoch {} : \t Train : {:.5e} \t Res : {:.5e}"
                  " \t Jac : {:.5e} \t Enc : {:.5e} \t AE : {:.5e}"
                  " \t MSE : {:.5e}".format(
                      epoch, *(self.hist_val[k][-1] for k in LOSS_KEYS)))

    # ------------------------------------------------------------- main train

    def train_model(self) -> torch.nn.Module:
        c = self.c
        checkpoint = None
        # resume continues the epoch numbering and stops at the absolute
        # max_epochs budget
        start_epoch = len(self.hist_val["loss"])
        for epoch in range(start_epoch, c.max_epochs):
            t0 = time.time()
            self.train_loop(epoch)
            self.validation_loop(epoch)
            if self.psignn:
                self.sched_deq.step(self.hist_val["loss"][-1])
                self.sched_ae.step(self.hist_val["loss"][-1])
            self.training_time += time.time() - t0

            # effective learning rates: the spike guard's scale included
            if (self.psignn
                    and self.sched_deq.lr * self.lr_scale <= c.lr_floor
                    and self.sched_ae.lr * self.lr_scale <= c.lr_floor):
                self._log("train_metrics.csv", "\nTraining exit because both "
                          "learning rates too low !")
                break

            improved = self.hist_val["residual_loss"][-1] <= self.min_loss_save
            if improved:
                self.min_loss_save = self.hist_val["residual_loss"][-1]
            checkpoint = self._make_checkpoint(epoch)
            self._save(checkpoint, "running_model")
            if improved:
                self._save(checkpoint, "best_model")
            lr_lines = ("\nCurrent Learning rate DEQ : {}"
                        "\nCurrent Learning rate AUTOENC : {}".format(
                            self.sched_deq.lr, self.sched_ae.lr)
                        if self.psignn else "")
            self._log("train_metrics.csv",
                      "\nTraining Epoch {} finished, took current epoch "
                      "{:.2f}s, cumulative time {:.2f}s".format(
                          epoch, time.time() - t0, self.training_time)
                      + lr_lines + ("\nMODEL SAVED" if improved else ""))

            if c.spike_guard and not improved and self.min_loss_save < 1e9:
                spiked = (self.hist_val["residual_loss"][-1]
                          > c.spike_factor * self.min_loss_save)
                self._spike_count = self._spike_count + 1 if spiked else 0
                if self._spike_count >= c.spike_patience:
                    best = self._read_checkpoint(os.path.join(
                        self.path_ckpt, "best_model.ckpt"), missing_ok=True)
                    if best is not None:
                        self._load_state(best)
                    self.lr_scale *= 0.5
                    self._spike_count = 0
                    self._log("train_metrics.csv",
                              "\nSPIKE GUARD: val residual > {:.1f}x best "
                              "for {} epochs - reloaded best checkpoint, "
                              "lr scale now {:g}".format(
                                  c.spike_factor, c.spike_patience,
                                  self.lr_scale))
                    # a restart before the next epoch resumes from the
                    # recovered state
                    self._save(self._make_checkpoint(epoch), "running_model")

            if epoch % c.plot_every == 0 and self.writer:
                self._plot(epoch)

        if checkpoint is None:
            checkpoint = self._make_checkpoint(c.max_epochs - 1)
        self._save(checkpoint, "final_model")
        if self.mesh:       # every rank returns with the run's files written
            self.mesh.barrier()
        return self.model

    def _grad_norms(self) -> Dict[str, float]:
        """The ℓ2 norm of each parameter's gradient as the last step left
        it (clipped), keyed by the parameter's path in the JAX tree
        (``function/layers/0/phi_to/0/w``) in JAX's order; a parameter
        with no gradient (DS-GPS's ``laynorm``) reads 0, as JAX's zero
        gradient."""
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self.model.named_parameters()}
        return {"/".join(str(k) for k in path):
                float(np.linalg.norm(np.ravel(leaf)))
                for path, leaf in _tree_paths(self._to_jax(grads))}

    def _plot(self, epoch: int) -> None:
        """The loss curves and the gradient bars; without matplotlib, a
        line in the log, once."""
        if not self._can_plot:
            return
        try:
            plot_losses(self.hist_train, self.hist_val, self.path_logs)
            plot_gradients(self._last_grad_norms, epoch, self.path_logs)
        except ImportError as e:
            if e.name != "matplotlib":
                raise
            self._can_plot = False
            self._log("train_metrics.csv",
                      f"\nPlots not drawn from epoch {epoch} on: {e}")

    def _read_checkpoint(self, path: str, missing_ok: bool = False
                         ) -> Optional[Dict[str, Any]]:
        """The checkpoint at ``path`` as rank 0 reads it, on every rank:
        rank 0 alone writes checkpoints, to its own disk, which the ranks
        of other hosts do not see.  ``missing_ok``: None if rank 0 has no
        such file."""
        ckpt = None
        if self.writer and not (missing_ok and not os.path.exists(path)):
            ckpt = load_checkpoint(path)
        return self.mesh.broadcast(ckpt) if self.mesh else ckpt

    def _save(self, checkpoint: Dict[str, Any], name: str) -> None:
        if self.writer:
            save_checkpoint(checkpoint, self.path_ckpt, name)

    def _make_checkpoint(self, epoch: int) -> Dict[str, Any]:
        optim = {key: optimizer_state_to_numpy(opt.state_dict())
                 for key, opt in zip(self.opt_keys, self.opts)}
        if self.psignn:
            optim.update(sched_deq=self.sched_deq.state_dict(),
                         sched_ae=self.sched_ae.state_dict())
        return dict(
            epoch=epoch,
            family=self.family,
            hyperparameters=dataclasses.asdict(self.mc),
            params=self._to_jax(self.model.state_dict()),
            hist_train=self.hist_train,
            hist_val=self.hist_val,
            min_loss_save=self.min_loss_save,
            lr_scale=self.lr_scale,
            training_time=self.training_time,
            torch_optim=optim,
        )

    def _load_state(self, ckpt: Dict[str, Any]) -> None:
        """Parameters and optimizer states of a checkpoint, one the port
        wrote (``torch_optim``) or one of the JAX package (``opt_state``)."""
        sd = {k: v.to(self.device) for k, v in
              self._from_jax(ckpt["params"]).items()}
        self.model.load_state_dict(sd)
        if "torch_optim" not in ckpt:
            self._adam_state_from_optax(ckpt["opt_state"])
            return
        for opt, key in zip(self.opts, self.opt_keys):
            opt.load_state_dict(
                optimizer_state_from_numpy(ckpt["torch_optim"][key]))

    def _adam_state_from_optax(self, opt_state) -> None:
        """The JAX trainer's ``optax.scale_by_adam`` states (``count``,
        ``mu``, ``nu``, read by position: the checkpoint reader turns them
        into plain tuples) as torch Adam's ``step``, ``exp_avg`` and
        ``exp_avg_sq``.  Ψ-GNN has two, over the update function
        (``opt_state["deq"]``) and the autoencoder (``["ae"]``); DS-GPS and
        DSS one over every parameter.  The moment trees are converted as
        the parameter tree is (``self._from_jax``).  DS-GPS's declared but
        unused ``laynorm`` has moments in JAX (zero: its gradient is); its
        port parameter never gets a gradient, so Adam keeps no state for it
        and those moments are dropped."""
        states = ((opt_state["deq"], opt_state["ae"]) if self.psignn
                  else (opt_state,))
        if self.psignn:
            # the two moment trees of each kind make one Ψ-GNN tree
            mu, nu = ({"function": states[0][i], "autoencoder": states[1][i]}
                      for i in (1, 2))
            moments = [(self._from_jax(mu), self._from_jax(nu))] * 2
        else:
            moments = [(self._from_jax(states[0][1]),
                        self._from_jax(states[0][2]))]
        names = {id(p): n for n, p in self.model.named_parameters()}
        for opt, state, (mu, nu) in zip(self.opts, states, moments):
            step = torch.tensor(float(np.asarray(state[0])),
                                dtype=torch.float32)
            for group in opt.param_groups:
                for p in group["params"]:
                    name = names[id(p)]
                    if name.startswith("laynorm.") and not self.psignn:
                        continue
                    opt.state[p] = {
                        "step": step.clone(),
                        "exp_avg": mu[name].to(p.device, p.dtype),
                        "exp_avg_sq": nu[name].to(p.device, p.dtype)}

    def load_model(self, path: str) -> None:
        """Resume from a checkpoint (training_class.py:68-81), one the port
        wrote or one of the JAX package; the JAX trainer keeps its
        schedulers at the checkpoint's top level."""
        ckpt = self._read_checkpoint(path)
        self._load_state(ckpt)
        self.hist_train = ckpt["hist_train"]
        self.hist_val = ckpt["hist_val"]
        self.min_loss_save = ckpt["min_loss_save"]
        self.lr_scale = ckpt.get("lr_scale", 1.0)
        self.training_time = ckpt["training_time"]
        if self.psignn:
            scheds = ckpt.get("torch_optim", ckpt)
            self.sched_deq.load_state_dict(scheds["sched_deq"])
            self.sched_ae.load_state_dict(scheds["sched_ae"])


def _tree_paths(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) of a nested dict/list tree in
    ``jax.tree_util.tree_flatten_with_path``'s order: dict keys sorted,
    list entries by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, prefix + (i,))
    else:
        yield prefix, tree
