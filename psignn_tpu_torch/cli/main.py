"""Training CLI of the port: Ψ-GNN, DS-GPS and DSS, Dirichlet or mixed
(DSS: Dirichlet only), on one device or data-parallel over several.

Port of ``psignn_tpu/cli/main.py`` for the paths the port has::

    python -m psignn_tpu_torch.cli.main --family psignn --variant mixed \\
        --path_dataset data/ --solver broyden --fw_tol 1e-5 --fw_thres 500 \\
        --lr_deq 0.01 --lr_ae 0.05 --jac_weight 1.0 --batch_size 50
    python -m psignn_tpu_torch.cli.main --family dsgps --path_dataset data/ \\
        --k 30 --gamma 0.9 --lr 1e-3 --spike_guard

The flags keep the JAX CLI's names and defaults; ``--solver`` also takes
``picard``, another name of ``forward_iteration``.  ``--gradient_clip``
defaults to the family's canonical value: 0.1 for Ψ-GNN, 0.01 for DS-GPS
and DSS.  ``--stacked_batch`` solves each mesh of a Ψ-GNN batch on its own
(other families ignore it, as in JAX); ``--lowrank_max_rank`` and
``--lowrank_bf16`` set Broyden's rank memory; ``--precision bfloat16``
loads the dataset rounded to bfloat16 (the arithmetic stays float32, as
JAX's float32 parameters make it); ``--resume`` takes a checkpoint of the
port or of the JAX trainer.  ``--num_devices`` trains data-parallel
(every family), ``--solver newton|newton_krylov`` solves the DEQ's forward
and adjoint systems by Newton's method (DS-GPS and DSS ignore ``--solver``,
as in JAX).  ``--rcm`` puts each sample's nodes in reverse Cuthill-McKee
order, and ``--pallas`` implies it (the hand-written kernels are the port's
only card route, so it selects nothing else); ``--cache_batches 1`` builds
every batch once and keeps it on the device, its membership frozen after
the first shuffle (``data.reader.GraphLoader``); ``--comment`` is accepted
and unused, as in JAX.  Checkpoints do not record these four.
``--device`` picks the torch device (default: cuda).  The mixed variant's
split is shuffled by ``--seed``.

A run without ``--resume`` starts afresh: it deletes the ``ckpt/``,
``logs/``, ``trainer.pid`` and ``relaunch.cmd`` an earlier run left in
``--path_results`` (default ``results/psignn_torch_run/``), and refuses a
directory that holds anything else, so that it never deletes files it did
not write.

As the JAX CLI does, the run keeps two files in ``--path_results`` for the
run-operation scripts of ``scripts/torch/``: ``trainer.pid``, the PID of
the process the user started (with ``--num_devices`` the launcher of the
rank processes, which are its children), removed when the command returns
or raises; and ``relaunch.cmd``, the command again, shell-quoted, with
``--resume <path_results>/ckpt/running_model.ckpt`` in place of any
earlier ``--resume``.  A launch by torchrun (``WORLD_SIZE`` set) writes
neither: its launcher is torchrun.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shlex
import shutil
import sys
from typing import List, Optional


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="psignn_tpu_torch trainer")
    p.add_argument("--family", type=str, default="psignn",
                   choices=["psignn", "dsgps", "dss"])
    p.add_argument("--variant", type=str, default="dirichlet",
                   choices=["dirichlet", "mixed"])
    # paths
    p.add_argument("--path_dataset", type=str, default="dataset/")
    p.add_argument("--path_results", type=str,
                   default="results/psignn_torch_run/")
    p.add_argument("--comment", type=str, default="")
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint path to resume from (one the port or the "
                        "JAX trainer wrote)")
    # training
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--max_epochs", type=int, default=500)
    p.add_argument("--precision", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--min_loss_save", type=float, default=1e10)
    p.add_argument("--gradient_clip", type=float, default=None,
                   help="default: canonical per family (psignn 0.1, "
                        "dsgps/dss 0.01)")
    p.add_argument("--stats", type=str, default="reference",
                   choices=["reference", "auto"])
    # optimizers
    p.add_argument("--lr", type=float, default=0.01, help="dsgps/dss lr")
    p.add_argument("--lr_deq", type=float, default=0.01)
    p.add_argument("--sched_step_deq", type=float, default=0.5)
    p.add_argument("--lr_ae", type=float, default=0.05)
    p.add_argument("--sched_step_ae", type=float, default=0.5)
    # solver / DEQ
    p.add_argument("--solver", type=str, default="broyden",
                   choices=["broyden", "forward_iteration", "picard",
                            "anderson", "newton", "newton_krylov"])
    p.add_argument("--jac_weight", type=float, default=1.0)
    p.add_argument("--latent_dim", type=int, default=10)
    p.add_argument("--n_layers", type=int, default=1)
    p.add_argument("--fw_tol", type=float, default=1e-5)
    p.add_argument("--fw_thres", type=int, default=500)
    p.add_argument("--bw_tol", type=float, default=1e-8)
    p.add_argument("--bw_thres", type=int, default=500)
    p.add_argument("--broyden_ls", action="store_true",
                   help="Armijo line search on each Broyden step "
                        "(reference broyden(..., ls=True))")
    # unrolled models (dsgps/dss)
    p.add_argument("--k", type=int, default=30)
    p.add_argument("--alpha", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.9)
    p.add_argument("--enc_loss_mode", type=str, default="",
                   choices=["", "freeze", "detach"],
                   help="dsgps only: override the per-variant enc/autoenc "
                        "loss semantics (dirichlet reference: freeze, mixed "
                        "reference: detach)")
    p.add_argument("--neumann_init_scale", type=float, default=1.0,
                   help="mixed dsgps: scale update_neumann's output layer "
                        "at init (1.0 = reference Xavier; about 0.1 starts "
                        "the ungated Neumann recurrence contractive)")
    # devices and Broyden's rank memory
    p.add_argument("--num_devices", type=int, default=1,
                   help="data-parallel ranks (0: every local GPU)")
    p.add_argument("--lowrank_bf16", action="store_true",
                   help="store Broyden's rank-1 pairs in bfloat16")
    p.add_argument("--lowrank_max_rank", type=int, default=0,
                   help="> 0: keep only the newest pairs of Broyden's rank "
                        "memory (rounded up to blocks of 128)")
    # node order and device-resident batches
    p.add_argument("--rcm", action="store_true",
                   help="RCM-permute each sample's nodes")
    p.add_argument("--pallas", action="store_true",
                   help="the JAX package's fused-kernel switch: implies "
                        "--rcm (the CUDA kernels are always the card's "
                        "route)")
    p.add_argument("--cache_batches", type=int, default=0,
                   help="build every batch once and keep it on the device "
                        "(epochs reshuffle batch order, not membership)")
    p.add_argument("--stacked_batch", action="store_true",
                   help="Ψ-GNN: one DEQ solve per mesh of a batch, each "
                        "stopping at its own tolerance")
    p.add_argument("--spike_guard", action="store_true",
                   help="on a sustained val-residual spike (> spike_factor x "
                        "best for spike_patience epochs) reload the best "
                        "checkpoint and halve the effective lr")
    p.add_argument("--spike_factor", type=float, default=3.0)
    p.add_argument("--spike_patience", type=int, default=2)
    p.add_argument("--val_sradius", type=int, default=1,
                   help="power-method spectral radius during validation "
                        "(150 VJPs per val batch, as the reference)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p


def refuse_unported(p: argparse.ArgumentParser, args) -> None:
    """``p.error`` on any flag value whose path the port does not have."""
    if args.family == "dss" and args.variant != "dirichlet":
        p.error("--family dss has a Dirichlet variant only")


@dataclasses.dataclass(frozen=True)
class RankPlan:
    """How the ranks of a run are laid out: ``n`` ranks (1: no data
    parallelism), ``joined`` when torchrun started them, the group's
    ``backend`` and the ``device`` option of every rank (``None``: rank
    r's own card, ``cuda:<local rank>``)."""
    n: int
    joined: bool
    backend: str
    device: Optional[str]

    def rank_device(self, rank: int) -> Optional[str]:
        if self.n == 1 or self.device is not None:
            return self.device
        local = int(os.environ.get("LOCAL_RANK", rank)) if self.joined \
            else rank
        return f"cuda:{local}"


def rank_plan(p: argparse.ArgumentParser, args) -> RankPlan:
    """The ranks of ``--num_devices`` and ``--device``; ``p.error`` on a
    layout that cannot run."""
    import torch
    world = int(os.environ.get("WORLD_SIZE", "1"))
    joined = world > 1
    n = args.num_devices
    device = args.device
    if n < 0:
        p.error(f"--num_devices {n} is negative")
    if joined:
        if n not in (0, 1, world) or (n == 1 and world > 1):
            p.error(f"--num_devices {n} in a launch of {world} processes")
        n = world
    elif n == 0:
        if device == "cpu":
            p.error("--num_devices 0 means every local GPU; with --device "
                    "cpu give a count")
        n = torch.cuda.device_count()
        if n == 0:
            p.error("--num_devices 0: this machine has no GPU")
    if n > 1 and args.stacked_batch and args.family == "psignn":
        p.error("--stacked_batch and --num_devices > 1 exclude each other "
                "(one DEQ solve per mesh is not data-parallel, as in JAX)")
    if n == 1:
        return RankPlan(1, False, "", device)
    if device is None or device == "cuda":
        if not joined and n > torch.cuda.device_count():
            p.error(f"--num_devices {n}: {torch.cuda.device_count()} GPUs "
                    "here; several ranks share one card only with "
                    "--device cuda:K")
        return RankPlan(n, joined, "nccl", None)
    if device == "cpu" or device.startswith("cuda:"):
        return RankPlan(n, joined, "gloo", device)
    p.error(f"--device {device}: give cpu, cuda or cuda:K")


def gradient_clip(args) -> float:
    """``--gradient_clip``, or the family's canonical value when it is not
    given (launch_slurm.sh / launch.sh): 0.1 for Ψ-GNN, 0.01 for DS-GPS
    and DSS."""
    if args.gradient_clip is not None:
        return args.gradient_clip
    return 0.1 if args.family == "psignn" else 0.01


def build_model_cfg(args):
    """The model config of the family's flags (JAX cli/main.py:126-142)."""
    from ..models import DsgpsConfig, DssConfig, PsignnConfig
    if args.family == "psignn":
        return PsignnConfig(latent_dim=args.latent_dim,
                            n_layers=args.n_layers, bc_mode=args.variant,
                            solver=args.solver, fw_tol=args.fw_tol,
                            fw_thres=args.fw_thres, bw_tol=args.bw_tol,
                            bw_thres=args.bw_thres, ls=args.broyden_ls,
                            lowrank_bf16=args.lowrank_bf16,
                            lowrank_max_rank=args.lowrank_max_rank)
    if args.family == "dsgps":
        return DsgpsConfig(latent_dim=args.latent_dim, k=args.k,
                           gamma=args.gamma, bc_mode=args.variant,
                           neumann_init_scale=args.neumann_init_scale,
                           enc_loss_override=args.enc_loss_mode)
    return DssConfig(latent_dim=args.latent_dim, k=args.k, alpha=args.alpha,
                     gamma=args.gamma)


PID_FILE = "trainer.pid"
RELAUNCH_FILE = "relaunch.cmd"
RUN_OUTPUTS = ("ckpt", "logs", PID_FILE, RELAUNCH_FILE)


def foreign_results(p: argparse.ArgumentParser, path: str) -> None:
    """``p.error`` if ``path`` holds anything the trainer does not write."""
    if not os.path.exists(path):
        return
    foreign = sorted(set(os.listdir(path)) - set(RUN_OUTPUTS))
    if foreign:
        p.error(f"--path_results {path} holds {', '.join(foreign)}, which "
                f"a training run does not write; give a new or empty "
                f"directory, or --resume")


def clear_results(p: argparse.ArgumentParser, path: str) -> None:
    """Delete an earlier run's outputs in ``path``; ``p.error`` if ``path``
    holds anything the trainer does not write."""
    foreign_results(p, path)
    for name in RUN_OUTPUTS:
        out = os.path.join(path, name)
        if os.path.isdir(out):
            shutil.rmtree(out)
        elif os.path.lexists(out):
            os.remove(out)


def relaunch_argv(argv: List[str], path_results: str) -> List[str]:
    """The command that resumes this run: the port's CLI with ``argv``,
    any ``--resume X`` (or ``--resume=X``) dropped and ``--resume
    <path_results>/ckpt/running_model.ckpt`` appended."""
    kept, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--resume":
            skip = True
        elif not a.startswith("--resume="):
            kept.append(a)
    return [sys.executable, "-m", "psignn_tpu_torch.cli.main", *kept,
            "--resume", os.path.join(path_results, "ckpt",
                                     "running_model.ckpt")]


def write_run_files(argv: List[str], path_results: str) -> str:
    """Write ``trainer.pid`` (this process) and ``relaunch.cmd`` into
    ``path_results``; returns the pid file's path."""
    with open(os.path.join(path_results, RELAUNCH_FILE), "w") as f:
        # shell-quoted: the watchdog runs it through ``bash -c``
        f.write(shlex.join(relaunch_argv(argv, path_results)))
    pid_file = os.path.join(path_results, PID_FILE)
    with open(pid_file, "w") as f:
        f.write(str(os.getpid()))
    return pid_file


def main(argv=None) -> None:
    """Train as the flags say."""
    p = get_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(argv)
    refuse_unported(p, args)
    plan = rank_plan(p, args)
    if plan.joined:
        rank = int(os.environ.get("RANK", "0"))
        _join(plan, rank, None)
        _train(p, args, plan, rank, clear=rank == 0 and not args.resume)
        if rank == 0:
            print("Training finished")
        return
    if not args.resume:
        clear_results(p, args.path_results)
    os.makedirs(args.path_results, exist_ok=True)
    pid_file = write_run_files(argv, args.path_results)
    try:
        _launch(args, plan)
    finally:
        remove_pid_file(pid_file)
    print("Training finished")


def remove_pid_file(pid_file: str) -> None:
    """Remove ``pid_file`` if it still names this process (a relaunch may
    have written its own since)."""
    try:
        with open(pid_file) as f:
            if f.read().strip() == str(os.getpid()):
                os.remove(pid_file)
    except FileNotFoundError:
        pass


def _launch(args, plan: RankPlan) -> None:
    """Train in this process, or spawn the ranks of ``--num_devices``."""
    if plan.n == 1:
        _train(None, args, plan, 0)
        return
    from ..dist import multihost
    if plan.device and plan.device.startswith("cuda:"):
        print(f"--device {plan.device}: {plan.n} ranks share one card "
              "over gloo, their collectives staged through the host",
              flush=True)
    if plan.device != "cpu":
        # build the kernels once, here, rather than on every rank
        from ..kernels import build
        for name in ("fused_mp_fwd", "fused_mp_bwd"):
            build.build(name)
    init = f"tcp://127.0.0.1:{multihost.free_port()}"
    multihost.spawn(_rank_main, plan.n, (args, plan, init))


def _join(plan: RankPlan, rank: int, init_method: Optional[str]) -> None:
    """Join the run's process group as ``rank`` (on its card first)."""
    import torch

    from ..dist import multihost
    device = plan.rank_device(rank)
    if device is not None and device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    multihost.initialize(plan.backend, init_method, plan.n, rank)


def _rank_main(rank: int, args, plan: RankPlan, init_method: str) -> None:
    """One spawned rank of ``--num_devices``."""
    _join(plan, rank, init_method)
    _train(None, args, plan, rank)


def build_loaders(args, device, n_devices: int = 1, rank: int = 0):
    """The (train, validation) ``GraphLoader``s of a run of ``args`` on
    ``device``: rank ``rank``'s shard of them when ``n_devices`` > 1."""
    from ..data.reader import GraphLoader, load_dataset, split_dataset

    shard = (dict(n_devices=n_devices, rank=rank) if n_devices > 1 else {})
    samples = load_dataset(args.path_dataset, family=args.family,
                           variant=args.variant, stats=args.stats,
                           precision=args.precision)
    train, val, _ = split_dataset(samples, family=args.family,
                                  variant=args.variant, seed=args.seed)
    common = dict(batch_size=args.batch_size, device=device,
                  stacked=args.stacked_batch and args.family == "psignn",
                  rcm=args.rcm or args.pallas,
                  cache_batches=bool(args.cache_batches), **shard)
    return (GraphLoader(train, shuffle=True, seed=args.seed, **common),
            GraphLoader(val, **common))


def _train(p: Optional[argparse.ArgumentParser], args, plan: RankPlan,
           rank: int, clear: bool = False) -> None:
    """Train rank ``rank`` of the run; ``clear``: clear ``--path_results``
    first (rank 0 of a torchrun launch, whose launcher cannot)."""
    from ..train import Trainer, TrainConfig

    if clear:
        clear_results(p, args.path_results)
    if rank == 0:           # only rank 0 writes
        os.makedirs(args.path_results, exist_ok=True)
    device = plan.rank_device(rank)
    loader_train, loader_val = build_loaders(args, device, plan.n, rank)
    cfg = TrainConfig(
        family=args.family, model_cfg=build_model_cfg(args),
        max_epochs=args.max_epochs, lr=args.lr, lr_deq=args.lr_deq,
        lr_ae=args.lr_ae, sched_step_deq=args.sched_step_deq,
        sched_step_ae=args.sched_step_ae,
        gradient_clip=gradient_clip(args), jac_weight=args.jac_weight,
        min_loss_save=args.min_loss_save, path_results=args.path_results,
        seed=args.seed, val_sradius=bool(args.val_sradius),
        data_parallel=plan.n > 1, stacked_batch=loader_train.stacked,
        spike_guard=args.spike_guard, spike_factor=args.spike_factor,
        spike_patience=args.spike_patience, device=device)

    trainer = Trainer(cfg, loader_train, loader_val)
    if args.resume:
        trainer.load_model(args.resume)
    trainer.train_model()


if __name__ == "__main__":
    main()
