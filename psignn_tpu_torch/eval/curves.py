"""Training-curve comparison: a run's ``train_metrics.csv`` against
another's, such as the reference's checked-in logs.

Port of ``psignn_tpu/eval/curves.py`` (``parse_val``,
``parse_epoch_times``, ``compare``, ``write_report``, ``plot``, ``main``).
Both packages, and the reference, write the same line-oriented log
(``Validation Epoch 12 : Train : ...  Res : ...  MSE : ...``); the report
gives the validation residual and MSE at matched epochs, and ``--plot``
draws the two validation-residual curves (matplotlib, imported when it
draws).  The log readers ``load_sweep_csv`` and ``parse_val_curve`` live
in ``vis`` and are imported here too.

    python -m psignn_tpu_torch.eval.curves \\
        --ours results/psignn_torch_run/logs/train_metrics.csv \\
        --ref results/psignn_dirichlet/logs/train_metrics.csv \\
        --label psignn --out results/eval/curves_psignn.md \\
        --plot results/eval/curves_psignn.png
"""

from __future__ import annotations

import argparse
import os
import re

import torch

from .vis import load_pyplot, load_sweep_csv, parse_val_curve  # noqa: F401

_VAL = re.compile(
    r"Validation Epoch (\d+) :.*?Res : ([0-9.eE+-]+).*?MSE : ([0-9.eE+-]+)")
_EPOCH_TIME = re.compile(
    r"Training Epoch (\d+) finished, took current epoch ([0-9.]+)s")


def parse_val(path: str):
    """{epoch: (val_res, val_mse)} from a train_metrics log."""
    out = {}
    with open(path) as f:
        for line in f:
            m = _VAL.search(line)
            if m:
                out[int(m.group(1))] = (float(m.group(2)), float(m.group(3)))
    return out


def parse_epoch_times(path: str):
    """{epoch: seconds} of each finished training epoch in a log."""
    out = {}
    with open(path) as f:
        for line in f:
            m = _EPOCH_TIME.search(line)
            if m:
                out[int(m.group(1))] = float(m.group(2))
    return out


def compare(ours: str, ref: str, checkpoints=(0, 1, 5, 10, 25, 50, 100,
                                              200, 399)):
    """Rows ``(epoch, our epoch, our res, ref res, ratio, our mse, ref
    mse)`` at each checkpoint epoch the reference logged (past our last
    epoch, ours is read at its last), and both parsed logs."""
    ov, rv = parse_val(ours), parse_val(ref)
    rows = []
    last = max(ov) if ov else -1
    for e in checkpoints:
        ee = e if e in ov else (last if e > last else None)
        if ee is None or e not in rv:
            continue
        o_res, o_mse = ov[ee]
        r_res, r_mse = rv[e]
        rows.append((e, ee, o_res, r_res, o_res / r_res, o_mse, r_mse))
    return rows, ov, rv


def device_name(device=None) -> str:
    """The name of ``device`` (default: this host's first card, or the CPU
    when it has none)."""
    device = torch.device(device if device is not None else
                          "cuda" if torch.cuda.is_available() else "cpu")
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "CPU")


def write_report(rows, ov, rv, label, out_path, times=None, device=None):
    """The comparison as markdown at ``out_path``; with ``times`` (``{epoch:
    seconds}``), a steady-state epoch time on ``device`` (named by
    ``device_name``: give the training run's device when the report is
    written elsewhere)."""
    lines = [f"# Training-curve parity — {label}", ""]
    if times:
        vals = list(times.values())[1:] or list(times.values())
        lines.append(f"Epoch time (steady state): "
                     f"{sum(vals) / max(1, len(vals)):.1f}s/epoch "
                     f"on {device_name(device)}.")
        lines.append("")
    lines.append("| epoch (ref) | epoch (ours) | val Res (ours) | "
                 "val Res (ref) | ratio | val MSE (ours) | val MSE (ref) |")
    lines.append("|---|---|---|---|---|---|---|")
    for e, ee, o, r, ratio, om, rm in rows:
        lines.append(f"| {e} | {ee} | {o:.3e} | {r:.3e} | {ratio:.2f}x | "
                     f"{om:.3e} | {rm:.3e} |")
    lines.append("")
    lines.append(f"Ours trained to epoch {max(ov)}; "
                 f"reference log covers epochs 0–{max(rv)}.")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return out_path


def plot(ov, rv, label, path, device=None):
    """The validation residual of ``ov`` and ``rv`` (``parse_val``'s
    dicts) against the epoch at ``path``; the legend names the run's
    ``device`` (``device_name``)."""
    plt, _ = load_pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for vals, name, color in (
            (ov, f"psignn_tpu_torch ({device_name(device)})", "#2a7de1"),
            (rv, "reference (2 GPUs)", "#b3b9c4")):
        es = sorted(vals)
        ax.plot(es, [vals[e][0] for e in es], label=name, color=color)
    ax.set_yscale("log")
    ax.set_xlabel("epoch")
    ax.set_ylabel("validation residual")
    ax.set_title(f"{label}: validation residual vs reference")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(
        description="psignn_tpu_torch training-curve comparison")
    p.add_argument("--ours", required=True)
    p.add_argument("--ref", required=True)
    p.add_argument("--label", default="run")
    p.add_argument("--out", default=None)
    p.add_argument("--plot", default=None,
                   help="draw the validation-residual overlay here (PNG)")
    args = p.parse_args(argv)

    rows, ov, rv = compare(args.ours, args.ref)
    times = parse_epoch_times(args.ours)
    for e, ee, o, r, ratio, om, rm in rows:
        print(f"epoch {e} (ours {ee}): val res {o:.3e} vs ref {r:.3e} "
              f"({ratio:.2f}x)")
    if args.out:
        print("wrote", write_report(rows, ov, rv, args.label, args.out,
                                    times))
    if args.plot:
        print("wrote", plot(ov, rv, args.label, args.plot))


if __name__ == "__main__":
    main()
