"""Run operations of the port: the CLI's ``trainer.pid`` and
``relaunch.cmd`` (JAX ``cli/main.py:164-192``), the fresh-run guard, and
the scripts of ``scripts/torch/`` against the JAX package's own
(``scripts/*.sh``, ``tools/launch_k70.sh``, ``tools/with_quiet_chip.sh``,
``tools/make_warmae_ckpt.py``).

The flag-parity test parses both packages' scripts with
``chip_smoke.script_commands`` (line continuations, ``$(...)`` clauses,
the scripts' variable defaults) and trains nothing.  The others run on
the CPU at a few meshes: one CLI epoch, the warm start and its resumed
epoch, the watchdog and the quiet-card wrapper on stand-in processes, the
kill and relaunch of ``chip_smoke.ops_kill_relaunch`` at batch 3, and
``eval_trained.sh``.
"""

import json
import os
import shlex
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import chip_smoke
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu_torch.cli.main import get_parser, main, relaunch_argv
from psignn_tpu_torch.data.generate import get_parser as generate_parser
from psignn_tpu_torch.eval.run_eval import get_parser as eval_parser
from psignn_tpu_torch.weights import load_jax_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH = os.path.join(ROOT, "scripts", "torch")
# each port script and the JAX script it follows
PAIRS = {
    "train_psignn_dirichlet.sh": "scripts/train_psignn_dirichlet.sh",
    "train_psignn_mixed.sh": "scripts/train_psignn_mixed.sh",
    "train_dss_dirichlet.sh": "scripts/train_dss_dirichlet.sh",
    "train_dsgps_dirichlet.sh": "scripts/train_dsgps_dirichlet.sh",
    "train_dsgps_mixed.sh": "scripts/train_dsgps_mixed.sh",
    "train_dsgps_k70.sh": "tools/launch_k70.sh",
    "generate_datasets.sh": "scripts/generate_datasets.sh",
    "eval_trained.sh": "scripts/eval_trained.sh",
    "resume_round.sh": "scripts/resume_round.sh",
}
PARSERS = {"cli.main": get_parser, "data.generate": generate_parser,
           "eval.run_eval": eval_parser}
FAST = ["--fw_thres", "25", "--bw_thres", "25", "--val_sradius", "0",
        "--device", "cpu"]
MATCH = "psignn_tpu_torch.cli.main"


def _flags(argv):
    """[(flag, value or None)] of an argv; a bare ``$(...)`` is not in
    it (``script_commands`` lists those as clauses)."""
    out, i = [], 0
    while i < len(argv):
        flag = argv[i]
        assert flag.startswith("--"), argv
        if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            out.append((flag, argv[i + 1]))
            i += 2
        else:
            out.append((flag, None))
            i += 1
    return out


def _port_value(value):
    """A JAX script's value as the port's script must pass it: the port's
    runs and tables go under results/torch/, never into the JAX runs'."""
    if value is None:
        return None
    if value == "results/$run/eval":
        return "results/torch/eval/$run"
    return value.replace("results/", "results/torch/")


@pytest.mark.parametrize("port", sorted(PAIRS))
def test_flag_parity_with_the_jax_script(port):
    """The port script runs the JAX script's commands, module for module
    and in order, with the same flags and values, every one of them (and
    its outputs under results/torch/); each resume clause too; and the
    port's argparse accepts every command."""
    jax_cmds = chip_smoke.script_commands(os.path.join(ROOT, PAIRS[port]))
    port_cmds = chip_smoke.script_commands(os.path.join(TORCH, port))
    assert [c["module"] for c in port_cmds] == [
        c["module"].replace("psignn_tpu.", "psignn_tpu_torch.")
        for c in jax_cmds]
    assert port_cmds
    for j, p in zip(jax_cmds, port_cmds):
        want = [(f, _port_value(v)) for f, v in _flags(j["argv"])]
        assert _flags(p["argv"]) == want, (port, p["argv"])
        assert p["clauses"] == [_port_value(c) for c in j["clauses"]]
        parser = PARSERS[p["module"].split(".", 1)[1]]()
        # a "$(run_lr DIR FALLBACK)" value parses as its fallback
        argv = [a.rstrip(")").split()[-1] if a.startswith("$(") else a
                for a in p["argv"]]
        parser.parse_args(argv)


def test_no_jax_flag_is_dropped():
    """Every flag of each JAX script is in its port script, and every
    option of the JAX training CLI is an option of the port's: since the
    port has ``--rcm``, ``--pallas``, ``--cache_batches`` and ``--comment``
    none is dropped as TPU-only any more."""
    from psignn_tpu.cli.main import get_parser as jax_parser
    for port, jax in PAIRS.items():
        flags = [{f for c in chip_smoke.script_commands(path)
                  for f, _ in _flags(c["argv"])}
                 for path in (os.path.join(ROOT, jax),
                              os.path.join(TORCH, port))]
        assert flags[0] <= flags[1], (port, sorted(flags[0] - flags[1]))
        with open(os.path.join(TORCH, port)) as f:
            assert "TPU-only" not in f.read(), port
    ours = set(get_parser()._option_string_actions)
    theirs = set(jax_parser()._option_string_actions)
    assert theirs <= ours, sorted(theirs - ours)


def test_script_commands_reads_clauses_and_defaults():
    """The parser: continuations joined, defaults and overrides expanded,
    a quoted ``$(...)`` kept as a value, a bare one listed as a clause,
    ``"$@"`` and redirections dropped."""
    (cmd,) = [c for c in chip_smoke.script_commands(
        os.path.join(ROOT, "scripts", "resume_round.sh"))
        if "results/dsgps_dirichlet" in c["argv"]]
    flags = dict(_flags(cmd["argv"]))
    assert flags["--lr"] == "$(run_lr results/dsgps_dirichlet 1e-3)"
    assert cmd["clauses"] == ["$(resume_flag results/dsgps_dirichlet)"]
    (cmd,) = chip_smoke.script_commands(
        os.path.join(TORCH, "train_dsgps_dirichlet.sh"),
        dict(DATA="d", OUT="o", WARM="--resume w.ckpt"))
    assert cmd["argv"][-2:] == ["--resume", "w.ckpt"]
    assert dict(_flags(cmd["argv"]))["--path_results"] == "o"
    (cmd,) = chip_smoke.script_commands(
        os.path.join(TORCH, "train_dsgps_dirichlet.sh"))
    assert "--resume" not in cmd["argv"]
    assert dict(_flags(cmd["argv"]))["--lr"] == "1e-3"


# ------------------------------------------------------------ CLI files


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """scripts/torch/generate_datasets.sh at 2 meshes × 5 samples: the
    {variant: path} of its datasets."""
    root = tmp_path_factory.mktemp("ops")
    proc = subprocess.run(
        ["bash", os.path.join(TORCH, "generate_datasets.sh")], cwd=root,
        env=dict(os.environ, PYTHON=sys.executable, N_MESH="2",
                 N_SAMPLES="5", OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return {v: str(root / "data" / v) for v in ("dirichlet", "mixed")}


def test_factory_script_writes_both_variants(data):
    for variant, path in data.items():
        assert np.load(os.path.join(path, "sol.npy"),
                       allow_pickle=True).shape[0] == 10
    assert os.path.exists(os.path.join(data["dirichlet"], "A_prime.npy"))


def test_relaunch_cmd_and_pid_file(tmp_path, data, capsys):
    """After a one-epoch run ``relaunch.cmd`` splits back into the port's
    CLI and the run's arguments with one ``--resume``, at the running
    checkpoint, and ``trainer.pid`` is gone."""
    out = str(tmp_path / "run")
    argv = ["--path_dataset", data["dirichlet"], "--path_results", out,
            "--max_epochs", "1", "--batch_size", "3", *FAST]
    main(argv)
    assert "Training finished" in capsys.readouterr().out
    with open(os.path.join(out, "relaunch.cmd")) as f:
        cmd = shlex.split(f.read())
    running = os.path.join(out, "ckpt", "running_model.ckpt")
    assert cmd == [sys.executable, "-m", MATCH, *argv, "--resume", running]
    assert not os.path.exists(os.path.join(out, "trainer.pid"))
    # a resumed run writes the same command
    main([*argv[:5], "2", *argv[6:], "--resume", running])
    with open(os.path.join(out, "relaunch.cmd")) as f:
        again = shlex.split(f.read())
    assert again.count("--resume") == 1 and again[-1] == running
    assert len(load_jax_checkpoint(os.path.join(
        out, "ckpt", "final_model.ckpt"))["hist_val"]["loss"]) == 2


def test_relaunch_argv_drops_every_earlier_resume():
    got = relaunch_argv(["--resume", "a", "--k", "3", "--resume=b",
                         "--path_results", "r x"], "r x")
    assert got[3:] == ["--k", "3", "--path_results", "r x", "--resume",
                       os.path.join("r x", "ckpt", "running_model.ckpt")]
    assert shlex.split(shlex.join(got)) == got


def test_pid_file_is_removed_when_the_run_fails(tmp_path, monkeypatch):
    from psignn_tpu_torch.cli import main as cli

    def boom(args, plan):
        assert os.path.exists(os.path.join(args.path_results,
                                           "trainer.pid"))
        raise RuntimeError("boom")

    monkeypatch.setattr(cli, "_launch", boom)
    out = str(tmp_path / "run")
    with pytest.raises(RuntimeError):
        main(["--path_results", out, "--device", "cpu"])
    assert os.listdir(out) == ["relaunch.cmd"]


def test_multi_rank_run_files_are_the_launchers(tmp_path, monkeypatch):
    """With ``--num_devices`` the launcher writes ``trainer.pid`` (its own
    PID) before it spawns the ranks, and removes it after."""
    from psignn_tpu_torch.dist import multihost
    out = str(tmp_path / "run")
    pid_file = os.path.join(out, "trainer.pid")
    seen = {}

    def spawn(fn, n, args, timeout=None):
        with open(pid_file) as f:
            seen.update(pid=f.read(), ranks=n)

    monkeypatch.setattr(multihost, "spawn", spawn)
    main(["--path_results", out, "--num_devices", "2", "--device", "cpu"])
    assert seen == dict(pid=str(os.getpid()), ranks=2)
    assert not os.path.exists(pid_file)
    with open(os.path.join(out, "relaunch.cmd")) as f:
        assert "--num_devices 2" in f.read()


def test_guard_clears_run_files_and_refuses_foreign_ones(tmp_path, data,
                                                         capsys):
    """A fresh run clears an earlier run's ``trainer.pid`` and
    ``relaunch.cmd`` with its ``ckpt/`` and ``logs/``, and still refuses a
    directory holding anything else: the JAX run's
    ``results/psignn_dirichlet/`` (its own ``trainer.pid``,
    ``relaunch.cmd`` and ``eval/``) is left as it was."""
    out = tmp_path / "run"
    (out / "logs").mkdir(parents=True)
    (out / "logs" / "old.csv").write_text("old")
    (out / "trainer.pid").write_text("999999")
    (out / "relaunch.cmd").write_text("false")
    main(["--path_dataset", data["dirichlet"], "--path_results", str(out),
          "--max_epochs", "1", "--batch_size", "3", *FAST])
    assert sorted(os.listdir(out)) == ["ckpt", "logs", "relaunch.cmd"]
    assert not (out / "logs" / "old.csv").exists()
    assert MATCH in (out / "relaunch.cmd").read_text()

    jax_run = os.path.join(ROOT, "results", "psignn_dirichlet")
    before = {n: os.path.getmtime(os.path.join(jax_run, n))
              for n in os.listdir(jax_run)}
    assert {"trainer.pid", "relaunch.cmd", "eval"} <= set(before)
    with pytest.raises(SystemExit) as e:
        main(["--path_dataset", data["dirichlet"], "--path_results",
              jax_run, "--max_epochs", "1", *FAST])
    assert e.value.code == 2
    assert "eval" in capsys.readouterr().err
    assert {n: os.path.getmtime(os.path.join(jax_run, n))
            for n in os.listdir(jax_run)} == before


# ------------------------------------------------------ stand-in trainers


def _stand_in(tmp_path, name: str, module: str = MATCH, child: bool = False):
    """A process whose command line names ``module``, with a run
    directory ``<tmp>/<name>/`` holding its ``trainer.pid``, a stale
    ``logs/train_metrics.csv`` and a ``relaunch.cmd`` that writes
    ``<tmp>/<name>.relaunched``; with ``child``, it starts a child
    process first (as ``--num_devices`` starts its ranks).  Returns
    (process, child pid or None)."""
    code = ("import subprocess, sys, time\n"
            "if sys.argv[1] == 'child':\n"
            "    p = subprocess.Popen(['sleep', '300'])\n"
            "    print(p.pid, flush=True)\n"
            "else:\n"
            "    print(0, flush=True)\n"
            "time.sleep(300)\n")
    proc = subprocess.Popen([sys.executable, "-c", code,
                             "child" if child else "none", module],
                            stdout=subprocess.PIPE, text=True)
    kid = int(proc.stdout.readline()) or None
    run = tmp_path / name
    (run / "logs").mkdir(parents=True)
    (run / "trainer.pid").write_text(str(proc.pid))
    log = run / "logs" / "train_metrics.csv"
    log.write_text("Train Metrics")
    old = time.time() - 100
    os.utime(log, (old, old))
    marker = tmp_path / f"{name}.relaunched"
    (run / "relaunch.cmd").write_text(f"echo ok > {shlex.quote(str(marker))}")
    return proc, kid


def _state(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(") ", 1)[1].split()[0]
    except FileNotFoundError:
        return "gone"


def _alive(pid: int) -> bool:
    return _state(pid) not in ("gone", "Z", "X")


def test_watchdog_kills_and_relaunches_only_its_stale_trainer(tmp_path):
    """``train_watchdog.sh`` at CHECK_S=1 STALE_S=1: the stale port
    trainer and its child are killed, its ``trainer.pid`` removed and its
    ``relaunch.cmd`` run; a stopped (T) port trainer and a JAX trainer
    (``psignn_tpu.cli.main``) with stale logs are left alone."""
    stale, kid = _stand_in(tmp_path, "stale", child=True)
    paused, _ = _stand_in(tmp_path, "paused")
    jax, _ = _stand_in(tmp_path, "jax", module="psignn_tpu.cli.main")
    os.kill(paused.pid, signal.SIGSTOP)
    watchdog = subprocess.Popen(
        ["bash", os.path.join(TORCH, "train_watchdog.sh")],
        env=dict(os.environ, CHECK_S="1", STALE_S="1",
                 RESULTS=str(tmp_path)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60
        while not (tmp_path / "stale.relaunched").exists():
            assert time.monotonic() < deadline, "no relaunch"
            time.sleep(0.2)
        assert stale.wait(10) != 0
        assert not _alive(kid)
        assert not (tmp_path / "stale" / "trainer.pid").exists()
        time.sleep(2)        # another round of the watchdog
        assert _state(paused.pid) == "T" and _alive(jax.pid)
        assert not (tmp_path / "paused.relaunched").exists()
        assert not (tmp_path / "jax.relaunched").exists()
    finally:
        watchdog.kill()
        watchdog.wait()
        os.kill(paused.pid, signal.SIGCONT)
        for p in (stale, paused, jax):
            p.kill()
            p.wait()
        if kid and _alive(kid):
            os.kill(kid, signal.SIGKILL)
    log = watchdog.stdout.read()
    assert log.count("restarting pid") == 1 and str(stale.pid) in log


def test_quiet_card_pauses_port_trainers_and_their_ranks(tmp_path):
    """``with_quiet_card.sh`` stops a port trainer and its child while the
    command runs, leaves a JAX trainer running, and resumes them after."""
    port, kid = _stand_in(tmp_path, "port", child=True)
    jax, _ = _stand_in(tmp_path, "jax", module="psignn_tpu.cli.main")
    seen = tmp_path / "states.json"
    probe = ("import json\n"
             "def state(p):\n"
             "    with open(f'/proc/{p}/stat') as f:\n"
             "        return f.read().rsplit(') ', 1)[1].split()[0]\n"
             f"json.dump([state(p) for p in ({port.pid}, {kid}, "
             f"{jax.pid})], open({str(seen)!r}, 'w'))\n")
    try:
        proc = subprocess.run(
            ["bash", os.path.join(TORCH, "with_quiet_card.sh"),
             sys.executable, "-c", probe],
            env=dict(os.environ, RESULTS=str(tmp_path)),
            capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        states = json.loads(seen.read_text())
        assert states[:2] == ["T", "T"] and states[2] != "T"
        assert "T" not in (_state(port.pid), _state(kid))
    finally:
        for p in (port, jax):
            p.kill()
            p.wait()
        if _alive(kid):
            os.kill(kid, signal.SIGKILL)


@pytest.mark.parametrize("script", ["with_quiet_card.sh",
                                    "train_watchdog.sh", "solo_epoch.sh"])
def test_descendants_survive_process_churn(script):
    """Each script's ``descendants`` finds a child under a churn of
    short-lived processes: one that exits between the ``/proc`` glob and
    its read must not end the scan (awk stopped at such a file and found
    the child in 3 of 40 scans)."""
    text = open(os.path.join(TORCH, script)).read()
    start = text.index("descendants() {")
    func = text[start:text.index("\n}\n", start) + 3]
    churn = [subprocess.Popen(["bash", "-c", "while :; do /bin/true; done"])
             for _ in range(2)]
    parent = subprocess.Popen(["bash", "-c", "sleep 300 & echo $!; wait"],
                              stdout=subprocess.PIPE, text=True)
    try:
        kid = parent.stdout.readline().strip()
        for _ in range(5):
            found = subprocess.run(
                ["bash", "-c", func + f"descendants {parent.pid}"],
                capture_output=True, text=True, timeout=60).stdout.split()
            assert kid in found, (script, kid, found)
    finally:
        for p in churn:
            p.kill()
            p.wait()
        subprocess.run(["pkill", "-P", str(parent.pid)])
        parent.kill()
        parent.wait()


# ------------------------------------------------------------ protocols


def test_warm_start_copies_the_autoencoder_and_resumes(tmp_path, data):
    """``make_warmae_ckpt.py``: the Ψ-GNN checkpoint's encoder and decoder
    bit for bit, fresh DS-GPS weights elsewhere, epoch 0; the DS-GPS
    Dirichlet protocol resumes from it for one epoch on the CPU."""
    warm_mod = chip_smoke._load_script_module("make_warmae_ckpt")
    path = warm_mod.main(["--out", str(tmp_path / "warm")])
    warm = load_jax_checkpoint(path)
    psi = load_jax_checkpoint(warm_mod.PSIGNN_CKPT)["params"]["autoencoder"]
    for part in ("encoder", "decoder"):
        got, want = warm["params"]["autoencoder"][part], psi[part]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    assert warm["epoch"] == 0 and warm["hist_val"]["loss"] == []
    # a Ψ-GNN checkpoint the port wrote serves as well
    psi_run = str(tmp_path / "psignn")
    main(["--path_dataset", data["dirichlet"], "--path_results", psi_run,
          "--max_epochs", "1", "--batch_size", "3", *FAST])
    port_ckpt = os.path.join(psi_run, "ckpt", "final_model.ckpt")
    ported = load_jax_checkpoint(warm_mod.main(
        ["--psignn", port_ckpt, "--out", str(tmp_path / "warm_port")]))
    want = load_jax_checkpoint(port_ckpt)["params"]["autoencoder"]
    for part in ("encoder", "decoder"):
        for g, w in zip(ported["params"]["autoencoder"][part], want[part]):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    out = str(tmp_path / "dsgps")
    (cmd,) = chip_smoke.script_commands(
        os.path.join(TORCH, "train_dsgps_dirichlet.sh"),
        dict(DATA=data["dirichlet"], OUT=out, WARM=f"--resume {path}"))
    main(cmd["argv"] + ["--max_epochs", "1", "--batch_size", "3",
                        "--device", "cpu"])
    final = load_jax_checkpoint(os.path.join(out, "ckpt",
                                             "final_model.ckpt"))
    assert len(final["hist_val"]["loss"]) == 1
    assert np.isfinite(final["hist_val"]["residual_loss"][0])


def test_kill_and_relaunch_resumes(tmp_path, data):
    """The smoke's kill and relaunch on the CPU at batch 3 (the solves
    capped at 25 steps): the Ψ-GNN Dirichlet protocol killed after its
    first epoch, relaunched from its ``relaunch.cmd``; three epochs in
    all, each validated once."""
    rec = chip_smoke.ops_kill_relaunch(
        data, str(tmp_path), "cpu", extra=["--batch_size", "3", *FAST[:-2]],
        env=dict(OMP_NUM_THREADS="1"))
    assert rec["epochs"] == 3 and rec["validated"] == [1, 1, 1]
    assert rec["pid_file_after_kill"] and not rec["pid_file_left"]


def test_eval_trained_writes_under_results_torch(tmp_path, data):
    """``eval_trained.sh --device cpu`` writes each run's table under
    EVAL_OUT/<run>/, with the JAX package's numbers' keys, and nothing
    into results/<run>/eval/."""
    jax_tables = {run: os.path.getmtime(os.path.join(
        ROOT, "results", run, "eval", "test_metrics.json"))
        for _, run in chip_smoke.EVAL_RUNS
        if os.path.exists(os.path.join(ROOT, "results", run, "eval",
                                       "test_metrics.json"))}
    proc = subprocess.run(
        ["bash", os.path.join(TORCH, "eval_trained.sh"), "--device", "cpu"],
        env=dict(os.environ, PYTHON=sys.executable, DATA=data["dirichlet"],
                 EVAL_OUT=str(tmp_path), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for _, run in chip_smoke.EVAL_RUNS:
        with open(tmp_path / run / "test_metrics.json") as f:
            table = json.load(f)
        assert np.isfinite(table["mse_mean"]) and "res_mean" in table
    assert {run: os.path.getmtime(os.path.join(
        ROOT, "results", run, "eval", "test_metrics.json"))
        for run in jax_tables} == jax_tables
