#!/bin/bash
# Measure a solo epoch of one PyTorch/CUDA port training run: every other
# port trainer registered under RESULTS/*/ and RESULTS/torch/*/ (default
# RESULTS=results) is paused (SIGSTOP) with every process under it (a
# --num_devices run's ranks), found only through its trainer.pid verified
# against /proc/<pid>/cmdline (psignn_tpu_torch.cli.main), never
# pattern-matched; then the script waits for the target run to finish two
# more epochs (the first may straddle the pause), prints their "Training
# Epoch N finished, took current epoch" lines from its
# logs/train_metrics.csv, and resumes everything on exit.  The watchdog
# (train_watchdog.sh) skips stopped (T) trainers, so the paused runs are
# safe from it.
#
# Exit codes: 0 after two epochs, 1 when the run has no log, 2 when
# TIMEOUT seconds pass first.  The log is read every POLL_S seconds
# (default 20).
#
# Usage: bash scripts/torch/solo_epoch.sh results/torch/<run> [timeout_s]
#        (or results/<run>)
set -u
cd "$(dirname "$0")/../.."
TARGET=${1:?usage: solo_epoch.sh results/torch/<run> [timeout_s]}
TIMEOUT=${2:-2400}
RESULTS=${RESULTS:-results}
POLL_S=${POLL_S:-20}
MATCH=psignn_tpu_torch.cli.main
LINE="finished, took current epoch"
LOG="$TARGET/logs/train_metrics.csv"
[ -f "$LOG" ] || { echo "no $LOG"; exit 1; }

descendants() {  # $1 = pid: every process under it, from /proc/*/stat
  # through cat: a process that exits between the glob and its read must
  # not end the scan (awk stops at the first file it cannot open)
  cat /proc/[0-9]*/stat 2>/dev/null | awk -v root="$1" '
    { pid = $1; sub(/.*\) /, ""); kids[$2] = kids[$2] " " pid }
    END { n = 1; q[1] = root
          for (i = 1; i <= n; i++) {
            m = split(kids[q[i]], k, " ")
            for (j = 1; j <= m; j++) { print k[j]; q[++n] = k[j] } } }'
}

target=$(realpath "$TARGET")
paused=()
for pf in "$RESULTS"/*/trainer.pid "$RESULTS"/torch/*/trainer.pid; do
  [ -f "$pf" ] || continue
  run=$(dirname "$pf")
  [ "$(realpath "$run")" = "$target" ] && continue
  pid=$(cat "$pf")
  case "$pid" in ''|*[!0-9]*) continue;; esac
  tr '\0' ' ' < "/proc/$pid/cmdline" 2>/dev/null | grep -q "$MATCH" || continue
  for p in "$pid" $(descendants "$pid"); do
    kill -STOP "$p" 2>/dev/null && paused+=("$p")
  done
  echo "paused $run ($pid and its processes)"
done

resume() {
  for p in "${paused[@]}"; do kill -CONT "$p" 2>/dev/null; done
  echo "resumed ${#paused[@]} processes"
}
trap resume EXIT
trap 'exit 130' INT
trap 'exit 143' TERM

n0=$(grep -c "$LINE" "$LOG")
want=$((n0 + 2))
t0=$(date +%s)
echo "waiting for 2 epoch completions in $LOG (have $n0)..."
while :; do
  sleep "$POLL_S"
  n=$(grep -c "$LINE" "$LOG")
  now=$(date +%s)
  if [ "$n" -ge "$want" ]; then
    echo "== solo epoch times (the second line is the fully solo one):"
    grep "$LINE" "$LOG" | tail -2
    exit 0
  fi
  if [ $((now - t0)) -gt "$TIMEOUT" ]; then
    echo "timeout after $((now - t0))s with $((n - n0)) completions"
    grep "$LINE" "$LOG" | tail -1
    exit 2
  fi
done
