#!/bin/bash
# Watchdog for the PyTorch/CUDA port's long-running trainers.  Every
# CHECK_S seconds, any run under RESULTS/*/ or RESULTS/torch/*/ (default
# RESULTS=results) whose logs/train_metrics.csv has not moved for STALE_S
# seconds gets its recorded PID killed — the exact PID from
# <run>/trainer.pid, verified against /proc/<pid>/cmdline
# (psignn_tpu_torch.cli.main), never pattern-matched, with every process
# under it (a --num_devices run's ranks) — and is relaunched from
# <run>/relaunch.cmd, which the port's CLI writes (it resumes from
# running_model.ckpt).  The relaunch's output goes to
# <run>/logs/watchdog_relaunch.log.
#
# A trainer in state T (stopped) is skipped: with_quiet_card.sh paused it
# on purpose, and its log is stale for that reason.
#
# Usage:  nohup bash scripts/torch/train_watchdog.sh > logs/watchdog_torch.log 2>&1 &
cd "$(dirname "$0")/../.."
CHECK_S=${CHECK_S:-600}
STALE_S=${STALE_S:-2400}
RESULTS=${RESULTS:-results}
MATCH=psignn_tpu_torch.cli.main

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

while true; do
  sleep "$CHECK_S"
  now=$(date +%s)
  for pf in "$RESULTS"/*/trainer.pid "$RESULTS"/torch/*/trainer.pid; do
    [ -f "$pf" ] || continue
    run=$(dirname "$pf")
    pid=$(cat "$pf")
    case "$pid" in ''|*[!0-9]*) continue;; esac
    tr '\0' ' ' < "/proc/$pid/cmdline" 2>/dev/null | grep -q "$MATCH" || continue
    state=$(awk '{print $3}' "/proc/$pid/stat" 2>/dev/null)
    [ "$state" = "T" ] && continue
    log="$run/logs/train_metrics.csv"
    [ -f "$log" ] || continue
    age=$(( now - $(stat -c %Y "$log") ))
    if [ "$age" -gt "$STALE_S" ]; then
      echo "$(date -u +%FT%TZ) watchdog: $run stale ${age}s, restarting pid $pid"
      procs="$pid $(descendants "$pid")"
      kill $procs 2>/dev/null; sleep 5; kill -9 $procs 2>/dev/null
      rm -f "$pf"
      if [ -f "$run/relaunch.cmd" ]; then
        nohup bash -c "$(cat "$run/relaunch.cmd")" \
          >> "$run/logs/watchdog_relaunch.log" 2>&1 &
        echo "$(date -u +%FT%TZ) watchdog: relaunched $run as $!"
      fi
    fi
  done
done
