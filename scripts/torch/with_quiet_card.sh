#!/bin/bash
# Run a command with the PyTorch/CUDA port's training processes paused
# (SIGSTOP) so that it has the card to itself, then resume them.  The
# trainers are found only through the trainer.pid files the port's CLI
# writes in RESULTS/*/ and RESULTS/torch/*/ (default RESULTS=results),
# each verified against /proc/<pid>/cmdline (psignn_tpu_torch.cli.main) —
# never pattern-matched.  A --num_devices run's pid is its launcher's: the
# launcher and every process under it (its ranks) are paused.
#
# Usage: bash scripts/torch/with_quiet_card.sh <command...>
cd "$(dirname "$0")/../.."
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

PAUSED=()
for pf in "$RESULTS"/*/trainer.pid "$RESULTS"/torch/*/trainer.pid; do
  [ -f "$pf" ] || continue
  pid=$(cat "$pf")
  case "$pid" in ''|*[!0-9]*) continue;; esac
  tr '\0' ' ' < "/proc/$pid/cmdline" 2>/dev/null | grep -q "$MATCH" || continue
  for p in "$pid" $(descendants "$pid"); do
    kill -STOP "$p" 2>/dev/null && PAUSED+=("$p")
  done
done
resume() { for p in "${PAUSED[@]}"; do kill -CONT "$p" 2>/dev/null; done; }
trap resume EXIT INT TERM
[ "${#PAUSED[@]}" -gt 0 ] && sleep 5   # let in-flight kernels drain
"$@"
