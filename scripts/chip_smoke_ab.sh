#!/usr/bin/env bash
# Run two trees' chip_smoke.py on one CUDA card in the order parent,
# change, change, parent, so that host drift between runs shows as a
# spread and not as a difference between the sides.
#
# Unpack each side into a git-ignored directory first, from the repo root:
#
#   mkdir -p build/ab/parent build/ab/change
#   git archive <parent-commit> | tar -x -C build/ab/parent
#   git add -A && git archive "$(git write-tree)" | tar -x -C build/ab/change
#
# then run, on the machine with the card, from the repo root:
#
#   bash scripts/chip_smoke_ab.sh build/ab/parent build/ab/change [LOGDIR]
#
# Each run's whole output goes to LOGDIR/ab_{p1,c1,c2,p2}.log (LOGDIR
# defaults to build/ab); its card line, main- and long-shape kernel lines
# (B6 also at zamba2's widths, B4 and B2 also at the decode rows, B2's
# store at its timed shapes), full-width serve, train-forward and
# time-split lines are printed.  After each run, scripts/int8_step_profile.py
# (of the tree this script is run from) profiles that side's int8 decode
# steps (kernels and B2 per step) into the same log.  Exits non-zero if
# any run did.
set -u
parent=$1
change=$2
out=$(realpath -m "${3:-build/ab}")
here=$(dirname "$(realpath "$0")")
mkdir -p "$out"
status=0
for run in "p1:$parent" "c1:$change" "c2:$change" "p2:$parent"; do
  tag=${run%%:*}
  dir=${run#*:}
  (cd "$dir" && python3 chip_smoke.py) > "$out/ab_$tag.log" 2>&1
  rc=$?
  python3 "$here/int8_step_profile.py" "$dir" >> "$out/ab_$tag.log" 2>&1
  rc2=$?
  echo "== $tag ($dir) rc=$rc profile rc=$rc2"
  grep -E '^(card:|kernel vs plain \[main|B[1-7] vs plain \[(main|long|decode rows|full cache|prefill chunk|zamba2 widths)|B2 store vs plain \[(dense decode rows \(8|paged)|B6 \[|full-width (serve|train forward|\[)|time split|int8 step profile|\{"ok")' \
    "$out/ab_$tag.log"
  [ "$rc" -eq 0 ] || status=$rc
  [ "$rc2" -eq 0 ] || status=$rc2
done
exit "$status"
