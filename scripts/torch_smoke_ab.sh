#!/bin/bash
# chip_smoke.py from two checkouts on one host, one after the other, each
# a `git archive` unpacked in a directory .gitignore lists (build/):
#
#   git archive $(git write-tree) | tar -x -C build/final
#   git archive HEAD | tar -x -C build/ab_parent
#   bash scripts/torch_smoke_ab.sh build/final build/ab_parent
#
# on the machine with the card (one run of the script takes ~14 min).
#
# Prints the card's name and power limit, then each checkout's exit code,
# wall seconds and last line; each run's stdout and stderr go to
# chiprun_out/r_<name>.{log,err}. Exits with the last failing code.
root=$(cd "$(dirname "$0")/.." && pwd)
out=$root/chiprun_out
mkdir -p "$out"
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
dirs=("$@")
[ ${#dirs[@]} -eq 0 ] && dirs=(build/final build/ab_parent)
rc_all=0
for dir in "${dirs[@]}"; do
  tag=$(basename "$dir")
  cd "$root/$dir" || exit 9
  t0=$(python3 -c 'import time; print(time.time())')
  python3 chip_smoke.py > "$out/r_$tag.log" 2> "$out/r_$tag.err"
  rc=$?
  python3 -c "import time; print('$tag rc=$rc wall', time.time() - $t0, 's')"
  tail -1 "$out/r_$tag.log"
  [ $rc -ne 0 ] && rc_all=$rc
done
exit $rc_all
