#!/usr/bin/env bash
# The config probes on the card over the bench's five matrices at full size,
# written under OUT (the committed copy is results/torch_probes/):
#   retune_k{K}.json             stage retune: the bench's measured shoot-out
#                                (--retune) at K; its configs are S
#   shootout_configs.json        S at every K, as a configs file
#   probe_configs_{M}_k{K}.log   stage grid: torch_probe_configs on clustered16,
#                                clustered128, powerlaw and banded over the
#                                committed config T, S, the card file's entry
#                                H and T's one-factor neighbours
#                                (torch_autofold.cell_specs)
#   probe_dense_dlmc_k{K}.log    stage dlmc: the dense class against a hybrid,
#   probe_configs_dlmc_k{K}.log  and torch_probe_configs on S and a=0.1,d=0.0
#   probe_variance_{M}_k128.log  stage noise: the spread of each K=128 winner's
#                                (alpha, delta, G, C)
#   tuned_configs_h100.json      stage fold: torch_autofold --validate over
#   autofold.log                 the logs, into a copy of the card's file
#                                (sddmm_tpu_torch/tuned_configs_h100.json)
#                                whose gaps take S, as --tuned-configs runs
#                                them (the bench retunes a cell the file
#                                lacks); copy it over the card's file to
#                                adopt it
#   bench_{T,S,P}_k{K}_{i}.json  stage compare: the bench at each K in turns
#                                T S P P S T (committed, shoot-out, folded)
# Each stage skips what OUT already holds, so a run cut by a time limit goes
# on where it stopped.  KS (default "32 64 128 256") picks the K; DEVICE
# (default cuda) is every script's --device.
#
# Usage: bash scripts/torch_probe_results.sh OUT [STAGE ...]
#   STAGE: retune grid dlmc noise fold compare (default all, in that order)
set -euo pipefail
OUT=${1:?usage: torch_probe_results.sh OUT [STAGE ...]}
shift
STAGES=${*:-retune grid dlmc noise fold compare}
HERE=$(cd "$(dirname "$0")" && pwd)
ROOT=$(cd "$HERE/.." && pwd)
KS=${KS:-32 64 128 256}
DEVICE=${DEVICE:-cuda}
MATS="clustered16 clustered128 powerlaw banded"
mkdir -p "$OUT"
cd "$ROOT"

has_winner() { [ -s "$1" ] && grep -q '^winner: ' "$1"; }

# python SCRIPT ARGS... > LOG, the exit code appended as its last line
logged() {
  local log=$1
  shift
  local rc=0
  python "$@" --device "$DEVICE" > "$log.tmp" || rc=$?
  echo "rc=$rc" >> "$log.tmp"
  mv "$log.tmp" "$log"
}

cell_specs() {  # MATRIX K
  python -c "import sys; sys.path[:0] = ['$HERE']
import torch_autofold as f
print(';'.join(f.cell_specs('$1', $2, '$OUT/retune_k$2.json')))"
}

probe_configs() {  # MATRIX K
  local log=$OUT/probe_configs_$1_k$2.log
  has_winner "$log" && return 0
  logged "$log" "$HERE/torch_probe_configs.py" --matrix "$1" --k "$2" \
    --configs "$(cell_specs "$1" "$2")"
  tail -n 3 "$log"
}

for stage in $STAGES; do
  echo "[stage] $stage $(date -u +%T)"
  case $stage in
    retune)
      for k in $KS; do
        f=$OUT/retune_k$k.json
        [ -s "$f" ] && continue
        python -m sddmm_tpu_torch.bench --retune --k "$k" --device "$DEVICE" \
          > "$f.tmp"
        mv "$f.tmp" "$f"
        python - "$f" "$OUT/shootout_configs.json" "$k" <<'PY'
import json, sys
from pathlib import Path
from sddmm_tpu_torch import bench
out = json.loads(Path(sys.argv[1]).read_text().strip().splitlines()[-1])
for name, cfg in out["configs"].items():
    bench.save_tuned(Path(sys.argv[2]), int(sys.argv[3]), name, cfg,
                     out["device"], made_by="Shoot-out winners of "
                     "`python -m sddmm_tpu_torch.bench --retune` "
                     "(scripts/torch_probe_results.sh)")
print(f"K={sys.argv[3]}: {out['value']} GFLOPS, {out['configs']}")
PY
      done
      ;;
    grid)
      for k in $KS; do
        for m in $MATS; do
          probe_configs "$m" "$k"
        done
      done
      ;;
    dlmc)
      for k in $KS; do
        log=$OUT/probe_dense_dlmc_k$k.log
        grep -q '^dense class: ' "$log" 2>/dev/null || logged "$log" \
          "$HERE/torch_probe_dense_dlmc.py" --k "$k"
        probe_configs dlmc "$k"
      done
      ;;
    noise)
      for m in $MATS; do
        log=$OUT/probe_variance_${m}_k128.log
        grep -q '^min=' "$log" 2>/dev/null && continue
        args=$(python -c "import sys; sys.path[:0] = ['$HERE']
import torch_update_tuned_configs as u
from pathlib import Path
c = u.parse_tag(u.winner_of(Path('$OUT/probe_configs_${m}_k128.log')))
print(f\"--alpha {c['alpha']} --delta {c['delta']} --g {c['g']} --c {c['c']}\")")
        logged "$log" "$HERE/torch_probe_variance.py" --matrix "$m" --k 128 \
          $args
        tail -n 1 "$log"
      done
      ;;
    fold)
      [ -s "$OUT/tuned_configs_h100.json" ] || python - \
        sddmm_tpu_torch/tuned_configs_h100.json "$OUT/shootout_configs.json" \
        "$OUT/tuned_configs_h100.json" <<'PY'
import json, sys
from pathlib import Path
card, shoot = (json.loads(Path(p).read_text()) for p in sys.argv[1:3])
for key, cells in shoot.items():
    if key.startswith("k"):
        for name, cfg in cells.items():
            card.setdefault(key, {}).setdefault(name, cfg)
Path(sys.argv[3]).write_text(json.dumps(card, indent=4) + "\n")
PY
      python "$HERE/torch_autofold.py" "$OUT" --validate --device "$DEVICE" \
        --configs "$OUT/tuned_configs_h100.json" | tee "$OUT/autofold.log"
      ;;
    compare)
      for k in $KS; do
        i=0
        for turn in T S P P S T; do
          i=$((i + 1))
          f=$OUT/bench_${turn}_k${k}_$i.json
          [ -s "$f" ] && continue
          case $turn in
            T) cfgs=() ;;
            S) cfgs=(--tuned-configs "$OUT/shootout_configs.json") ;;
            P) cfgs=(--tuned-configs "$OUT/tuned_configs_h100.json") ;;
          esac
          python -m sddmm_tpu_torch.bench --k "$k" --device "$DEVICE" \
            "${cfgs[@]}" > "$f.tmp"
          mv "$f.tmp" "$f"
          python -c "import json; d = json.loads(open('$f').read().strip().splitlines()[-1]); print('$turn K=$k', d['value'], d['geomean_vs_csr'], d['per_matrix'])"
        done
      done
      ;;
    *)
      echo "unknown stage $stage" >&2
      exit 2
      ;;
  esac
done
echo "[done] $(date -u +%T)"
