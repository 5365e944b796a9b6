#!/usr/bin/env bash
# The port's harness results on the card, written under OUT:
#   torch_synth_suite_logs/   the breadth suite (torch_make_synth_suite.py's
#                             corpus): csr, dense and bsmr at K 32, 64, 128
#                             and 256 (--measure --validate), the two
#                             single-path ablations at K=128 (--validate)
#   torch_matched_clone_logs/ the 18 matched clones at K=128: csr and bsmr
#                             (--measure --validate)
#   torch_matched_clones.csv  their table against the reference's RTX 4090
#   torch_scaling.json        the sharded runner at 1, 2 and 4 ranks
#   torch_calibrated/         stage calibrated: the breadth suite at K=128
#                             (csr and bsmr --measure --validate, the two
#                             ablations --validate) with the layout model
#                             calibrated (SDDMM_TPU_CALIBRATION=CAL, by
#                             default sddmm_tpu_torch/calibration_h100.json),
#                             its tables; stage fit: torch_calibration_fit.py
#                             into torch_calibrated/fit (the bench's
#                             --retune and three corpus shoot-outs in turns,
#                             shipped and calibrated, and the suite's summary)
# Matrices are generated from the seeds in the repo into WORK (default a
# new temporary directory) and never kept.  Each stage resumes from the
# logs already under OUT (--resume), so a run cut by a time limit goes on
# where it stopped; K=128 first, the other Ks last.
#
# Usage: bash scripts/torch_harness_results.sh OUT [WORK] [STAGE ...]
#   STAGE: k128 clones scaling other_ks (default: all four, in that order),
#   calibrated, fit
set -euo pipefail
OUT=${1:?usage: torch_harness_results.sh OUT [WORK] [STAGE ...]}
WORK=${2:-$(mktemp -d)}
shift $(( $# < 2 ? $# : 2 ))
STAGES=${*:-k128 clones scaling other_ks}
HERE=$(cd "$(dirname "$0")" && pwd)
CAL=${CAL:-$HERE/../sddmm_tpu_torch/calibration_h100.json}
mkdir -p "$OUT" "$WORK"

suite() {
  [ -d "$WORK/synth" ] || python "$HERE/torch_make_synth_suite.py" \
    "$WORK/synth"
}

for stage in $STAGES; do
  echo "[stage] $stage $(date -u +%T)"
  case $stage in
    k128)
      suite
      python "$HERE/torch_run_baselines.py" "$WORK/synth" \
        "$OUT/torch_synth_suite_logs" --ks 128 --tools csr dense bsmr \
        --measure --validate --resume
      python "$HERE/torch_run_baselines.py" "$WORK/synth" \
        "$OUT/torch_synth_suite_logs" --ks 128 \
        --tools bsmr_dense_only bsmr_residual_only --validate --resume
      ;;
    clones)
      [ -d "$WORK/clones" ] || python "$HERE/torch_make_matched_clones.py" \
        "$WORK/clones"
      python "$HERE/torch_run_baselines.py" "$WORK/clones" \
        "$OUT/torch_matched_clone_logs" --ks 128 --tools csr bsmr \
        --measure --validate --resume
      python "$HERE/torch_matched_clone_report.py" "$WORK/clones" \
        "$OUT/torch_matched_clone_logs" --k 128 \
        -o "$OUT/torch_matched_clones.csv"
      ;;
    scaling)
      python "$HERE/torch_scaling_bench.py" --devices 1 2 4 \
        | tee "$OUT/torch_scaling.log"
      tail -n 1 "$OUT/torch_scaling.log" > "$OUT/torch_scaling.json"
      ;;
    other_ks)
      suite
      python "$HERE/torch_run_baselines.py" "$WORK/synth" \
        "$OUT/torch_synth_suite_logs" --ks 32 64 256 \
        --tools csr dense bsmr --measure --validate --resume
      ;;
    calibrated)
      suite
      SDDMM_TPU_CALIBRATION=$CAL python "$HERE/torch_run_baselines.py" \
        "$WORK/synth" "$OUT/torch_calibrated/torch_synth_suite_logs" \
        --ks 128 --tools csr bsmr --measure --validate --resume
      SDDMM_TPU_CALIBRATION=$CAL python "$HERE/torch_run_baselines.py" \
        "$WORK/synth" "$OUT/torch_calibrated/torch_synth_suite_logs" \
        --ks 128 --tools bsmr_dense_only bsmr_residual_only --validate \
        --resume
      python "$HERE/torch_analyze_results.py" \
        "$OUT/torch_calibrated/torch_synth_suite_logs" --k 128 --hybrid
      ;;
    fit)
      python "$HERE/torch_calibration_fit.py" "$OUT/torch_calibrated/fit" \
        --calibration "$CAL" \
        --baselines-logs "$OUT/torch_calibrated/torch_synth_suite_logs"
      ;;
    *)
      echo "unknown stage $stage" >&2
      exit 2
      ;;
  esac
done
echo "[done] $(date -u +%T)"
