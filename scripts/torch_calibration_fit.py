#!/usr/bin/env python3
"""How well the layout model's score predicts the card's times, with the
shipped constants and with a calibration from scripts/torch_calibrate.py.

It runs, in turns (shipped, calibrated, calibrated, shipped: the card's
noise is about as large as the differences between the two), at K=128:

- ``python -m sddmm_tpu_torch.bench --retune --k 128`` in a process of its
  own, ``SDDMM_TPU_CALIBRATION`` set to the calibration or unset: the five
  bench matrices' shoot-outs, winners and geomean GFLOPS;
- the measured shoot-out (``autotune(measure=True)``, the bench's
  ``measure_top``) on three regimes of ``scripts/torch_make_synth_suite.py``'s
  corpus that the model loses with the shipped constants
  (``SUITE``), in this process, the constants put back or loaded before
  each turn.

For every shoot-out it compares each finalist's score (``est_ms``) with its
measured time: the median and worst |log(est/measured)|, the Spearman rank
correlation, and whether the measured winner has the model's best score
(a ``use_pallas`` or ``panels`` twin shares its base's score).
``--baselines-logs DIR`` adds the breadth suite's summary from
``scripts/torch_run_baselines.py``'s logs: the geomean of bsmr over csr and
the matrices where a fixed ablation (alpha 0.3, delta 0 or 1.1) beats the
shoot-out's pick.  Everything goes to ``OUT/fit.json``, each run's own JSON
beside it, and the report (``--report`` prints it again from OUT without
running anything: each turn's bench geomean and winners, the fit of each
shoot-out, and the median signed log(est/measured) by finalist class, the
classes the model's terms treat apart).  Start it without
``SDDMM_TPU_CALIBRATION`` set.

Usage:
    python scripts/torch_calibration_fit.py OUT \\
        [--calibration sddmm_tpu_torch/calibration_h100.json] \\
        [--baselines-logs DIR] [--device cuda]
    python scripts/torch_calibration_fit.py OUT --report
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

DEFAULT_CALIBRATION = ROOT / "sddmm_tpu_torch" / "calibration_h100.json"
TURNS = ("shipped", "calibrated", "calibrated", "shipped")
SUITE = ("hypersparse_pure", "powerlaw40", "fineblock_mid")
K = 128
MEASURE_TOP = 3     # the bench's (autotune's default)
#: the layout model's constants ``load_calibration`` replaces
CONSTANTS = ("STREAM_GBPS", "_ROW_RATE_8MB", "_SRC_MB", "_SRC_F",
             "_DOT_G16_MS")
ENV = "SDDMM_TPU_CALIBRATION"


def snapshot() -> dict:
    """A copy of the port's layout-model constants as they stand."""
    import copy
    from sddmm_tpu_torch.reorder import autotune
    return {name: copy.copy(getattr(autotune, name)) for name in CONSTANTS}


def restore(saved: dict) -> None:
    """Put ``snapshot()``'s constants back (the dicts in place, as ``pack``
    reads ``_DOT_G16_MS`` from the module)."""
    import copy
    from sddmm_tpu_torch.reorder import autotune
    for name, value in saved.items():
        if isinstance(value, dict):
            getattr(autotune, name).clear()
            getattr(autotune, name).update(value)
        else:
            setattr(autotune, name, copy.copy(value))


def spearman(x, y) -> float:
    """Spearman's rank correlation of two sequences (ties take their mean
    rank); nan where either is constant."""
    import numpy as np

    def ranks(v):
        v = np.asarray(v, dtype=np.float64)
        order = np.argsort(v, kind="stable")
        r = np.empty(len(v))
        r[order] = np.arange(len(v), dtype=np.float64)
        for val in np.unique(v):
            tie = v == val
            r[tie] = r[tie].mean()
        return r

    rx, ry = ranks(x), ranks(y)
    if len(rx) < 2 or rx.std() == 0 or ry.std() == 0:
        return float("nan")
    return float(np.corrcoef(rx, ry)[0, 1])


def fit_stats(finalists: list) -> dict:
    """The model's fit over one shoot-out's finalists (dicts with
    ``config``, ``est_ms``, ``measured_ms``)."""
    est = [f["est_ms"] for f in finalists]
    meas = [f["measured_ms"] for f in finalists]
    errs = sorted(abs(math.log(e / m)) for e, m in zip(est, meas))
    win = min(finalists, key=lambda f: f["measured_ms"])
    top = min(finalists, key=lambda f: f["est_ms"])
    n = len(errs)
    median = (errs[n // 2] if n % 2
              else 0.5 * (errs[n // 2 - 1] + errs[n // 2]))
    return {"finalists": n, "median_abs_log": median,
            "worst_abs_log": errs[-1], "spearman": spearman(est, meas),
            "top_is_winner": win["est_ms"] == top["est_ms"],
            "winner": win["config"], "winner_ms": win["measured_ms"],
            "top": top["config"], "top_ms": top["measured_ms"]}


def shootout(csr, k: int, measure_top: int, device) -> list:
    """The measured shoot-out's finalists on ``csr``, fastest first."""
    from sddmm_tpu_torch.bench import config_of
    from sddmm_tpu_torch.reorder.autotune import autotune
    win = autotune(csr, k=k, measure=True, measure_top=measure_top,
                   device=device)
    return [{"config": config_of(f, "tf32"), "est_ms": f.est_ms,
             "measured_ms": f.measured_ms} for f in win.shootout]


def run_bench(k: int, calibration, device) -> dict:
    """``python -m sddmm_tpu_torch.bench --retune`` in its own process,
    ``SDDMM_TPU_CALIBRATION`` naming ``calibration`` or unset."""
    env = dict(os.environ)
    env.pop(ENV, None)
    if calibration is not None:
        env[ENV] = str(calibration)
    res = subprocess.run([sys.executable, "-m", "sddmm_tpu_torch.bench",
                          "--retune", "--k", str(k), "--device",
                          str(device)], cwd=ROOT, env=env,
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"bench --retune failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def baselines_summary(log_dir: Path, k: int) -> dict:
    """The breadth suite at K from ``torch_run_baselines.py``'s logs: the
    geomean of bsmr over csr, and the matrices where an ablation beats the
    shoot-out's pick."""
    from torch_analyze_results import collect
    table = collect(log_dir, k)
    rows = {m: r for m, r in table.items() if r.get("bsmr") and r.get("csr")}
    beats = sorted(m for m, r in rows.items()
                   if max(r.get("bsmr_dense_only", 0.0),
                          r.get("bsmr_residual_only", 0.0)) > r["bsmr"])
    logs = [math.log(r["bsmr"] / r["csr"]) for r in rows.values()]
    return {"matrices": len(rows),
            "bsmr_over_csr": math.exp(sum(logs) / len(logs)) if logs
            else float("nan"),
            "ablation_beats_pick": beats}


def finalist_classes(config: dict) -> list:
    """The classes of a finalist's config the model's terms treat apart."""
    out = ["all", "delta 0" if config.get("delta") == 0 else "delta > 0"]
    for key, name in (("hub", "hub slab"), ("rowslab_pre", "hot-row slab"),
                      ("dense", "dense class")):
        if config.get(key):
            out.append(name)
    if config.get("a_layout") == "panels":
        out.append("panels")
    if config.get("c", 1) > 1:
        out.append("C > 1")
    if config.get("merge") is False:
        out.append("no merge")
    return out


def class_errors(shootouts: dict) -> dict:
    """class -> (finalists, median signed log(est/measured)) over every
    finalist of ``shootouts`` (matrix -> finalists)."""
    import statistics
    logs: dict = {}
    for finalists in shootouts.values():
        for f in finalists:
            r = math.log(f["est_ms"] / f["measured_ms"])
            for c in finalist_classes(f["config"]):
                logs.setdefault(c, []).append(r)
    return {c: (len(v), statistics.median(v)) for c, v in logs.items()}


def report(out: Path) -> None:
    """Print the runs under ``out``: each turn's bench geomean and winners,
    the fit of every shoot-out, and the signed error by finalist class."""
    import statistics
    for path in sorted(out.glob("shootouts_*.json")):
        _, i, turn = path.stem.split("_")
        shootouts = json.loads(path.read_text())
        bench = json.loads((out / f"bench_{i}_{turn}.json").read_text())
        print(f"turn {i} {turn}: bench geomean {bench['value']} GFLOPS")
        for name, cfg in bench["configs"].items():
            print(f"  bench {name}: {bench['per_matrix'][name]} GFLOPS, "
                  f"sessions {bench['timing_sessions_ms'][name]} ms, "
                  f"winner {cfg}")
        stats = {name: fit_stats(f) for name, f in shootouts.items()}
        for name, st in stats.items():
            print(f"  fit {name}: {st['finalists']} finalists, median "
                  f"|log| {st['median_abs_log']:.3f}, worst "
                  f"{st['worst_abs_log']:.3f}, spearman "
                  f"{st['spearman']:+.3f}, top is winner "
                  f"{st['top_is_winner']}, winner {st['winner_ms']:.4f} ms")
        print(f"  over {len(stats)} matrices: median of median |log| "
              f"{statistics.median(s['median_abs_log'] for s in stats.values()):.3f}"
              f", median spearman "
              f"{statistics.median(s['spearman'] for s in stats.values()):+.3f}"
              f", top is winner on "
              f"{sum(s['top_is_winner'] for s in stats.values())}")
        print("  signed log(est/measured) by class: " + ", ".join(
            f"{c} {v:+.3f} (n {n})"
            for c, (n, v) in class_errors(shootouts).items()))
    fit = out / "fit.json"
    summary = json.loads(fit.read_text()).get("baselines") \
        if fit.exists() else None
    if summary:
        print(f"breadth suite at K={K}: {summary['matrices']} matrices, "
              f"bsmr over csr {summary['bsmr_over_csr']:.3f}x, an ablation "
              f"beats the pick on {len(summary['ablation_beats_pick'])}: "
              f"{summary['ablation_beats_pick']}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="The layout model's fit to the card's times, shipped "
        "and calibrated.")
    p.add_argument("out", type=Path)
    p.add_argument("--calibration", type=Path, default=DEFAULT_CALIBRATION)
    p.add_argument("--baselines-logs", type=Path, default=None)
    p.add_argument("--report", action="store_true",
                   help="only print the report of the runs under OUT")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)
    if args.report:
        report(args.out)
        return 0

    from sddmm_tpu_torch.ops.hybrid import check_device
    from sddmm_tpu_torch.reorder.autotune import load_calibration

    dev = check_device(args.device)
    if os.environ.get(ENV):
        raise SystemExit(f"unset {ENV}: the shipped turns need the shipped "
                         "constants (pass --calibration instead)")
    cal = json.loads(args.calibration.read_text())
    args.out.mkdir(parents=True, exist_ok=True)
    shipped = snapshot()
    from torch_make_synth_suite import corpus
    gens = corpus()
    csrs = {name: gens[name]() for name in SUITE}
    where = args.calibration.resolve()
    result = {"calibration": str(where.relative_to(ROOT)
                                 if where.is_relative_to(ROOT) else where),
              "card": cal.get("card"),
              "k": K, "measure_top": MEASURE_TOP, "turns": [], "fit": []}
    try:
        for i, turn in enumerate(TURNS):
            calibrated = turn == "calibrated"
            bench = run_bench(K, args.calibration if calibrated else None,
                              dev)
            (args.out / f"bench_{i}_{turn}.json").write_text(
                json.dumps(bench, indent=1) + "\n")
            result["turns"].append({"turn": i, "constants": turn,
                                    "bench_gflops": bench["value"],
                                    "bench_per_matrix": bench["per_matrix"]})
            shootouts = dict(bench["shootout"])
            restore(shipped)
            if calibrated:
                load_calibration(cal)
            for name, csr in csrs.items():
                shootouts[name] = shootout(csr, K, MEASURE_TOP, dev)
            restore(shipped)
            (args.out / f"shootouts_{i}_{turn}.json").write_text(
                json.dumps(shootouts, indent=1) + "\n")
            for name, finalists in shootouts.items():
                result["fit"].append({"turn": i, "constants": turn,
                                      "matrix": name,
                                      **fit_stats(finalists)})
    finally:
        restore(shipped)
    if args.baselines_logs is not None:
        result["baselines"] = baselines_summary(args.baselines_logs, K)
    (args.out / "fit.json").write_text(json.dumps(result, indent=1) + "\n")
    report(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
