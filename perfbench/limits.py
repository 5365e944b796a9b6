"""Read what a cell's correctness limits are set from, on the card.

    python3 perfbench/limits.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 101 102 103] [--seconds 0.5] [--out FILE]

For each seed of ``--seeds``: the program's numbers after a short window
at the cell's own load (the lower reading is their largest).  For each
seed of ``--control-seeds``: the numbers of each control, the reference
computed in the precisions below the configuration's (``tf32``, then
``bfloat16``) and put in the program's place, and the program with its own
lower path switched on (``--program-control MODE``); for a training cell,
also the fault of half the batch left out of the loss (the upper reading is
the least of these that reads at least three times the lower).  One
process builds the program once; each seed makes its own inputs and
weights.  Prints one JSON object and writes it to ``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--program-control", default=None, metavar="MODE",
                   help="the program's own lower compute mode")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch
    from perfbench import cells
    cell = cells.cell(args.workload)
    if torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("limits: no CUDA device", file=sys.stderr)
        return 2
    system_mod = cells.system(cell.config["system"])
    loop_mod = cells.loop(cell.traffic["loop"])
    pattern = system_mod.pattern(cell.config, cell.traffic)
    system = system_mod.build(cell.config, cell.traffic, pattern, device)
    out = {"workload": cell.name, "info": system.info,
           "card": torch.cuda.get_device_name(0), "program": {},
           "control": {}}

    def run(sys_, config, seed):
        loop = loop_mod.Loop(sys_, pattern, config, cell.traffic, device,
                             seed)
        loop.window(args.seconds)
        return loop

    t0 = time.perf_counter()
    for seed in args.seeds:
        loop = run(system, cell.config, seed)
        out["program"][seed] = loop.judge(loop.readings())
        print(f"limits: program seed {seed}: {out['program'][seed]}",
              file=sys.stderr, flush=True)
    for seed in args.control_seeds:
        loop = run(system, cell.config, seed)
        rec = {}
        for precision in ("tf32", "bfloat16"):
            rec[f"reference_{precision}"] = loop.judge(
                loop.control_readings(precision))
        if loop.kind == "train":
            rec["state_unchanged"] = {"change_gap": 1.0}
            half = loop_mod.loss_of
            loop_mod.loss_of = lambda outs, ys: half(outs[:len(outs) // 2],
                                                     ys[:len(ys) // 2])
            try:
                faulty = run(system, cell.config, seed)
                rec["half_batch"] = faulty.judge(faulty.readings())
            finally:
                loop_mod.loss_of = half
        out["control"][seed] = rec
        print(f"limits: control seed {seed}: {rec}", file=sys.stderr,
              flush=True)
    if args.program_control and args.control_seeds:
        lower = cells.merge(cell.config,
                            {"compute_mode": args.program_control})
        low_sys = system_mod.build(lower, cell.traffic, pattern, device)
        for seed in args.control_seeds:
            loop = run(low_sys, lower, seed)
            out["control"][seed][f"program_{args.program_control}"] = \
                loop.judge(loop.readings())
        print(f"limits: program in {args.program_control}: "
              f"{[out['control'][s] for s in args.control_seeds]}",
              file=sys.stderr, flush=True)
    out["seconds"] = time.perf_counter() - t0
    for name in next(iter(out["program"].values())):
        lower = max(r[name] for r in out["program"].values())
        uppers = [v[name] for rec in out["control"].values()
                  for v in rec.values() if v.get(name, 0) >= 3 * lower]
        out.setdefault("summary", {})[name] = {
            "lower": lower, "upper": min(uppers) if uppers else None}
    text = json.dumps(out, indent=1, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
