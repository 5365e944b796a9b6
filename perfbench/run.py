"""Run one benchmark cell once and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout.  The cell, its configuration, traffic mix and
per-layer metrics are found by name (``perfbench/cells.py``).  Set-up
builds the program from the configuration (the hand kernels come from the
port's build cache ``sddmm_tpu_torch/_build/``), makes the inputs and
weights on the card from ``--seed`` and warms up the cell's own shapes;
then the loop runs ``--seconds`` seconds.  With ``--trace 0`` the line
holds the cell's end-to-end metrics; with ``--trace 1`` the per-layer
metrics, read from a profiled sub-window, synchronized host probes and
the wall time of the untraced window.  Then the program is freed and what
it produced is judged against the plain reference: every number compared
is printed beside its limit, last on standard error and under ``checks``
at the end of the line.

Without a CUDA card (or with fewer cards than the cell asks for) it exits
2 and prints no result.  ``--rehearse-cpu OVERRIDES`` (a JSON object
merged into the cell's ``config`` and ``traffic``) runs the same path on
the CPU through the kernels' plain versions at the sizes given, for the
tests only: its line says ``"platform": "cpu"``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level modules that must not be loaded in the run's process: JAX and
#: the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "sddmm_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse-cpu", metavar="OVERRIDES", default=None,
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def fail(msg: str, code: int) -> int:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    return code


def device_of(chips: int, rehearse: bool):
    import torch
    if rehearse:
        return torch.device("cpu"), None
    if not torch.cuda.is_available():
        return None, "no CUDA device: torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return None, (f"the cell asks for {chips} cards, "
                      f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0), None


def main(argv=None) -> int:
    args = parse(argv)
    rehearse = args.rehearse_cpu is not None
    from perfbench import cells
    cell = cells.cell(args.workload)
    if rehearse:
        over = json.loads(args.rehearse_cpu)
        cell.config = cells.merge(cell.config, over.get("config", {}))
        cell.traffic = cells.merge(cell.traffic, over.get("traffic", {}))
    device, why = device_of(cell.chips, rehearse)
    if device is None:
        return fail(why, 2)

    import torch
    from perfbench import counts, trace
    system_mod = cells.system(cell.config["system"])
    loop_mod = cells.loop(cell.traffic["loop"])
    pattern = system_mod.pattern(cell.config, cell.traffic)
    system = system_mod.build(cell.config, cell.traffic, pattern, device)
    print(f"perfbench: {cell.name}: pattern {pattern.m}x{pattern.n}, nnz "
          f"{pattern.nnz}; program {json.dumps(system.info)}",
          file=sys.stderr, flush=True)
    loop = loop_mod.Loop(system, pattern, cell.config, cell.traffic,
                         device, args.seed)
    if loop.mode != system.mode:
        return fail(f"the program runs {system.mode}, the configuration "
                    f"states {loop.mode}", 1)
    setup_s = time.perf_counter() - T0

    breakdown = None
    dev = {}
    if not args.trace:
        metrics, attempted = loop.window(args.seconds)
        metrics["setup_s"] = setup_s
    else:
        records = trace.Records(kind=loop.kind)
        t0 = time.perf_counter()
        _, attempted = loop.window(args.seconds)
        records.wall_s = (time.perf_counter() - t0) / max(attempted, 1)
        records.host_s = loop.host_probe(int(cell.traffic["host_calls"]))
        ops = loop.ops()
        records.useful_flops = counts.useful_flops(ops)
        records.least_s = counts.least_s(ops, loop.mode)
        # a share of the card's peak means nothing off the card
        records.peak_flops = (counts.peak_flops(loop.mode)
                              if device.type == "cuda" else 0.0)
        trace.profile(loop.traced_call, int(cell.traffic["profile_calls"]),
                      records)
        metrics = {}
        for m in cell.per_layer:
            value = cells.reader(m["name"])(records)
            if value is not None:
                metrics[m["name"]] = value
        if records.kernels:
            dev = {"busy_s": records.busy_s(),
                   "window_s": records.window_s()}
            breakdown = records.breakdown()

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    on_card = device.type == "cuda"
    device_rec = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips if on_card else 0,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                              if on_card else 0), **dev}

    readings = loop.readings()
    loop.release()
    system = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = loop.judge(readings)
    limits = cell.traffic["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    failed = sum(1 for c in checks.values()
                 if not (math.isfinite(c["value"])
                         and c["value"] <= c["limit"]))

    found = forbidden_modules()
    if found:
        return fail(f"modules of JAX or the JAX package loaded: {found}", 3)
    result = {"correct": failed == 0, "attempted": attempted,
              "failed": failed,
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in metrics.items()},
              "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        print(f"perfbench: check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
