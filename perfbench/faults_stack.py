"""Read what a stack cell's correctness limits must catch, on the card: the
program with one fault at a time, judged against the plain reference of
the unfaulted configuration.

    python3 perfbench/faults_stack.py --workload <cell> --seeds 1 2 ...
                                      [--faults F ...] [--seconds 0.5]
                                      [--out FILE]

The faults, each a mistake the layer could make: ``no_sink`` (the sinks
left out of the softmax), ``no_rope`` (RoPE left out), ``head_map``
(query head h reading key/value head h // G + 1, the head map shifted by
one group) and ``wider_window`` (the window one position wider); and the
training cells' fault of ``limits.py``, ``half_batch`` (half the batch
left out of the loss, planted in ``loops/train.py``'s ``loss_of``, which
the stack's step calls).  ``--faults`` runs those named (all by default).
Each limit of the cell must be failed by at least one number of every
fault.  Prints one JSON object and writes it to ``--out``.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _patches(ha, train):
    """fault -> (module, attribute, its faulty stand-in): of the layer's
    module ``ha``, or of the training loop's module ``train``."""
    soft, rope, project = ha.segment_softmax_sink, ha.apply_rope, \
        ha.qkv_project
    half = train.loss_of

    def shifted(*a, **kw):
        q, k, v = project(*a, **kw)
        hk = k.shape[0]
        return q, k.roll(-1, 0), v.view(hk, -1, v.shape[1]).roll(
            -1, 0).reshape(v.shape)

    return {"no_sink": (ha, "segment_softmax_sink",
                        lambda flat, sink, *a: soft(flat, None, *a)),
            "no_rope": (ha, "apply_rope", lambda q, k, table, plain=False:
                        (q, k)),
            "head_map": (ha, "qkv_project", shifted),
            "half_batch": (train, "loss_of", lambda outs, ys: half(
                outs[:len(outs) // 2], ys[:len(ys) // 2]))}


FAULTS = ("no_sink", "no_rope", "head_map", "half_batch", "wider_window")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="+", default=None,
                   choices=FAULTS, help="the faults to run (default: all)")
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch
    from perfbench import cells
    if not torch.cuda.is_available():
        print("faults: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cells.cell(args.workload)
    system_mod = cells.system(cell.config["system"])
    loop_mod = cells.loop(cell.traffic["loop"])
    pattern = system_mod.pattern(cell.config, cell.traffic)
    from sddmm_tpu_torch.models import hybrid_attention as ha
    out = {"workload": cell.name, "card": torch.cuda.get_device_name(0),
           "faults": {}}

    def judge(system, seed):
        loop = loop_mod.Loop(system, pattern, cell.config, cell.traffic,
                             device, seed)
        loop.window(args.seconds)
        readings = loop.readings()
        loop.release()
        gc.collect()
        torch.cuda.empty_cache()
        return loop.judge(readings)

    t0 = time.perf_counter()
    chosen = args.faults or FAULTS
    patches = {f: v for f, v in _patches(ha, cells.loop("train")).items()
               if f in chosen}
    if patches:
        system = system_mod.build(cell.config, cell.traffic, pattern, device)
    for fault, (mod, attr, stand_in) in patches.items():
        real = getattr(mod, attr)
        setattr(mod, attr, stand_in)
        try:
            out["faults"][fault] = {s: judge(system, s) for s in args.seeds}
        finally:
            setattr(mod, attr, real)
        print(f"faults: {fault}: {out['faults'][fault]}", file=sys.stderr,
              flush=True)
    system = None
    gc.collect()
    torch.cuda.empty_cache()
    if "wider_window" in chosen:
        wider = cells.merge(cell.config, {"sliding_window":
                                          cell.config["sliding_window"] + 1})
        system = system_mod.build(wider, cell.traffic, pattern, device)
        out["faults"]["wider_window"] = {s: judge(system, s)
                                         for s in args.seeds}
        print(f"faults: wider_window: {out['faults']['wider_window']}",
              file=sys.stderr, flush=True)
    limits = cell.traffic["limits"]
    out["caught"] = {f: all(any(v > limits[k] for k, v in r.items())
                            for r in by_seed.values())
                     for f, by_seed in out["faults"].items()}
    out["seconds"] = time.perf_counter() - t0
    text = json.dumps(out, indent=1, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
