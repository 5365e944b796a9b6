#!/usr/bin/env python3
"""Fold a torch_probe_configs winner into the card's configs file,
``sddmm_tpu_torch/tuned_configs_h100.json``: the counterpart of
scripts/update_tuned_configs.py, importing nothing of JAX.

Parses the last ``winner: [tag]`` line of a probe log (the JAX script's
``parse_tag`` and ``winner_of``, so a log of either package folds) and
writes the config of that tag for (matrix, K) through
``sddmm_tpu_torch.bench.save_tuned``, whose ``_comment`` names the card
and its power limit (``nvidia-smi``, or "cpu" under ``--device cpu``) and
the probe log.  The JAX script writes ``results/tuned_configs.json``; this
one never does.

Usage:
    python scripts/torch_update_tuned_configs.py \\
        --matrix clustered16 --k 128 LOG
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CONFIGS = ROOT / "sddmm_tpu_torch" / "tuned_configs_h100.json"
#: the JAX package's configs, which the port only reads
REFERENCE_CONFIGS = ROOT / "results" / "tuned_configs.json"


def parse_tag(tag: str) -> dict:
    m = re.match(r"a=([\d.]+) d=([\d.]+) G=(\d+) C=(\d+) H=(\d+)", tag)
    if not m:
        raise ValueError(f"unparseable winner tag: {tag!r}")
    cfg = {"alpha": float(m.group(1)), "delta": float(m.group(2)),
           "g": int(m.group(3)), "c": int(m.group(4)),
           "merge": True}
    hub = int(m.group(5))
    if hub:
        cfg["hub"] = hub
    if " pallas" in tag:
        cfg["pallas"] = True
    if " apanels" in tag:
        cfg["a_layout"] = "panels"
    if " nomerge" in tag:
        cfg["merge"] = False
    if " legacy-carve" in tag:
        cfg["window_dp"] = False
    m = re.search(r" sort=(\w+)", tag)
    if m and m.group(1) != "cid":
        cfg["sort_runs"] = m.group(1)
    m = re.search(r" sortres=(\w+)", tag)
    if m and m.group(1) != "csr":
        cfg["sort_res"] = m.group(1)
    m = re.search(r" bscale=([\d.]+)", tag)
    if m and float(m.group(1)) != 1.0:
        cfg["b_cost_scale"] = float(m.group(1))
    m = re.search(r" rowslab=(\d+)", tag)
    if m and int(m.group(1)):
        cfg["rowslab"] = int(m.group(1))
    m = re.search(r" rowslabpre=(\d+)", tag)
    if m and int(m.group(1)):
        cfg["rowslab_pre"] = int(m.group(1))
    m = re.search(r" (float32|mixed|float16|bfloat16)$", tag)
    if m:
        cfg["dtype"] = m.group(1)
    return cfg


def winner_of(log_path: Path) -> str:
    tag = None
    for line in log_path.read_text().splitlines():
        m = re.match(r"winner: \[(.+)\] [\d.]+ ms", line)
        if m:
            tag = m.group(1)
    if tag is None:
        raise ValueError(f"no winner line in {log_path}")
    return tag


def writable(path: Path) -> Path:
    """``path``, unless it is the JAX package's configs file."""
    if Path(path).resolve() == REFERENCE_CONFIGS.resolve():
        raise ValueError(f"{path} is the JAX package's configs file, which "
                         "the port never writes")
    return Path(path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("log", type=Path)
    p.add_argument("--matrix", required=True)
    p.add_argument("--k", type=int, required=True)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device whose card the file names; 'cpu' "
                        "only when asked for")
    args = p.parse_args(argv)

    from sddmm_tpu_torch import bench
    from sddmm_tpu_torch.ops.hybrid import check_device

    dev = check_device(args.device)
    path = CONFIGS
    tag = winner_of(args.log)
    cfg = parse_tag(tag)
    key = f"k{args.k}"
    try:
        old = json.loads(path.read_text()).get(key, {}).get(args.matrix)
    except (OSError, json.JSONDecodeError):
        old = None
    print(f"{key}/{args.matrix}: {old} -> {cfg}")
    if not args.dry_run:
        bench.save_tuned(path, args.k, args.matrix, cfg,
                         bench.card_label(dev),
                         made_by=f"Folded from {args.log.name} by "
                                 "scripts/torch_update_tuned_configs.py")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
