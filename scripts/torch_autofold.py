#!/usr/bin/env python3
"""Fold a probe run's winners into the card's configs file, after checking
each on the card: the counterpart of scripts/r3_autofold.py, importing
nothing of JAX.

Steps, over the logs that scripts/torch_probe_results.sh writes into one
directory (the folds are the files found there, not a fixed list):
 1. Dense-vs-hybrid arbitration for the bench's dlmc matrix at every K
    that has a ``probe_dense_dlmc_k{K}.log``: the dense class wins if its
    time is under ``DENSE_MARGIN`` (0.95) of the best hybrid's, the
    ``hybrid:`` line of that log or the winner of
    ``probe_configs_dlmc_k{K}.log``, whichever is faster (the JAX rule).
    The dense time is the log's ``dense class:`` line (the port's tile
    kernel over the dense work table, what the bench runs); a log without
    one (the JAX script's) falls back to ``plain dot:``, as JAX reads it.
    The verdict gates the hybrid folds of dlmc.
 2. Every ``probe_configs_{matrix}_k{K}.log`` with a ``winner:`` line
    is weighed against the file's entry for (matrix, K), the incumbent
    (``choose``): the winner replaces it only if the incumbent's event-time
    median exceeds the winner's by more than the larger of the two configs'
    spreads, ``(max - min) / median`` of their rounds in that log (their
    own specs, timed in turns in one process).  An incumbent the log did
    not time, or timed in one round, is kept.  On dlmc a dense incumbent
    that the arbitration ruled out gives way to the winner.  The chosen
    entry is staged, kept or not, so that every entry the fold leaves is
    validated; a log without a winner is skipped with a note.
 3. With ``--validate``, each staged entry is checked on ``--device``
    against the fp64 golden model in CSR order before it is written: a
    hybrid entry through ``cfg_to_spec`` and ``torch_probe_configs.build``
    (the spec runs the exact config: ``cfg_to_spec`` round-trips every
    key), a dense entry through ``DenseSDDMM``; 0 errors are required, and
    a failing entry keeps the file's.  The file is written after every
    accepted entry, through ``bench.save_tuned``, whose ``_comment`` names
    the card and the log directory.  Without ``--validate`` nothing is
    written.

The JAX script's ``cfg_to_spec`` drops ``sort_runs``, ``b_cost_scale``,
``rowslab_pre`` (and ``rowslab``, ``sort_res``, ``dtype``), so its
validation can run another config than the one it writes; this one does
not.  The file written is ``--configs`` (default
``sddmm_tpu_torch/tuned_configs_h100.json``), never
``results/tuned_configs.json``.

Usage:
    python scripts/torch_autofold.py LOG_DIR --validate
    python scripts/torch_autofold.py LOG_DIR --dry-run
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import torch_update_tuned_configs as utc  # noqa: E402

KS = (32, 64, 128, 256)
#: the dense class must beat the best hybrid by more than 5 %
DENSE_MARGIN = 0.95
CONFIGS_LOG = re.compile(r"probe_configs_(\w+)_k(\d+)\.log")
DENSE_LOG = "probe_dense_dlmc_k{k}.log"
_MS = r"([\d.]+) ms"
#: the grid's one-factor neighbours of the committed config
NEIGHBOURS = (("alpha", (0.1, 0.3, 0.5)), ("delta", (0.0, 0.05, 0.1)),
              ("g", (1, 2, 4)), ("c", (1, 2)))
#: powerlaw's slab grid: hub columns x hot rows picked before tiling
SLAB_GRID = ((0, 512, 1024, 2048), (0, 1024))
#: the hybrid configs probed on dlmc beside the shoot-out's winner
DLMC_SPECS = ("a=0.1,d=0.0",)


def cfg_to_spec(cfg: dict) -> str:
    """Committed-config dict -> torch_probe_configs spec string, every key
    kept: ``parse_tag(tag_of(parse_spec(cfg_to_spec(cfg))))`` is ``cfg``
    for a config with ``g``, ``c`` and ``merge``."""
    if cfg.get("dense"):
        raise ValueError("a dense entry has no probe_configs spec")
    parts = [f"a={cfg['alpha']}", f"d={cfg['delta']}",
             f"g={cfg.get('g', 1)}", f"c={cfg.get('c', 1)}"]
    for key, spec_key, default in (
            ("hub", "hub", 0), ("rowslab", "rowslab", 0),
            ("rowslab_pre", "rowslabpre", 0),
            ("sort_runs", "sort", "cid"), ("sort_res", "sortres", "csr"),
            ("b_cost_scale", "bscale", 1.0), ("dtype", "dtype", "tf32")):
        if cfg.get(key, default) != default:
            parts.append(f"{spec_key}={cfg[key]}")
    for key, spec_key, on in (("pallas", "pallas", True),
                              ("a_layout", "apanels", "panels")):
        if cfg.get(key) == on:
            parts.append(f"{spec_key}=1")
    if cfg.get("window_dp") is False:
        parts.append("windowdp=0")
    if cfg.get("merge") is False:
        parts.append("merge=0")
    return ",".join(parts)


def grid_specs(matrix: str, t_cfg: dict, s_cfg=None, h_cfg=None) -> list:
    """The probe grid of one cell as spec strings, each config once: the
    committed config T, the shoot-out's winner S and the card file's entry
    H (each unless it is the dense class), T's one-factor neighbours
    (``NEIGHBOURS``, merge and ``a_layout`` flipped), and on powerlaw T
    over ``SLAB_GRID``."""
    cands = [t_cfg] + [c for c in (s_cfg, h_cfg)
                       if c and not c.get("dense")]
    for key, values in NEIGHBOURS:
        cands += [{**t_cfg, key: v} for v in values]
    cands.append({**t_cfg, "merge": not t_cfg.get("merge", True)})
    flip = dict(t_cfg)
    if flip.pop("a_layout", "rows") != "panels":
        flip["a_layout"] = "panels"
    cands.append(flip)
    if matrix == "powerlaw":
        for hub in SLAB_GRID[0]:
            for pre in SLAB_GRID[1]:
                c = {key: v for key, v in t_cfg.items()
                     if key not in ("hub", "rowslab_pre")}
                c.update({"hub": hub} if hub else {})
                c.update({"rowslab_pre": pre} if pre else {})
                cands.append(c)
    return unique_specs(cfg_to_spec(c) for c in cands)


def unique_specs(specs) -> list:
    """``specs`` in order, each config once."""
    from torch_probe_configs import config_of, parse_spec
    out, seen = [], []
    for spec in specs:
        canon = config_of(parse_spec(spec))
        if canon not in seen:
            seen.append(canon)
            out.append(spec)
    return out


def cell_specs(matrix: str, k: int, retune_json=None,
               configs=None) -> list:
    """The probe grid of (matrix, K) as spec strings: ``grid_specs`` of
    the JAX package's committed config T, the shoot-out's winner S (the
    ``configs`` of the bench's ``--retune`` JSON, its last line, when
    given) and the entry H of the card's file ``configs`` (default the
    committed ``sddmm_tpu_torch/tuned_configs_h100.json``); for a matrix
    whose T is the dense class (dlmc), S, H and ``DLMC_SPECS``."""
    from sddmm_tpu_torch import bench
    s_cfg = None
    if retune_json is not None:
        out = json.loads(Path(retune_json).read_text().strip()
                         .splitlines()[-1])
        s_cfg = out["configs"].get(matrix)
    h_cfg = bench.load_tuned_config(matrix, k, configs or utc.CONFIGS)
    t_cfg = bench.load_tuned_config(matrix, k)
    if t_cfg is None:
        raise ValueError(f"no committed config for {matrix} at K={k}")
    if not t_cfg.get("dense"):
        return grid_specs(matrix, t_cfg, s_cfg, h_cfg)
    specs = [cfg_to_spec(c) for c in (s_cfg, h_cfg)
             if c is not None and not c.get("dense")]
    return unique_specs(specs + list(DLMC_SPECS))


def canon(cfg: dict) -> dict:
    """``cfg`` as the probe's tag gives it back, for comparing configs."""
    from torch_probe_configs import config_of, parse_spec
    return config_of(parse_spec(cfg_to_spec(cfg)))


def medians(log: Path) -> dict:
    """``tag -> (median ms, spread)`` of a probe log's ``--- medians ---``
    block; the spread is ``(max - min) / median`` of the config's rounds,
    None for a config timed in fewer than two."""
    out = {}
    for line in Path(log).read_text().splitlines():
        m = re.match(r"\[(.+)\]: " + _MS + r" \(\d+ GFLOPS\) "
                     r"sessions=\[([^\]]*)\]", line)
        if m:
            med = float(m.group(2))
            rounds = [float(x) for x in m.group(3).split(",") if x.strip()]
            out[m.group(1)] = (med, (max(rounds) - min(rounds)) / med
                               if len(rounds) > 1 and med > 0 else None)
    return out


def choose(log: Path, tag: str, old):
    """``(config, reason)``: the winner ``tag`` of ``log`` if it beats the
    incumbent ``old`` by more than the larger of their spreads in that
    log, else ``old``; a winner equal to ``old``, or with no ``old``,
    stands."""
    new = utc.parse_tag(tag)
    if old is None:
        return new, "no entry to keep"
    if old.get("dense"):
        return old, "dense entry, not timed by this log: kept"
    if canon(new) == canon(old):
        return new, "winner == file's entry"
    times = medians(log)
    if tag not in times:
        return old, "winner not in the medians: entry kept"
    timed = [v for t, v in times.items()
             if canon(utc.parse_tag(t)) == canon(old)]
    if not timed:
        return old, "entry not timed in this log: kept"
    (new_ms, new_spread), (old_ms, old_spread) = times[tag], timed[0]
    if new_spread is None or old_spread is None:
        return old, "one round, no spread: entry kept"
    margin, spread = old_ms / new_ms - 1.0, max(new_spread, old_spread)
    verdict = (f"entry {old_ms:.4f} ms / winner {new_ms:.4f} ms: margin "
               f"{100 * margin:+.1f} % against spread {spread:.3f}")
    if margin > spread:
        return new, verdict + ": winner folds"
    return old, verdict + ": entry kept"


def try_winner(log: Path):
    if not log.exists():
        print(f"  skip {log.name}: missing")
        return None
    try:
        return utc.winner_of(log)
    except ValueError as e:
        print(f"  skip {log.name}: {e}")
        return None


def winner_ms(log: Path):
    """The ms of the last ``winner:`` line of ``log``, or None."""
    ms = None
    if log.exists():
        for line in log.read_text().splitlines():
            m = re.match(r"winner: \[.+\] " + _MS, line)
            if m:
                ms = float(m.group(1))
    return ms


def dense_decision(dense_log: Path, hybrid_logs=(), label: str = "") -> bool:
    """True if the dense class should own dlmc at this K: ``dense_log``'s
    dense time under ``DENSE_MARGIN`` of the fastest of its ``hybrid:``
    line and the winners of ``hybrid_logs``."""
    if not dense_log.exists():
        print(f"  dense {label}: no log, keep hybrid")
        return False
    text = dense_log.read_text()
    m_d = (re.search(r"dense class: " + _MS, text)
           or re.search(r"plain dot: " + _MS, text))
    m_h = re.search(r"hybrid: nS=\d+ res=\d+ " + _MS, text)
    if not (m_d and m_h):
        print(f"  dense {label}: unparseable log, keep hybrid")
        return False
    dense_ms, hybrid_ms = float(m_d.group(1)), float(m_h.group(1))
    for log in hybrid_logs:
        mw = winner_ms(Path(log))
        if mw is not None:
            hybrid_ms = min(hybrid_ms, mw)
    win = dense_ms < DENSE_MARGIN * hybrid_ms
    print(f"  dense {label}: dense {dense_ms:.4f} ms vs hybrid "
          f"{hybrid_ms:.4f} ms -> {'DENSE' if win else 'hybrid'}")
    return win


def folds(log_dir: Path) -> list:
    """``(log, matrix, K)`` of every probe_configs log in ``log_dir``."""
    out = []
    for log in sorted(Path(log_dir).glob("probe_configs_*_k*.log")):
        m = CONFIGS_LOG.fullmatch(log.name)
        if m:
            out.append((log, m.group(1), int(m.group(2))))
    return out


class Validator:
    """Checks configs on one device against the fp64 golden model, each
    bench matrix generated once."""

    def __init__(self, device):
        from sddmm_tpu_torch import bench
        self.device = device
        self._suite = bench.suite(False)
        self._csrs = {}

    def _inputs(self, matrix, k):
        from sddmm_tpu_torch.data import generate
        from sddmm_tpu_torch.ops.reference import sddmm_reference
        if matrix not in self._csrs:
            self._csrs[matrix] = self._suite[matrix]()
        csr = self._csrs[matrix]
        a = generate.make_dense(csr.m, k, seed=1)
        b = generate.make_dense(k, csr.n, seed=2)
        return csr, a, b, sddmm_reference(a, b, csr)

    def check(self, matrix: str, k: int, cfg: dict) -> bool:
        import torch
        from sddmm_tpu_torch.ops.dense import DenseSDDMM
        from sddmm_tpu_torch.utils.check import check_values
        from torch_probe_configs import build, parse_spec

        csr, a, b, golden = self._inputs(matrix, k)
        if cfg.get("dense"):
            print(f"  validate {matrix} k{k}: dense class")
            runner = DenseSDDMM.from_csr(csr, compute_dtype="tf32",
                                         device=self.device)
        else:
            spec = cfg_to_spec(cfg)
            print(f"  validate {matrix} k{k}: {spec}")
            runner, _ = build(csr, k, parse_spec(spec), self.device)
        with torch.no_grad():
            got = runner(a, b=b, order="csr").cpu().numpy()
        res = check_values(golden, got)
        print(f"    contract {'PASS' if res.passed else 'FAIL'} "
              f"errors={res.num_errors}/{res.num_checked} "
              f"max_rel={res.max_rel_err:.2e}")
        return res.passed and res.num_errors == 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("log_dir", type=Path,
                   help="the probe run's logs (torch_probe_results.sh)")
    p.add_argument("--configs", type=Path, default=utc.CONFIGS,
                   help=f"the file to fold into (default {utc.CONFIGS})")
    p.add_argument("--dry-run", action="store_true",
                   help="stage and print, validate and write nothing")
    p.add_argument("--validate", action="store_true",
                   help="check each staged entry on --device; write those "
                        "that pass (without it nothing is written)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)

    from sddmm_tpu_torch import bench
    from sddmm_tpu_torch.ops.hybrid import check_device

    dev = check_device(args.device)
    path = utc.writable(args.configs)
    try:
        data = json.loads(path.read_text())
    except OSError:
        data = {}
    staged = []  # (K, matrix, old, new)
    found = folds(args.log_dir)

    # dense arbitration first: its verdict gates dlmc's hybrid folds
    print("== dense-vs-hybrid arbitration (dlmc) ==")
    dense_owner = {}
    for k in KS:
        log = args.log_dir / DENSE_LOG.format(k=k)
        if log.exists():
            dense_owner[k] = dense_decision(
                log, [f for f, mat, kk in found
                      if mat == "dlmc" and kk == k], f"k{k}")
            if dense_owner[k]:
                staged.append((k, "dlmc", data.get(f"k{k}", {}).get("dlmc"),
                               {"dense": True}))

    print("== folding probe winners ==")
    for log, matrix, k in found:
        if matrix == "dlmc" and dense_owner.get(k):
            print(f"  k{k}/dlmc: dense class owns this cell, skipping "
                  "hybrid fold")
            continue
        tag = try_winner(log)
        if tag is None:
            continue
        old = data.get(f"k{k}", {}).get(matrix)
        if (matrix == "dlmc" and old is not None and old.get("dense")
                and dense_owner.get(k) is False):
            new, why = utc.parse_tag(tag), "the arbitration gave the hybrid"
        else:
            new, why = choose(log, tag, old)
        print(f"  k{k}/{matrix}: {why}"
              + ("" if new == old else f"; {old} -> {new}"))
        staged.append((k, matrix, old, new))

    if args.dry_run or not args.validate:
        print(f"({'dry run' if args.dry_run else 'not validated'}: "
              f"{len(staged)} entries staged, nothing written)")
        return 0

    # validate, then write after every accepted entry: a kill mid-run
    # leaves only validated entries on disk
    print(f"== validating staged entries on {bench.card_label(dev)} ==")
    validator = Validator(dev)
    made_by = (f"Probe winners of {args.log_dir.name}/ "
               "(scripts/torch_probe_results.sh), folded and checked "
               "against fp64 by `scripts/torch_autofold.py --validate`")
    applied = 0
    for k, matrix, old, new in staged:
        if not validator.check(matrix, k, new):
            print(f"  SKIP k{k}/{matrix} (validation failed), keeping {old}")
            continue
        bench.save_tuned(path, k, matrix, new, bench.card_label(dev),
                         made_by=made_by)
        applied += 1
    print(f"wrote {path} ({applied}/{len(staged)} staged entries applied)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
