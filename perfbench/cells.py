"""Find everything a cell needs by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, whose file is
``configs[].file``, and a traffic mix, ``perfbench/traffic/<traffic>.json``.
The configuration's ``system`` names ``perfbench/systems/<system>.py``,
which builds the program under test; the mix's ``loop`` names
``perfbench/loops/<loop>.py``, which drives it.  A per-layer metric's
reader is ``perfbench/metrics/<metric>.py``.  A new cell, configuration,
mix or metric is new files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list    # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` with its configuration and traffic loaded."""
    root = Path(root)
    bench = load_benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def _module(path: Path, name: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _named(folder: str, name: str, root: Path):
    path = Path(root) / "perfbench" / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder[:-1]} {name!r}: {path} is missing")
    return _module(path, f"perfbench.{folder}.{name}")


def system(name: str, root: Path = ROOT):
    """The module that builds the program under test."""
    return _named("systems", name, root)


def loop(name: str, root: Path = ROOT):
    """The module that drives a traffic mix's loop."""
    return _named("loops", name, root)


def reader(metric: str, root: Path = ROOT):
    """The ``read(records)`` function of a per-layer metric."""
    return _named("metrics", metric, root).read


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys put in, nested objects merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = (merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out
