"""The port's config probes (``scripts/torch_probe_*.py``,
``torch_update_tuned_configs.py``, ``torch_autofold.py``) against the JAX
package's (``scripts/probe_*.py``, ``update_tuned_configs.py``,
``r3_autofold.py``) on the CPU.

Held exactly: the spec grammar on every spec of the committed queues
(``scripts/*.sh``), the winner and its config on every committed
``results/probe_*.log``, the dlmc arbitration on the committed
``probe_dense_dlmc_*_r3.log``, and the untimed lines (tiles, residual, hub,
cells, contract status, the layout model's score) that the probes print
for the same quick-suite matrix, one round of two iterations each, the JAX
side's Pallas tile dot in interpret mode as its own tests run it.  Times,
the contract's max_rel (JAX's CPU computes ``Precision.HIGH`` in full fp32
where the port keeps the bf16x3 split) and the prep seconds are left out.
The fold is run on a temporary copy of the card's configs file."""

import functools
import hashlib
import json
import re
import shutil
import sys
from pathlib import Path

import jax
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
RESULTS = ROOT / "results"
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(SCRIPTS))

import bench as jbench  # noqa: E402
import probe_configs as j_configs  # noqa: E402
import probe_dtype as j_dtype  # noqa: E402
import probe_hub as j_hub  # noqa: E402
import probe_variance as j_variance  # noqa: E402
import r3_autofold as j_autofold  # noqa: E402
import update_tuned_configs as j_utc  # noqa: E402
import torch_autofold as t_autofold  # noqa: E402
import torch_probe_configs as t_configs  # noqa: E402
import torch_probe_dtype as t_dtype  # noqa: E402
import torch_probe_hub as t_hub  # noqa: E402
import torch_probe_variance as t_variance  # noqa: E402
import torch_update_tuned_configs as t_utc  # noqa: E402

from sddmm_tpu.ops import pallas_tiles  # noqa: E402
from sddmm_tpu_torch import bench as tbench  # noqa: E402
from sddmm_tpu_torch.data import generate as tgen  # noqa: E402
from sddmm_tpu_torch.ops.hybrid import HybridSDDMM  # noqa: E402

# the JAX package's layout model as shipped around each test (the hub
# probe prints its score)
from test_torch_pack_parity import _shipped_layout_model  # noqa: F401,E402
from torch_native_ready import reference_native_loaded  # noqa: F401,E402

CPU = ["--device", "cpu"]
#: the scripts this slice adds
NEW_SCRIPTS = ("torch_probe_configs", "torch_update_tuned_configs",
               "torch_probe_dense_dlmc", "torch_autofold", "torch_probe_hub",
               "torch_probe_dtype", "torch_probe_variance",
               "torch_probe_breakdown", "torch_probe_cluster",
               "torch_probe_csr_order", "torch_probe_gid_order")


def _committed_specs():
    """Every spec of a ``--configs "..."`` in the committed queues (the
    JAX package's ``scripts/*.sh``), each once."""
    pat = re.compile(r'--configs(?:\s|\\\n)*"((?:[^"\\]|\\\n)*)"')
    specs = []
    for path in sorted(SCRIPTS.glob("*.sh")):
        if path.name.startswith("torch_"):
            continue
        for m in pat.finditer(path.read_text()):
            specs += [s.strip() for s in m.group(1).replace("\\\n", "")
                      .split(";") if s.strip()]
    return list(dict.fromkeys(specs))


SPECS = _committed_specs()
LOGS = sorted(p.name for p in RESULTS.glob("probe_*.log"))
WINNER_LOGS = [n for n in LOGS
               if re.search(r"^winner: ", (RESULTS / n).read_text(), re.M)]
NO_WINNER_LOGS = [n for n in LOGS if n not in WINNER_LOGS]
TUNED = json.loads((RESULTS / "tuned_configs.json").read_text())
HYBRID = [(k, m) for k, cells in TUNED.items() if not k.startswith("_")
          for m, cfg in cells.items() if not cfg.get("dense")]
#: the committed hybrid configs whose keys JAX's cfg_to_spec drops
#: (sort_runs, b_cost_scale, rowslab_pre)
JAX_DROPS = {("k32", "clustered128"), ("k32", "powerlaw"),
             ("k64", "clustered16"), ("k64", "clustered128"),
             ("k64", "powerlaw"), ("k128", "clustered16"),
             ("k128", "clustered128"), ("k128", "powerlaw"),
             ("k256", "clustered16"), ("k256", "powerlaw")}


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


def _sha(path):
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """One intra-op thread (the test workers run side by side), and the
    JAX package's Pallas tile dot in interpret mode (the caches cleared
    around it, as tests/test_torch_hybrid.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(pallas_tiles, "tile_dot_padded",
               functools.partial(pallas_tiles.tile_dot_padded,
                                 interpret=True))
    jax.clear_caches()
    yield
    mp.undo()
    jax.clear_caches()
    torch.set_num_threads(n)


@pytest.fixture
def quick_suites(monkeypatch):
    """Both benches' ``suite(False)`` (what the probes read) as the quick
    suite, plus a small dlmc for the port's fold."""
    j_quick, t_quick = jbench.suite(True), tbench.suite(True)
    t_quick["dlmc"] = lambda: tgen.random_sparse(256, 256, density=0.2,
                                                 seed=46)
    monkeypatch.setattr(jbench, "suite", lambda quick: j_quick)
    monkeypatch.setattr(tbench, "suite", lambda quick: t_quick)


def test_committed_specs_found():
    assert len(SPECS) >= 70 and len(WINNER_LOGS) == 48


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_jax(spec):
    """The spec grammar on every committed spec; its config is what
    either package's ``parse_tag`` reads back from the tag."""
    sp = t_configs.parse_spec(spec)
    assert sp == j_configs.parse_spec(spec)
    tag = t_configs.tag_of(sp)
    assert t_configs.config_of(sp) == t_utc.parse_tag(tag) \
        == j_utc.parse_tag(tag)


@pytest.mark.parametrize("name", WINNER_LOGS)
def test_winner_matches_jax(name):
    """``parse_tag(winner_of(log))`` of every committed probe log with a
    winner line, as JAX reads it (a csr-order probe's winner is no config:
    both raise alike)."""
    path = RESULTS / name
    tag = t_utc.winner_of(path)
    assert tag == j_utc.winner_of(path)
    assert _outcome(t_utc.parse_tag, tag) == _outcome(j_utc.parse_tag, tag)


@pytest.mark.parametrize("name", NO_WINNER_LOGS)
def test_winner_of_raises_without_winner(name):
    path = RESULTS / name
    for winner_of in (t_utc.winner_of, j_utc.winner_of):
        with pytest.raises(ValueError, match="no winner line"):
            winner_of(path)


@pytest.mark.parametrize("cell", HYBRID, ids="-".join)
def test_cfg_to_spec_round_trips(cell):
    """config -> spec -> tag -> parse_tag is the config, for every
    committed hybrid config; JAX's cfg_to_spec loses a key on
    ``JAX_DROPS`` (its validation runs another config than it writes)."""
    k, m = cell
    cfg = TUNED[k][m]

    def round_trip(cfg_to_spec, parse_spec):
        return t_utc.parse_tag(t_configs.tag_of(parse_spec(
            cfg_to_spec(cfg))))

    assert round_trip(t_autofold.cfg_to_spec, t_configs.parse_spec) == cfg
    jax_kept = round_trip(j_autofold.cfg_to_spec, j_configs.parse_spec)
    assert (jax_kept == cfg) == (cell not in JAX_DROPS)


def test_jax_cfg_to_spec_fault_count():
    assert len(HYBRID) == 16 and JAX_DROPS <= set(HYBRID)
    assert len(JAX_DROPS) == 10


@pytest.mark.parametrize("k", [32, 64, 128, 256])
def test_dense_decision_matches_jax(k, capsys):
    """The port's arbitration on the committed r3 logs (plain dot against
    the hybrid line and the dlmc probe's winner) reaches JAX's verdict."""
    want = j_autofold.dense_decision(k, {})
    hybrid_logs = [RESULTS / log for log, mat, kk, _ in j_autofold.FOLDS
                   if mat == "dlmc" and kk == k]
    got = t_autofold.dense_decision(
        RESULTS / j_autofold.DENSE_LOGS[k], hybrid_logs, f"k{k}")
    out = capsys.readouterr().out.splitlines()
    assert got == want
    assert out[0].split(": ", 1)[1] == out[1].split(": ", 1)[1]


def test_dense_decision_reads_dense_class(tmp_path):
    """A log with a ``dense class:`` line is judged by it, not by the
    library dot; the margin is the JAX rule's."""
    log = tmp_path / "probe_dense_dlmc_k128.log"
    text = ("hybrid: nS=1024 res=0 1.0000 ms  1 GFLOPS (host prep 1.0s)\n"
            "dense class: {} ms  1 GFLOPS\nplain dot: 0.1000 ms\n")
    log.write_text(text.format("0.9600"))
    assert not t_autofold.dense_decision(log)
    log.write_text(text.format("0.9400"))
    assert t_autofold.dense_decision(log)
    win = tmp_path / "probe_configs_dlmc_k128.log"
    win.write_text("winner: [a=0.1 d=0.0 G=1 C=1 H=0] 0.5000 ms\n")
    assert not t_autofold.dense_decision(log, [win])
    assert not t_autofold.dense_decision(tmp_path / "missing.log")


def _untimed_configs(out):
    lines = []
    for line in out.splitlines():
        if re.match(r"\[.+\] tiles=", line):
            lines.append(re.sub(r" \[\d+s prep\]$", "", line))
        elif re.match(r"\[.+\] contract ", line):
            lines.append(line.split(" max_rel=")[0])
    return lines


def _untimed_hub(out):
    return [re.sub(r"  \[\d+s prep\]$", "", line)
            for line in out.splitlines() if re.match(r"H=\d+: tiles=", line)]


def _untimed_dtype(out):
    return [line.split(" max_rel=")[0] for line in out.splitlines()
            if re.match(r"\w+: tiles=", line)
            or re.match(r"[\w+]+: contract ", line)]


def _untimed_variance(out):
    return [line for line in out.splitlines() if line.startswith("matrix=")]


PROBES = {  # case -> (JAX module, port module, untimed lines, arguments)
    "configs-clustered16": (
        j_configs, t_configs, _untimed_configs,
        ["--matrix", "clustered16", "--k", "32", "--configs",
         "a=0.3,d=0.05;a=0.1,d=0.0,g=2,merge=0;a=0.3,d=0.05,pallas=1,"
         "apanels=1;a=0.2,d=0.05,bscale=2.0,sort=gid;a=0.3,d=0.05,c=2"]),
    "configs-powerlaw": (
        j_configs, t_configs, _untimed_configs,
        ["--matrix", "powerlaw", "--k", "32", "--configs",
         "a=0.1,d=0.05,hub=256,rowslabpre=64;a=0.3,d=0.0,hub=128,apanels=1;"
         "a=0.5,d=0.05,sortres=gid,windowdp=0"]),
    "hub": (j_hub, t_hub, _untimed_hub,
            ["--matrix", "powerlaw", "--k", "32", "--hubs", "0,128,256"]),
    "dtype": (j_dtype, t_dtype, _untimed_dtype,
              ["--matrix", "clustered16", "--k", "32", "--dtypes",
               "tf32,float32,tf32+pallas"]),
    "variance": (j_variance, t_variance, _untimed_variance,
                 ["--matrix", "clustered16", "--k", "32", "--g", "2",
                  "--sessions", "1", "--gap", "0"]),
}


@pytest.mark.parametrize("case", list(PROBES))
def test_probe_untimed_lines_match_jax(case, quick_suites, capsys):
    """The same quick-suite matrix through both packages' probe, one round
    (session) of two iterations: the same packings, contract verdicts and
    layout-model scores, line for line."""
    j_mod, t_mod, untimed, args = PROBES[case]
    timing = (["--rounds", "1"] if case != "variance" else []) + [
        "--iterations", "2"]
    j_mod.main(args + timing)
    want = untimed(capsys.readouterr().out)
    rc = t_mod.main(args + timing + CPU)
    out = capsys.readouterr().out
    assert rc == 0
    assert untimed(out) == want and want
    if t_mod is t_configs:
        assert re.search(r"^winner: \[.+\] [\d.]+ ms$", out, re.M)
        assert "the same program as pallas=0" in out or "pallas" not in \
            args[-1]


def test_probe_configs_fails_a_config_outside_the_contract(quick_suites,
                                                          capsys):
    """A mode that misses the contract by design ("bfloat16") prints
    FAIL, cannot win, and the script exits 1."""
    rc = t_configs.main(["--matrix", "clustered16", "--k", "32",
                         "--rounds", "1", "--iterations", "2", "--configs",
                         "a=0.3,d=0.05;a=0.3,d=0.05,dtype=bfloat16"] + CPU)
    out = capsys.readouterr().out
    assert rc == 1
    assert "[a=0.3 d=0.05 G=1 C=1 H=0 bfloat16] contract FAIL" in out
    assert "winner: [a=0.3 d=0.05 G=1 C=1 H=0] " in out


def test_config_of_folds_like_the_bench(quick_suites):
    """A spec packs as the bench folds its config (``fold_config``), in
    the spec's mode; a lean packing keeps everything the runner reads."""
    csr = tbench.suite(False)["powerlaw"]()
    sp = t_configs.parse_spec("a=0.1,d=0.05,hub=256,rowslabpre=64,"
                              "apanels=1,dtype=float32")
    runner, packed = t_configs.build(csr, 32, sp, "cpu")
    want = tbench.fold_config(csr, 32, t_configs.config_of(sp), "float32")
    assert packed.packed_size == want.packed.packed_size
    assert packed.packed_rows is None and want.packed.packed_rows is not None
    assert (runner.compute_dtype, runner.a_layout) == ("float32", "panels")
    a = tgen.make_dense(csr.m, 32, seed=1)
    b = tgen.make_dense(32, csr.n, seed=2)
    ref = HybridSDDMM(want.packed, compute_dtype="float32", k_chunks=1,
                      a_layout="panels", device="cpu")
    with torch.no_grad():
        assert torch.equal(runner(a, b=b), ref(a, b=b))


def test_grid_specs():
    """The grid of a cell: T, S, the card file's entry H, T's one-factor
    neighbours, each config once; the slab grid on powerlaw."""
    t_cfg = TUNED["k128"]["powerlaw"]
    s_cfg = {"alpha": 0.1, "delta": 0.05, "g": 1, "c": 2, "merge": True}
    h_cfg = {"alpha": 0.5, "delta": 0.0, "g": 1, "c": 1, "merge": False}
    specs = t_autofold.grid_specs("powerlaw", t_cfg, s_cfg, h_cfg)
    cfgs = [t_configs.config_of(t_configs.parse_spec(s)) for s in specs]
    assert cfgs[:3] == [t_cfg, s_cfg, h_cfg]
    assert len(cfgs) == len({json.dumps(c, sort_keys=True) for c in cfgs})
    slab = ("hub", "rowslab_pre")
    for c in cfgs[3:]:
        diff = {k for k in set(c) | set(t_cfg) if c.get(k) != t_cfg.get(k)}
        assert len(diff) == 1 or diff <= set(slab), c
    assert {(c.get("hub", 0), c.get("rowslab_pre", 0)) for c in cfgs[3:]
            if {k for k in set(c) | set(t_cfg)
                if c.get(k) != t_cfg.get(k)} <= set(slab)} >= {
        (h, p) for h in (0, 512, 1024) for p in (0, 1024)}
    banded = t_autofold.grid_specs("banded", TUNED["k128"]["banded"])
    # T, alpha 0.1 / 0.5, delta 0 / 0.1, G 2 / 4, C 2, merge, a_layout
    assert len(banded) == 10
    # S or H equal to T, or the dense class, adds nothing
    assert t_autofold.grid_specs("banded", TUNED["k128"]["banded"],
                                 TUNED["k128"]["banded"],
                                 {"dense": True}) == banded


def test_cell_specs_dlmc(tmp_path):
    """dlmc's committed config is the dense class: its grid is the
    shoot-out's winner and the card file's entry (unless dense) and
    ``DLMC_SPECS``; another matrix's grid starts with T."""
    path = tmp_path / "retune_k64.json"
    card = tmp_path / "h100.json"
    for s_cfg, h_cfg, n in (
            ({"dense": True}, None, 1),
            ({"alpha": 0.1, "delta": 0.0, "g": 1, "c": 1, "merge": True},
             {"dense": True}, 1),
            ({"alpha": 0.3, "delta": 0.0, "g": 1, "c": 1, "merge": True,
              "hub": 4096}, None, 2),
            ({"dense": True}, {"alpha": 0.5, "delta": 0.0, "g": 1, "c": 1,
                               "merge": True}, 2)):
        path.write_text("noise\n" + json.dumps({"configs": {"dlmc": s_cfg}}))
        card.write_text(json.dumps({"k64": {"dlmc": h_cfg}} if h_cfg
                                   else {}))
        specs = t_autofold.cell_specs("dlmc", 64, path, card)
        cfgs = [t_configs.config_of(t_configs.parse_spec(s)) for s in specs]
        assert len(specs) == n and cfgs[-1] == t_configs.config_of(
            t_configs.parse_spec("a=0.1,d=0.0"))
        if h_cfg and not h_cfg.get("dense"):
            assert h_cfg in cfgs
    path.write_text(json.dumps({"configs": {}}))
    assert t_autofold.cell_specs("banded", 64, path, card)[0] == \
        t_autofold.cfg_to_spec(TUNED["k64"]["banded"])


def _medians_log(path, rows):
    """A probe log of ``rows`` (spec, sessions), the least median the
    winner, as torch_probe_configs prints it."""
    lines, best = ["--- medians ---"], None
    for spec, sessions in rows:
        tag = t_configs.tag_of(t_configs.parse_spec(spec))
        med = sorted(sessions)[len(sessions) // 2]
        lines.append(f"[{tag}]: {med:.4f} ms (100 GFLOPS) "
                     f"sessions={sessions} device=0.0100 ms")
        if best is None or med < best[1]:
            best = (tag, med)
    lines.append(f"winner: [{best[0]}] {best[1]:.4f} ms")
    path.write_text("\n".join(lines) + "\n")
    return best[0]


ENTRY = "a=0.5,d=0.0,merge=0"
WIN = "a=0.3,d=0.05,g=2"


@pytest.mark.parametrize("case,rows,folds", [
    ("margin over both spreads", [(ENTRY, [0.2, 0.21, 0.205]),
                                  (WIN, [0.1, 0.101, 0.1])], True),
    ("margin under the entry's spread", [(ENTRY, [0.1, 0.3, 0.2]),
                                         (WIN, [0.15, 0.15, 0.15])], False),
    ("margin under the winner's spread", [(ENTRY, [0.2, 0.2, 0.2]),
                                          (WIN, [0.05, 0.3, 0.15])], False),
    ("one round", [(ENTRY, [0.2]), (WIN, [0.1])], False),
    ("entry not timed", [("a=0.1,d=0.1", [0.2, 0.2, 0.2]),
                         (WIN, [0.1, 0.1, 0.1])], False),
    ("winner is the entry", [(ENTRY, [0.1, 0.3, 0.2]),
                             (WIN, [0.4, 0.4, 0.4])], True),
])
def test_choose_holds_the_winner_to_the_spread(tmp_path, case, rows, folds):
    """The fold keeps the file's entry unless the winner's event-time
    margin over it beats the larger of their spreads in the same log."""
    log = tmp_path / "probe_configs_banded_k64.log"
    tag = _medians_log(log, rows)
    old = t_configs.config_of(t_configs.parse_spec(ENTRY))
    got, why = t_autofold.choose(log, tag, old)
    assert got == (t_utc.parse_tag(tag) if folds else old), (case, why)
    assert t_autofold.choose(log, tag, None)[0] == t_utc.parse_tag(tag)
    assert t_autofold.choose(log, tag, {"dense": True})[0] == {"dense": True}


def test_medians_reads_each_configs_spread(tmp_path):
    log = tmp_path / "probe_configs_banded_k64.log"
    _medians_log(log, [(ENTRY, [0.1, 0.3, 0.2]), (WIN, [0.2])])
    got = t_autofold.medians(log)
    tags = [t_configs.tag_of(t_configs.parse_spec(s)) for s in (ENTRY, WIN)]
    assert got == {tags[0]: (0.2, pytest.approx(1.0)), tags[1]: (0.2, None)}


def _probe_log(tmp, capsys, matrix, configs):
    rc = t_configs.main(["--matrix", matrix, "--k", "32", "--rounds", "1",
                         "--iterations", "2", "--configs", configs] + CPU)
    log = tmp / f"probe_configs_{matrix}_k32.log"
    log.write_text(capsys.readouterr().out)
    return rc, log


def test_autofold_writes_only_validated(tmp_path, quick_suites, capsys):
    """torch_autofold on a temporary copy of the card's file: a winner
    that beats the file's entry by more than their spreads folds, one
    within them keeps the entry, an entry the log did not time stays, a
    winner that fails the contract (bfloat16 on purpose) keeps the file's
    entry, dlmc goes to the dense class by its log, every staged entry is
    checked on the quick suite, and neither committed file changes."""
    logs = tmp_path / "logs"
    logs.mkdir()
    rc, log = _probe_log(logs, capsys, "clustered16",
                         "a=0.3,d=0.05;a=0.1,d=0.0,g=2,merge=0")
    assert rc == 0
    (logs / "probe_configs_powerlaw_k32.log").write_text(
        "winner: [a=0.3 d=0.05 G=1 C=1 H=0 bfloat16] 0.1000 ms\n")
    (logs / "probe_dense_dlmc_k32.log").write_text(
        "hybrid: nS=4 res=0 1.0000 ms\ndense class: 0.5000 ms\n"
        "plain dot: 2.0000 ms\n")
    won = _medians_log(logs / "probe_configs_clustered16_k64.log",
                       [(ENTRY, [0.2, 0.21, 0.205]), (WIN, [0.1, 0.1, 0.1])])
    _medians_log(logs / "probe_configs_powerlaw_k64.log",
                 [(ENTRY, [0.1, 0.3, 0.2]), (WIN, [0.15, 0.15, 0.15])])
    cfgs = tmp_path / "tuned_configs_h100.json"
    shutil.copy(tbench.H100_CONFIGS, cfgs)
    entry = t_configs.config_of(t_configs.parse_spec(ENTRY))
    old = json.loads(cfgs.read_text())
    old.setdefault("k64", {}).update(clustered16=entry, powerlaw=entry)
    old.setdefault("k32", {})["clustered16"] = t_configs.config_of(
        t_configs.parse_spec("a=0.5,d=0.05"))
    # no entry to keep: the failing winner is staged
    old["k32"].pop("powerlaw", None)
    cfgs.write_text(json.dumps(old))
    before = {p: _sha(p) for p in (RESULTS / "tuned_configs.json",
                                   tbench.H100_CONFIGS)}

    # without --validate nothing is written
    argv = [str(logs), "--configs", str(cfgs)] + CPU
    assert t_autofold.main(argv) == 0
    assert json.loads(cfgs.read_text()) == old
    assert t_autofold.main(argv + ["--validate"]) == 0
    out = capsys.readouterr().out
    data = json.loads(cfgs.read_text())
    assert data["k64"]["clustered16"] == t_utc.parse_tag(won)
    assert data["k64"]["powerlaw"] == entry
    # the probe's two configs are not the file's entry: it stays
    assert data["k32"]["clustered16"] == old["k32"]["clustered16"]
    assert "k32/clustered16: entry not timed in this log: kept" in out
    assert data["k32"].get("powerlaw") == old["k32"].get("powerlaw")
    assert "SKIP k32/powerlaw (validation failed)" in out
    assert data["k32"]["dlmc"] == {"dense": True}
    assert out.count("contract PASS errors=0/") == 4
    assert data["k128"] == old["k128"]
    assert "cpu" in data["_comment"] and "logs/" in data["_comment"]
    assert tbench.validate_tuned_configs(cfgs) == []
    assert before == {p: _sha(p) for p in before}
    with pytest.raises(ValueError, match="never writes"):
        t_autofold.main([str(logs), "--validate", "--configs",
                         str(RESULTS / "tuned_configs.json")] + CPU)


def test_update_tuned_configs(tmp_path, monkeypatch):
    """torch_update_tuned_configs folds a log's winner into the card's file
    through ``save_tuned``; ``--dry-run`` writes nothing."""
    log = RESULTS / "probe_r5levers_powerlaw_k64.log"
    cfgs = tmp_path / "h100.json"
    monkeypatch.setattr(t_utc, "CONFIGS", cfgs)
    argv = [str(log), "--matrix", "powerlaw", "--k", "64"] + CPU
    assert t_utc.main(argv + ["--dry-run"]) == 0 and not cfgs.exists()
    assert t_utc.main(argv) == 0
    data = json.loads(cfgs.read_text())
    assert data["k64"]["powerlaw"] == j_utc.parse_tag(j_utc.winner_of(log))
    assert log.name in data["_comment"] and "cpu" in data["_comment"]


@pytest.mark.parametrize("name", NEW_SCRIPTS)
def test_script_imports_no_reference(name):
    """None of the new scripts imports jax, the root bench or the JAX
    package."""
    for line in (SCRIPTS / f"{name}.py").read_text().splitlines():
        s = line.strip()
        assert not re.match(r"(import|from) (jax|bench|sddmm_tpu)\b",
                            s), (name, line)


PROBE_RUN = RESULTS / "torch_probes"


FOLD_LOG = (PROBE_RUN / "autofold.log").read_text()
FOLD_CELLS = [(m, k) for k in (32, 64, 128, 256)
              for m in sorted(jbench.suite(False))]


def test_committed_h100_configs_are_the_validated_fold():
    """The card's configs file is the probe run's validated fold: every
    bench matrix at every K, each entry checked at 0 errors against fp64
    in the run's autofold log, and the file names the card and the run."""
    data = json.loads(tbench.H100_CONFIGS.read_text())
    assert tbench.validate_tuned_configs(tbench.H100_CONFIGS) == []
    for k in (32, 64, 128, 256):
        assert sorted(data[f"k{k}"]) == sorted(jbench.suite(False))
    checked = re.findall(r"validate (\w+) k(\d+): .*\n    contract PASS "
                         r"errors=0/\d+", FOLD_LOG)
    assert len(checked) == 20 and "SKIP" not in FOLD_LOG
    assert {(m, int(k)) for m, k in checked} == set(FOLD_CELLS)
    assert "NVIDIA H100" in data["_comment"]
    assert "torch_probes/" in data["_comment"]


@pytest.mark.parametrize("matrix,k", FOLD_CELLS)
def test_committed_fold_follows_its_rule(matrix, k):
    """Each cell of the committed fold: the entry the autofold log
    validated is the file's, and a winner folded only where its margin
    over the entry beat the spread."""
    entry = json.loads(tbench.H100_CONFIGS.read_text())[f"k{k}"][matrix]
    m = re.search(rf"  validate {matrix} k{k}: (.+)\n", FOLD_LOG)
    assert m and m.group(1) == ("dense class" if entry.get("dense")
                                else t_autofold.cfg_to_spec(entry))
    line = re.search(rf"  k{k}/{matrix}: (.+)\n", FOLD_LOG).group(1)
    nums = re.search(r"margin ([+-][\d.]+) % against spread ([\d.]+): "
                     r"(winner folds|entry kept)", line)
    if nums:
        margin, spread = float(nums.group(1)) / 100, float(nums.group(2))
        assert (margin > spread) == (nums.group(3) == "winner folds")
    if nums is None or nums.group(3) == "winner folds":
        log = PROBE_RUN / f"probe_configs_{matrix}_k{k}.log"
        dense = "dense class owns this cell" in line
        assert dense == bool(entry.get("dense"))
        if not dense and "kept" not in line:
            assert entry == t_utc.parse_tag(t_utc.winner_of(log))
