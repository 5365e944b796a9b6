"""The MiMo-V2-Flash cell on the CPU: ``mimo.train`` rehearsed end to end
through the kernels' plain versions at a tiny size, its reference copy held
equal to the repository's, its readers finding nothing in another cell's
records, and its counts against the published shapes' arithmetic."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from perfbench import cells, counts, counts_mimo, mimo_reference, trace

CELL = "mimo.train"
TINY = {"config": {"hidden_size": 256, "num_attention_heads": 8,
                   "num_key_value_heads": 2, "swa_num_key_value_heads": 2,
                   "head_dim": 48, "v_head_dim": 32, "sliding_window": 16,
                   "num_hidden_layers": 2},
        "traffic": {"seq_len": 256, "batch": 2, "pool": 6, "host_calls": 2,
                    "profile_calls": 2}}
ENV = dict(os.environ, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
NEW = ("host_ms.mimo", "idle_share.mimo", "roofline_share.mimo", "mfu.mimo",
       "full_layer_ms.mimo", "window_layer_ms.mimo",
       "roofline_share.attention.mimo", "roofline_share.rope.mimo",
       "launch_us.mimo")


def _run(args, cwd=ROOT):
    return subprocess.run([sys.executable, "perfbench/run.py"] + args,
                          cwd=cwd, env=ENV, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("trace_on", [0, 1])
def test_rehearsal_line(trace_on):
    p = _run(["--workload", CELL, "--seed", str(2 ** 31 + 777),
              "--seconds", "0.5", "--trace", str(trace_on),
              "--rehearse-cpu", json.dumps(TINY)])
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "cpu"
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    if trace_on:
        # off the card only the host's metric has something to read
        assert set(line["metrics"]) == {"host_ms.mimo"}
    else:
        assert set(line["metrics"]) == {"train_step_ms", "setup_s"}


def test_without_the_program_it_fails_at_once(tmp_path):
    """The benchmark's files alone (a checkout whose program lacks the
    stack) exit non-zero and print no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", CELL, "--seed", "1", "--seconds", "1",
              "--trace", "0", "--rehearse-cpu", json.dumps(TINY)],
             cwd=tmp_path)
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.parametrize("fault", ["no_sink", "no_rope", "head_map",
                                   "half_batch"])
def test_planted_faults_reach_the_stack_step(fault, monkeypatch):
    """Each fault ``faults_stack.py`` plants by patching a module reaches
    the stack's training step on the CPU: judged against the reference, it
    fails a limit of the cell (the unfaulted program passes them in the
    rehearsal).  ``half_batch`` is patched in ``loops/train.py``, the
    module whose ``loss_of`` the stack loop's inherited step reads."""
    from perfbench import faults_stack
    from sddmm_tpu_torch.models import hybrid_attention as ha
    cell = cells.cell(CELL)
    config = cells.merge(cell.config, TINY["config"])
    traffic = cells.merge(cell.traffic, TINY["traffic"])
    system_mod = cells.system(config["system"])
    pattern = system_mod.pattern(config, traffic)
    cpu = torch.device("cpu")
    system = system_mod.build(config, traffic, pattern, cpu)
    mod, attr, stand_in = faults_stack._patches(
        ha, cells.loop("train"))[fault]
    monkeypatch.setattr(mod, attr, stand_in)
    loop = cells.loop(traffic["loop"]).Loop(system, pattern, config,
                                            traffic, cpu, 2 ** 31 + 5)
    got = loop.judge(loop.readings())
    assert any(v > traffic["limits"][k] for k, v in got.items()), got


def _tiny_model(seed=0):
    cell = cells.cell(CELL)
    config = cells.merge(cell.config, TINY["config"])
    d = cells.system("mimo_stack").dims(config)
    loop = cells.loop("train_stack")
    ws = loop.weights(d, torch.Generator().manual_seed(seed), "cpu")
    kinds = counts_mimo.layer_kinds(d)
    cfg = {"rotary_dim": d["rotary_dim"], "value_scale": d["value_scale"]}
    return d, ws, kinds, cfg


def test_reference_copy_equals_the_repositorys():
    """The benchmark's reference (one head at a time, recomputed in the
    backward) against ``sddmm_tpu_torch.models.mimo_reference``: the loss,
    every weight's gradient and the output, in float64."""
    from sddmm_tpu_torch.models import mimo_reference as repo_ref
    d, ws, kinds, cfg = _tiny_model()
    g = torch.Generator().manual_seed(1)
    x, y = torch.randn(128, d["hidden"], generator=g), \
        torch.randn(128, d["hidden"], generator=g)
    with torch.no_grad():
        got = mimo_reference.stack(ws, kinds, cfg, x)
        want = repo_ref.forward(x.double(), [{k: v.double() for k, v in
                                              w.items()} for w in ws],
                                kinds, cfg)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    loss, grads, _ = mimo_reference.train(ws, kinds, cfg, [[(x, y)]], 1e-3)
    r_loss, r_grads, _ = repo_ref.loss_and_grads([x], [y], ws, kinds, cfg)
    assert abs(loss[0] - float(r_loss)) <= 1e-12 * float(r_loss)
    flat = [gr[n] for gr in r_grads for n in mimo_reference.NAMES if n in gr]
    assert len(grads) == len(flat)
    for a, b in zip(grads, flat):
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-14)


def test_controls_round_the_products():
    """The TF32 and bf16 controls move the output by their formats'
    rounding, the exact reference does not."""
    d, ws, kinds, cfg = _tiny_model(2)
    x = torch.randn(64, d["hidden"], generator=torch.Generator()
                    .manual_seed(3))
    with torch.no_grad():
        exact = mimo_reference.stack(ws, kinds, cfg, x)
        for precision, lo, hi in (("tf32", 1e-5, 1e-2),
                                  ("bfloat16", 1e-4, 1e-1)):
            got = mimo_reference.stack(ws, kinds, cfg, x, precision)
            rel = float((got.double() - exact).norm() / exact.norm())
            assert lo < rel < hi, (precision, rel)


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_in_other_cells_records(name):
    read = cells.reader(name)
    records = trace.Records(kind="train", calls=2, host_s=[0.5, 0.5],
                            kernels=[("tile_table_kernel", 0.0, 1.0),
                                     ("rope_kernel", 1.0, 1.5)],
                            window=(0.0, 2.0), wall_s=1.0,
                            useful_flops=1e12, least_s=0.1,
                            peak_flops=1e14)
    assert read(records) is None
    assert read(trace.Records(kind="sddmm", calls=1)) is None


def test_kernel_shares_read_their_kernels():
    records = trace.Records(kind="train_stack", calls=2,
                            kernels=[("x::tile_table_kernel<F>", 0.0, 1.0),
                                     ("x::rope_kernel", 1.0, 1.5),
                                     ("x::proj_gemm_kernel", 1.5, 9.0)],
                            window=(0.0, 9.0))
    assert counts_mimo.kernel_share(records, counts_mimo.CORE_KERNELS,
                                    0.25) == pytest.approx(50.0)
    assert counts_mimo.kernel_share(records, (counts_mimo.ROPE_KERNEL,),
                                    0.25) == pytest.approx(100.0)
    assert counts_mimo.kernel_share(records, ("nothing",), 0.25) is None


def test_counts_at_the_published_shapes():
    """The cell's work from its shapes: 8,390,656 and 516,160 entries a
    head; 5.045 TFLOP a sequence forward (the full layer's attention 343.7
    GFLOP against 730.1 in its projections); 117.4 TFLOP a step of 8
    sequences, 0.712 s at the "float32" peak (the least time adds what
    the byte-bound ops take beyond their share of it)."""
    cell = cells.cell(CELL)
    d = cells.system("mimo_stack").dims(cell.config)
    L, B = cell.traffic["seq_len"], cell.traffic["batch"]
    assert counts_mimo.mask_nnz(L, None) == 8_390_656
    assert counts_mimo.mask_nnz(L, 128) == 516_160
    full = counts_mimo.core_forward(L, 64, 4, 192, 128, 8_390_656, False)
    assert sum(o.flops for o in full) == pytest.approx(343.7e9, rel=1e-3)
    proj = counts_mimo.projections(L, 4096, 64, 4, 192, 128, True)[0]
    assert sum(o.flops for o in proj) == pytest.approx(730.1e9, rel=1e-4)
    ops = counts_mimo.train_ops(d, L, B, 560_988_480)
    fwd_one = counts_mimo.train_ops(d, L, 1, 0)
    assert counts.useful_flops(ops) == pytest.approx(117.4e12, rel=1e-3)
    fwd = sum(o.flops for o in fwd_one
              if not o.name.endswith("_bwd") and "bwd" not in o.name)
    assert fwd == pytest.approx(5.045e12, rel=1e-3)
    peak_s = counts.useful_flops(ops) / counts.peak_flops("float32")
    assert peak_s == pytest.approx(0.712, rel=1e-3)
    assert peak_s < counts.least_s(ops, "float32") < 1.1 * peak_s
    params = sum(torch.Size(s).numel() for s in (
        (64, 4096, 192), (4, 4096, 192), (4, 4096, 128), (8192, 4096)))
    params += 5 * sum(torch.Size(s).numel() for s in (
        (64, 4096, 192), (8, 4096, 192), (8, 4096, 128), (8192, 4096),
        (64,)))
    assert params == 560_988_480
