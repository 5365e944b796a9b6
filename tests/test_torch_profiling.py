"""The port's spans and launch counter (``utils.profiling``) on the CPU: on
exactly while a ``torch.profiler`` capture runs, the stages of the
attention layer and the hybrid runner each recorded once a call with their
parents, no plan built on the steady path, events on a thread's outermost
span alone, nothing under a capture of the device alone, and a table that
threads share safely."""

import itertools
import sys
import threading
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from sddmm_tpu_torch import _kernels
from sddmm_tpu_torch.data import generate
from sddmm_tpu_torch.models.block_sparse_attention import (
    BlockSparseAttention, make_attention_mask)
from sddmm_tpu_torch.ops.hybrid import HybridSDDMM
from sddmm_tpu_torch.utils import profiling

#: the spans of one attention layer's forward and backward, once each
LAYER_SPANS = ("attention.forward", "attention.project", "hybrid.prepare",
               "hybrid.sddmm", "attention.softmax", "attention.spmm",
               "attention.out", "hybrid.sddmm.backward", "softmax.backward",
               "spmm.backward")


@pytest.fixture(autouse=True)
def _empty_table():
    profiling.clear()
    yield
    profiling.clear()


def _capture():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _layers(n=2, seq=64):
    mask = make_attention_mask(seq, window=6, num_global=1)
    gen = torch.Generator().manual_seed(0)
    layers = []
    for _ in range(n):
        layer = BlockSparseAttention(mask, feature_dim=16, num_heads=2,
                                     head_dim=8, device="cpu")
        layer.init(gen)
        layers.append(layer)
    x = torch.randn((seq, 16), generator=gen)
    return layers, x


def _step(layers, x):
    for layer in layers:
        x = x + layer(x)
    (x ** 2).mean().backward()


def test_active_follows_a_capture():
    assert profiling.active() is False
    with _capture():
        assert profiling.active() is True
    # torch's own flag, read in one place: a rename fails here
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_trace_turns_spans_on_and_names_them_on_its_timeline(tmp_path):
    with profiling.trace(tmp_path / "trace") as prof:
        with profiling.span("outer.stage") as sp:
            assert sp.id is not None and profiling.current() == sp.id
    assert profiling.summary()["spans"]["outer.stage"]["count"] == 1
    assert "outer.stage" in {e.name for e in prof.events()}
    (trace,) = (tmp_path / "trace").glob("*.pt.trace.json")
    assert '"outer.stage"' in trace.read_text()


def test_off_records_nothing_and_opens_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no capture")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    layers, x = _layers(1)
    _step(layers, x)
    runner = layers[0].runner
    a = np.ones((runner.packed.m, 8), np.float32)
    runner(a, bt=np.ones((runner.packed.n, 8), np.float32))
    with profiling.span("bare") as sp:
        assert sp.id is None and profiling.current() is None
    assert profiling.summary() == {"spans": {}, "launch": {
        "count": 0, "host_ms": 0.0}, "spmm": {
        "launches": 0, "panel_entries": 0, "entries": 0,
        "panel_share": None}, "softmax": {
        "launches": 0, "entries": 0, "block_entries": 0,
        "split_entries": 0, "block_share": None}, "dropped": 0}
    assert profiling.records() == []


def test_attention_records_each_stage_once_a_layer():
    layers, x = _layers(2)
    with _capture():
        _step(layers, x)
    first = profiling.summary()["spans"]
    for name in LAYER_SPANS:
        assert first[name]["count"] == 2, (name, first[name])
    assert first["plan.build"]["count"] >= 1
    assert "hybrid.to_csr" not in first     # the layer reads packed order

    recs = {r["id"]: r for r in profiling.records()}

    def chain(r):
        names = []
        while r["parent"] is not None:
            r = recs[r["parent"]]
            names.append((r["name"], r["id"]))
        return names

    forwards = sorted(r["id"] for r in recs.values()
                      if r["name"] == "attention.forward")
    for bwd, fwd in (("softmax.backward", "attention.softmax"),
                     ("spmm.backward", "attention.spmm"),
                     ("hybrid.sddmm.backward", "hybrid.sddmm")):
        caused = []
        for r in recs.values():
            if r["name"] == bwd:
                up = chain(r)
                # the forward stage whose autograd node it ran, inside the
                # attention.forward of its own layer
                assert [n for n, _ in up] == [fwd, "attention.forward"], up
                assert not r["nested"]
                caused.append(up[-1][1])
        assert sorted(caused) == forwards, bwd
    for name in ("attention.project", "hybrid.prepare", "hybrid.sddmm",
                 "attention.softmax", "attention.spmm", "attention.out"):
        assert first[name]["parents"] == {"attention.forward": 2}, name
    for r in recs.values():
        assert r["device_ms"] is None and r["queue_ms"] is None

    profiling.clear()
    with _capture():
        _step(layers, x)
    second = profiling.summary()["spans"]
    assert "plan.build" not in second
    assert {n: second[n]["count"] for n in LAYER_SPANS} == {
        n: 2 for n in LAYER_SPANS}


def test_runner_call_records_prepare_sddmm_and_to_csr():
    csr = generate.block_clustered(12, 10, block_prob=0.3, seed=5)
    runner = HybridSDDMM.from_csr(csr, 0.3, 0.3, device="cpu")
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 2, (csr.m, 32)).astype(np.float32)
    b = rng.uniform(0, 2, (32, csr.n)).astype(np.float32)
    runner(a, b)                              # builds the residual's plan
    with _capture():
        out = runner(a, b)
    assert out.shape == (csr.nnz,)
    spans = profiling.summary()["spans"]
    assert {n: s["count"] for n, s in spans.items()} == {
        "hybrid.prepare": 1, "hybrid.sddmm": 1, "hybrid.to_csr": 1}
    for s in spans.values():
        assert s["parents"] == {} and s["self_ms"] == s["host_ms"] > 0
        assert s["device_ms"] is None


def test_self_time_leaves_out_nested_spans(monkeypatch):
    clock = iter(range(0, 10 ** 6, 10))
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: next(clock))
    with _capture():
        with profiling.span("outer"):             # opens at 0
            with profiling.span("inner"):         # 10 to 20
                pass
            with profiling.span("inner"):         # 30 to 40
                pass
    spans = profiling.summary()["spans"]          # outer closes at 50
    assert spans["outer"]["host_ms"] == 50 / 1e6
    assert spans["outer"]["self_ms"] == 30 / 1e6
    assert spans["inner"] == {"count": 2, "host_ms": 20 / 1e6,
                              "self_ms": 20 / 1e6, "device_ms": None,
                              "queue_ms": None,
                              "parents": {"outer": 2}}


def test_only_a_threads_outermost_span_records_events(monkeypatch):
    """On the card the outermost span open on a thread records an event
    at each end and the stream's state; the spans nested in it none.  An
    event recorded on an empty stream anchors the capture's device clock,
    from which a later span's queue wait is read."""
    ticks = itertools.count()

    class Event:
        def __init__(self):
            self.t = next(ticks)            # device ms since the first

        def elapsed_time(self, other):
            return float(other.t - self.t)

    class Stream:
        device_index, busy = 0, False

        def query(self):
            return not self.busy

    stream = Stream()
    clock = iter(range(0, 10 ** 6, 10))
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: next(clock))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(profiling, "_current_stream", lambda: stream)
    monkeypatch.setattr(profiling, "_event", lambda s: Event())
    with _capture():
        with profiling.span("outer"):           # events 0 and 1, host 0
            with profiling.span("inner"):
                pass
        stream.busy = True
        with profiling.span("later"):           # event 2 at host 40
            pass
    recs = {r["name"]: r for r in profiling.records()}
    assert (recs["outer"]["device_ms"], recs["outer"]["queue_ms"],
            recs["outer"]["queued"]) == (1.0, 0.0, False)
    assert (recs["inner"]["device_ms"], recs["inner"]["queue_ms"],
            recs["inner"]["queued"]) == (None, None, None)
    # device 2 ms after the anchor, host 40 ns after it
    assert recs["later"]["queued"] is True
    assert recs["later"]["queue_ms"] == pytest.approx(2.0 - 40 / 1e6)


def test_a_capture_of_the_device_alone_leaves_spans_off(monkeypatch):
    """Each capture's activities reach ``_note_capture`` through torch's
    ``_enable_profiler``; without the host among them a span and the
    launch counter stay off, as with no capture."""
    # torch's function, wrapped once: a rename in torch fails here
    assert torch.autograd.profiler._enable_profiler.notes_captures
    seen = []
    note = profiling._note_capture
    monkeypatch.setattr(profiling, "_note_capture",
                        lambda acts: seen.append(set(acts)) or note(acts))
    with _capture():
        assert profiling.active() is True
    assert seen == [{torch.profiler.ProfilerActivity.CPU}]
    # a device-only capture, as the card's CUPTI tracing starts one
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    profiling._note_capture({torch.profiler.ProfilerActivity.CUDA})
    assert profiling.active() is False
    with profiling.span("device.only") as sp:
        assert sp.id is None
    assert profiling.current() is None
    profiling._note_capture({torch.profiler.ProfilerActivity.CPU,
                             torch.profiler.ProfilerActivity.CUDA})
    assert profiling.active() is True
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False)
    assert profiling.active() is False
    assert profiling.records() == []


def test_launch_counter_counts_only_inside_a_capture(monkeypatch):
    class Lib:
        @staticmethod
        def sddmm_fake(*args):
            return 0

    monkeypatch.setattr(_kernels, "load", lambda: Lib)
    before = _kernels.launches["sddmm_fake"]
    _kernels.launch("sddmm_fake", 1, 2)
    assert profiling.summary()["launch"]["count"] == 0
    with _capture():
        _kernels.launch("sddmm_fake", 1, 2)
        _kernels.launch("sddmm_fake", 3)
    launch = profiling.summary()["launch"]
    assert launch["count"] == 2 and launch["host_ms"] > 0
    assert _kernels.launches["sddmm_fake"] == before + 3
    del _kernels.launches["sddmm_fake"]


def test_spmm_counter_reports_the_panel_share(monkeypatch):
    """Each SpMM launch adds the entries it sends down the panel path and
    all its entries (times its heads), inside a capture only: at least
    95 % on Longformer-base's mask over 2 heads, none on a power-law
    graph.  The launch itself is a stand-in here (no card)."""
    from sddmm_tpu_torch.ops import spmm as sp

    class Lib:
        @staticmethod
        def sddmm_csr_spmm_float32(*args):
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_kernels, "load", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream)

    def launch(csr, heads=2, K=8):
        plan = sp.spmm_plan(csr.row_ptr, csr.col_idx).to("cpu")
        m, nnz = len(csr.row_ptr) - 1, len(csr.col_idx)
        sp.spmm_launch(plan, torch.as_tensor(csr.row_ptr, dtype=torch.int64),
                       torch.as_tensor(csr.col_idx, dtype=torch.int32),
                       torch.ones((heads, nnz)),
                       torch.ones((heads, 1, csr.shape[1], K)),
                       torch.empty((heads, 1, m, K)))
        return plan.panel_entries * heads, nnz * heads

    mask = make_attention_mask(4096, window=256, num_global=1)
    graph = generate.powerlaw_graph(5000, avg_degree=10, seed=1)
    launch(mask)
    assert profiling.summary()["spmm"]["launches"] == 0
    with _capture():
        panel, entries = launch(mask)
    spmm = profiling.summary()["spmm"]
    assert spmm == {"launches": 1, "panel_entries": panel,
                    "entries": entries, "panel_share": panel / entries}
    assert spmm["panel_share"] >= 0.95
    profiling.clear()
    with _capture():
        launch(graph)
    spmm = profiling.summary()["spmm"]
    assert spmm["launches"] == 1 and spmm["panel_share"] == 0


def test_softmax_counter_reports_the_block_share(monkeypatch):
    """Each softmax launch, forward and backward, adds its entries by
    class (times its heads), inside a capture only: about 0.976 of a
    4,096-row causal mask's entries in block rows, none on Longformer's
    window without a global token; a graph hub past the block rows
    counts as split.  The launch itself is a stand-in here (no card)."""
    from sddmm_tpu_torch.ops import softmax as sm

    class Lib:
        @staticmethod
        def sddmm_segment_softmax_float32(*args):
            return 0

        @staticmethod
        def sddmm_segment_softmax_backward_float32(*args):
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_kernels, "load", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream)

    def launch(row_ptr, heads=2):
        plan = sm.softmax_plan(row_ptr, "cpu")
        rp = torch.as_tensor(row_ptr, dtype=torch.int64)
        x, out = torch.ones((heads, 4)), torch.empty((heads, 4))
        sm.softmax_launch(plan, (x,), rp, 1.0, out)
        sm.softmax_launch(plan, (x, x), rp, 1.0, out)
        return plan

    causal = np.r_[0, np.cumsum(np.arange(1, 4097))]
    window = make_attention_mask(4096, window=256, num_global=0).row_ptr
    launch(causal)
    assert profiling.summary()["softmax"]["launches"] == 0
    with _capture():
        plan = launch(causal)
    got = profiling.summary()["softmax"]
    assert got == {"launches": 2, "entries": 4 * 8390656,
                   "block_entries": 4 * 8185536, "split_entries": 0,
                   "block_share": 8185536 / 8390656}
    assert plan.entries[2] == 8185536 and 0.975 < got["block_share"] < 0.977
    profiling.clear()
    with _capture():
        launch(window, heads=12)
    got = profiling.summary()["softmax"]
    assert got["launches"] == 2 and got["block_share"] == 0
    assert got["entries"] == 2 * 12 * int(window[-1])
    profiling.clear()
    with _capture():
        launch(np.array([0, 5000, 5100]), heads=1)
    got = profiling.summary()["softmax"]
    assert (got["split_entries"], got["block_entries"]) == (10000, 0)


def test_table_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    with _capture():
        for _ in range(5):
            with profiling.span("s"):
                pass
    out = profiling.summary()
    assert out["spans"]["s"]["count"] == 3 and out["dropped"] == 2


def test_summary_is_thread_safe_with_spans_on_two_threads():
    n, errors, done = 400, [], threading.Event()

    def work(tag):
        try:
            for _ in range(n):
                with profiling.span(f"{tag}.outer"):
                    with profiling.span(f"{tag}.inner"):
                        pass
        except Exception as e:              # reported by the main thread
            errors.append(e)

    def read():
        try:
            while not done.is_set():
                profiling.summary()
        except Exception as e:
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _capture():
            threads = [threading.Thread(target=work, args=(t,))
                       for t in ("a", "b")]
            reader = threading.Thread(target=read)
            reader.start()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            done.set()
            reader.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads + [reader])
    assert not errors, errors
    spans = profiling.summary()["spans"]
    for tag in ("a", "b"):
        assert spans[f"{tag}.outer"]["count"] == n
        assert spans[f"{tag}.outer"]["parents"] == {}
        # a span's parent is the enclosing span of its own thread
        assert spans[f"{tag}.inner"]["parents"] == {f"{tag}.outer": n}
    ids = [r["id"] for r in profiling.records()]
    assert len(ids) == len(set(ids)) == 4 * n
