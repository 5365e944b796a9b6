"""MiMo-V2-Flash's hybrid attention on the CPU (``models.HybridAttentionStack``
through every op's plain version): each kind of layer and a full-then-window
stack against the float64 reference (``models.mimo_reference``), outputs and
the gradients of x and of every weight, the sinks included; each fault the
layer could make fails the comparison; the new ops' pieces (grouped heads,
the sink softmax, RoPE) against their definitions."""

import numpy as np
import pytest
import torch

from sddmm_tpu_torch.models import AttentionKind, HybridAttentionStack
from sddmm_tpu_torch.models import hybrid_attention as ha
from sddmm_tpu_torch.models import mimo_reference as ref
from sddmm_tpu_torch.ops import rope as rp
from sddmm_tpu_torch.ops import softmax as sm
from sddmm_tpu_torch.ops import spmm as sp
from sddmm_tpu_torch.ops.tile_dot import head_shift

L, F, H, D, DV, R, W = 256, 256, 8, 48, 32, 16, 16
KV = 2
VALUE_SCALE = 0.707
KINDS = {"full": AttentionKind("full", KV, 5e6, False),
         "window": AttentionKind("window", KV, 1e4, True, W)}
STACKS = {"full": ["full"], "window": ["window"],
          "full_window": ["full", "window"]}
# the fp32 plain path against float64, |got - want| / |want| in norm: a few
# fp32 roundings of sums of up to 256 terms (read 0.3-0.7e-6 on the
# gradients, 2e-8 on the loss)
TOL = 5e-6


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = want.double()
    return float((got.double() - want).norm() / want.norm())


def _stack(types, window=W):
    kinds = [KINDS["full"], AttentionKind("window", KV, 1e4, True, window)]
    st = HybridAttentionStack(L, types, kinds, F, H, D, DV, R, VALUE_SCALE,
                              device="cpu")
    st.init(torch.Generator().manual_seed(len(types)))
    return st


def _data(seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(L, F, generator=g), torch.randn(L, F, generator=g)


def _worst(st, types):
    """The largest relative error of the plain path against the float64
    reference: the output, x's gradient and every weight's."""
    x, y = _data()
    xx = x.clone().requires_grad_()
    out = st(xx, plain=True)
    ((out - y) ** 2).mean().backward()
    layers = [{n: p.detach() for n, p in layer.named_parameters()}
              for layer in st.layers]
    kinds = [dict(kv_heads=KINDS[t].kv_heads, rope_theta=KINDS[t].rope_theta,
                  window=KINDS[t].window, sink=KINDS[t].sink) for t in types]
    cfg = {"rotary_dim": R, "value_scale": VALUE_SCALE}
    with torch.no_grad():
        want = ref.forward(x.double(), [{k: v.double() for k, v in w.items()}
                                        for w in layers], kinds, cfg)
    _, grads, (dx,) = ref.loss_and_grads([x], [y], layers, kinds, cfg)
    errs = {"out": _rel(out.detach(), want), "dx": _rel(xx.grad, dx)}
    for i, layer in enumerate(st.layers):
        for n, p in layer.named_parameters():
            got = torch.zeros_like(p) if p.grad is None else p.grad
            errs[f"{i}.{n}"] = _rel(got, grads[i][n])
    return errs


@pytest.mark.parametrize("name", sorted(STACKS))
def test_plain_path_matches_the_float64_reference(name):
    types = STACKS[name]
    errs = _worst(_stack(types), types)
    if "window" in types:
        assert any(k.endswith("sink") for k in errs)
    assert max(errs.values()) < TOL, errs


def _shifted(project):
    def run(*a, **kw):
        q, k, v = project(*a, **kw)
        return (q, k.roll(-1, 0),
                v.view(k.shape[0], -1, v.shape[1]).roll(-1, 0)
                .reshape(v.shape))
    return run


@pytest.mark.parametrize("fault", ["no_sink", "no_rope", "head_map",
                                   "wider_window"])
def test_each_fault_fails_the_comparison(fault, monkeypatch):
    """The comparison's tolerance catches the sinks left out, RoPE left
    out, the head map shifted by one group and the window one position
    wider, each by at least 100x."""
    types = ["full", "window"]
    window = W
    if fault == "no_sink":
        soft = ha.segment_softmax_sink
        monkeypatch.setattr(ha, "segment_softmax_sink",
                            lambda flat, sink, *a: soft(flat, None, *a))
    elif fault == "no_rope":
        monkeypatch.setattr(ha, "apply_rope",
                            lambda q, k, table, plain=False: (q, k))
    elif fault == "head_map":
        monkeypatch.setattr(ha, "qkv_project", _shifted(ha.qkv_project))
    else:
        window = W + 1
    errs = _worst(_stack(types, window), types)
    assert max(errs.values()) > 100 * TOL, errs


@pytest.mark.parametrize("heads,kv,want", [(8, 8, 0), (8, 2, 2), (64, 4, 4),
                                           (64, 8, 3)])
def test_head_shift(heads, kv, want):
    assert head_shift(heads, kv) == want


@pytest.mark.parametrize("heads,kv", [(8, 3), (12, 4), (4, 8), (8, 0)])
def test_head_shift_refuses_other_groups(heads, kv):
    with pytest.raises(ValueError):
        head_shift(heads, kv)


def test_causal_masks():
    full, band = ha.causal_mask(10), ha.causal_mask(10, 3)
    assert full.nnz == 55 and band.nnz == 3 * 10 - 3
    rows = band.row_indices()
    assert ((rows - band.col_idx) < 3).all() and (band.col_idx <= rows).all()


def test_rope_plain_is_a_rotation_and_its_inverse():
    table = rp.rope_table(L, R, 1e4, "cpu")
    x = torch.randn(3, L + 1, D, dtype=torch.float32)
    y = rp.rope_plain(x, table)
    assert torch.allclose(y.norm(dim=2), x.norm(dim=2), rtol=1e-6)
    assert torch.equal(y[:, :, R:], x[:, :, R:]) and torch.equal(y[:, L],
                                                                 x[:, L])
    back = rp.rope_plain(y, table, inverse=True)
    assert torch.allclose(back, x, atol=1e-6)
    want = ref.rope(x[1, :L].double(), R, 1e4)
    assert _rel(y[1, :L], want) < 1e-6


def test_rope_autograd_backward_is_the_inverse():
    table = rp.rope_table(L, R, 5e6, "cpu")
    q = torch.randn(H, L + 1, D, requires_grad=True)
    k = torch.randn(KV, L + 1, D, requires_grad=True)
    gq, gk = torch.randn(H, L + 1, D), torch.randn(KV, L + 1, D)
    torch.autograd.backward(rp.apply_rope(q, k, table), (gq, gk))
    assert torch.allclose(q.grad, rp.rope_plain(gq, table, True))
    assert torch.allclose(k.grad, rp.rope_plain(gk, table, True))


def _softmax_case(seed=3):
    mask = ha.causal_mask(64, 9)
    g = torch.Generator().manual_seed(seed)
    row_ptr = torch.as_tensor(mask.row_ptr, dtype=torch.int64)
    return row_ptr, torch.randn(4, mask.nnz, generator=g) * 3, \
        torch.randn(4, generator=g), torch.randn(4, mask.nnz, generator=g)


def test_sink_softmax_matches_a_row_with_one_more_entry():
    """A sink is one more entry of every row whose probability is left
    out: the kernel's plain version against a dense softmax over the row
    and its sink, in float64."""
    row_ptr, x, sink, _ = _softmax_case()
    p, p_sink = sm.segment_softmax_sink_plain(x, row_ptr, 1.0, None, sink)
    rp_ = row_ptr.tolist()
    for h in range(4):
        for r in range(len(rp_) - 1):
            row = torch.cat([x[h, rp_[r]:rp_[r + 1]], sink[h:h + 1]]).double()
            want = torch.softmax(row, 0)
            assert torch.allclose(p[h, rp_[r]:rp_[r + 1]].double(), want[:-1],
                                  rtol=1e-6, atol=0)
            assert abs(float(p_sink[h, r]) - float(want[-1])) < 1e-6


def test_sink_softmax_gradients_match_autograd():
    """The op's backward (the rows' shares of the sinks' gradient summed)
    against float64 autograd of the same softmax."""
    row_ptr, x, sink, g = _softmax_case(4)
    xx, ss = x.clone().requires_grad_(), sink.clone().requires_grad_()
    sm.segment_softmax_sink(xx, ss, row_ptr, 0.5).backward(g)
    x64, s64 = x.double().requires_grad_(), sink.double().requires_grad_()
    p64, _ = sm.segment_softmax_sink_plain(x64, row_ptr, 0.5, None, s64)
    p64.backward(g.double())
    assert _rel(xx.grad, x64.grad) < 1e-6
    assert _rel(ss.grad, s64.grad) < 1e-6


def test_sink_softmax_without_a_sink_is_the_softmax():
    row_ptr, x, _, _ = _softmax_case(5)
    got = sm.segment_softmax_sink(x, None, row_ptr, 0.25)
    assert torch.equal(got, sm.segment_softmax_plain(x, row_ptr, 0.25))


def test_head_spmm_reads_the_group_and_sums_its_gradient():
    """The aggregation of H query heads over Hkv value heads against a
    dense product per head; V's gradient is the sum over its group."""
    mask = ha.causal_mask(32, 5)
    agg = sp.HeadAggregation(mask, "cpu")
    g = torch.Generator().manual_seed(6)
    p = torch.rand(8, mask.nnz, generator=g, dtype=torch.float64)
    v = torch.randn(2, 32, 4, generator=g, dtype=torch.float64)
    dense = torch.zeros(8, 32, 32, dtype=torch.float64)
    dense[:, torch.as_tensor(mask.row_indices()),
          torch.as_tensor(mask.col_idx).long()] = p
    pp, vv = p.float().requires_grad_(), v.float().requires_grad_()
    out = sp.head_spmm(pp, vv, agg)
    want = torch.stack([dense[h] @ v[h // 4] for h in range(8)])
    assert _rel(out, want) < 1e-6
    out.backward(torch.ones_like(out))
    dv = torch.stack([sum(dense[h].T @ torch.ones(32, 4, dtype=torch.float64)
                          for h in range(4 * j, 4 * j + 4))
                      for j in range(2)])
    assert _rel(vv.grad, dv) < 1e-6
    assert np.isfinite(pp.grad.numpy()).all()
