"""Card tests of the grouped-query attention path (MiMo-V2-Flash's layers)
at the published widths: 64 query heads over 4 (full) or 8 (window) key
and value heads, q/k heads of 192, v heads of 128, 64 rotary dims, each
kernel against its plain version.  They skip where there is no CUDA card;
on a machine with one run them with

    python -m pytest tests/test_torch_card_mimo.py --noconftest -q

This file imports nothing of JAX."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sddmm_tpu_torch import _kernels
from sddmm_tpu_torch.models import AttentionKind, HybridAttentionStack
from sddmm_tpu_torch.models import hybrid_attention as ha
from sddmm_tpu_torch.ops import rope as rp
from sddmm_tpu_torch.ops import softmax as sm
from sddmm_tpu_torch.ops import spmm as sp

pytestmark = pytest.mark.cuda

#: positions of the tests' layers (the causal rows run up to 1024 entries,
#: past the softmax's 640-entry warp class, so split rows are in them)
L = 1024
F, H, D, DV, R = 4096, 64, 192, 128, 64
KINDS = {"full": AttentionKind("full", 4, 5e6, False),
         "window": AttentionKind("window", 8, 1e4, True, 128)}
# kernel vs plain, as |got - want| / |want| in norm: the same fp32 products
# summed in another order (the tile kernel's bf16 planes against bmm's
# fp32 upcasts), over sums of up to 1024 terms
NORM_REL = 2e-6
# softmax vs plain, max |kernel - plain| / plain (tests/test_torch_card.py)
SOFTMAX_REL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(got, want):
    want = want.double()
    return float((got.double() - want).norm() / want.norm())


def _layer(kind, device, seed=0):
    st = HybridAttentionStack(L, [kind], [KINDS[kind]], F, H, D, DV, R,
                              0.707, device=device)
    st.init(torch.Generator(device=device).manual_seed(seed))
    return st, st.layers[0], st.cores[kind]


def _qkv(layer, core, x):
    with torch.no_grad():
        q, k, v = ha.qkv_project(x, layer.w_q, layer.w_k, layer.w_v,
                                 v_scale=layer.value_scale)
        return (*rp.apply_rope(q, k, core.table), v)


@pytest.mark.parametrize("kind", ["full", "window"])
def test_grouped_scores_and_their_backward(kind, cuda_device):
    """The tile kernel and the residual's gather-dot read key head h >> s
    in place (G = 16, 8): scores against the plain route's at every real
    slot; their backward (tile-grad with the group's dK summed in order,
    the residual's SpMMs) against the plain backward."""
    _, layer, core = _layer(kind, cuda_device)
    x = torch.randn(L, F, device=cuda_device)
    q, k, _ = _qkv(layer, core, x)
    assert k.shape[0] == KINDS[kind].kv_heads
    got, want = [], []
    for plain in (False, True):
        qq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        s = core.batched.run_padded(qq, kk, order="csr", plain=plain)
        g = torch.randn(s.shape, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(3))
        s.backward(g)
        (want if plain else got).append((s.detach(), qq.grad, kk.grad))
    for a, b in zip(got[0], want[0]):
        assert a.shape == b.shape
        assert _rel(a, b) < NORM_REL


@pytest.mark.parametrize("kind", ["full", "window"])
def test_grouped_aggregation_and_its_backward(kind, cuda_device):
    """The SpMM reads V of head h >> s in place; its backward's gather-dot
    (dP against V of the group) and SpMM (dV, the group's query heads
    summed in order, sum_heads = G) against the plain versions."""
    _, _, core = _layer(kind, cuda_device)
    kv = KINDS[kind].kv_heads
    gen = torch.Generator(cuda_device).manual_seed(5)
    p = torch.rand((H, core.nnz), device=cuda_device, generator=gen)
    v = torch.randn((kv, L, DV), device=cuda_device, generator=gen)
    g = torch.randn((H, L, DV), device=cuda_device, generator=gen)
    res = []
    for plain in (False, True):
        pp, vv = p.clone().requires_grad_(), v.clone().requires_grad_()
        out = sp.head_spmm(pp, vv, core.agg, plain)
        out.backward(g)
        res.append((out.detach(), pp.grad, vv.grad))
    for a, b in zip(*res):
        assert a.shape == b.shape
        assert _rel(a, b) < NORM_REL
    # both SpMMs run every entry on the panel path, bit-equal to the
    # plan's order of sums
    agg, pat = core.agg, core.agg.grads.spmm_t
    assert agg.plan.panel_entries == pat.plan().panel_entries == core.nnz
    out, _, dv = res[0]
    assert torch.equal(out, sp.csr_spmm_split_plain(
        p, agg.cols, v, agg.row_ptr.cpu(), agg.plan))
    assert torch.equal(dv, sp.csr_spmm_split_plain(
        p, pat.cols, g, pat._host[0], pat.plan(), pat.vidx, kv))


@pytest.mark.parametrize("kind", ["full", "window"])
def test_sink_softmax_forward_and_backward(kind, cuda_device):
    """The softmax with (window) or without (full) the sink, forward and
    backward, the sinks' gradient included, against the plain versions;
    with a sink every row's probabilities sum to 1 less its sink's."""
    _, layer, core = _layer(kind, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(7)
    flat = torch.randn((H, core.runner.packed.packed_size),
                       device=cuda_device, generator=gen) * 4
    g = torch.randn((H, core.nnz), device=cuda_device, generator=gen)
    sink = (torch.randn(H, device=cuda_device, generator=gen) * 2
            if layer.sink is not None else None)
    res = []
    for plain in (False, True):
        ff = flat.clone().requires_grad_()
        ss = None if sink is None else sink.clone().requires_grad_()
        p = sm.segment_softmax_sink(ff, ss, core.row_ptr, D ** -0.5,
                                    core.runner.inv_idx32,
                                    core.softmax_plan, plain)
        p.backward(g)
        res.append((p.detach(), ff.grad, None if ss is None else ss.grad))
    (p_k, d_k, s_k), (p_p, d_p, s_p) = res
    assert ((p_k - p_p).abs() / p_p).max() < SOFTMAX_REL
    assert _rel(d_k, d_p) < NORM_REL
    if sink is not None:
        assert _rel(s_k, s_p) < NORM_REL
        rows = torch.zeros(H * L, dtype=torch.float64, device=cuda_device)
        rows.index_add_(0, sm._head_rows(core.row_ptr, H, cuda_device),
                        p_k.reshape(-1).double())
        assert float(rows.max()) < 1.0


def test_full_layer_softmax_at_4096_against_fp64(cuda_device):
    """The full layer's softmax at the cell's L = 4096, forward and
    backward through the kernel, against the plain route in float64: the
    causal rows of 641 to 4096 entries (97.6 % of the entries) take the
    block rows, every head of them."""
    n_pos, scale = 4096, D ** -0.5
    st = HybridAttentionStack(n_pos, ["full"], [KINDS["full"]], F, H, D, DV,
                              R, 0.707, device=cuda_device)
    core = st.cores["full"]
    plan = core.softmax_plan
    assert plan.counts() == (128, 512, 3456, 0)
    assert plan.entries[2] / sum(plan.entries) > 0.975
    gen = torch.Generator(cuda_device).manual_seed(11)
    flat = torch.randn((H, core.runner.packed.packed_size),
                       device=cuda_device, generator=gen) * 4
    g = torch.randn((H, core.nnz), device=cuda_device, generator=gen)
    inv = core.runner.inv_idx32
    x = flat.clone().requires_grad_()
    p = sm.segment_softmax_sink(x, None, core.row_ptr, scale, inv, plan)
    p.backward(g)
    p, d = p.detach(), x.grad[:, inv.long()]
    worst, err, norm = 0.0, 0.0, 0.0
    for h0 in range(0, H, 8):
        p64 = sm.segment_softmax_plain(flat[h0:h0 + 8].double(),
                                       core.row_ptr, scale, inv)
        d64 = sm.segment_softmax_backward_plain(
            p64, g[h0:h0 + 8].double(), core.row_ptr, scale)
        worst = max(worst, float(((p[h0:h0 + 8] - p64).abs() / p64).max()))
        err += float((d[h0:h0 + 8].double() - d64).norm()) ** 2
        norm += float(d64.norm()) ** 2
    assert worst < SOFTMAX_REL
    assert (err / norm) ** 0.5 < NORM_REL


def test_rope_forward_and_backward(cuda_device):
    """RoPE in place on q_pad and k_pad and its inverse into new tensors,
    against the plain version (the same rounded products and sums), the
    sentinel row and the unrotated dims untouched."""
    gen = torch.Generator(cuda_device).manual_seed(9)
    table = rp.rope_table(L, R, 1e4, cuda_device)
    q = torch.randn((H, L + 1, D), device=cuda_device, generator=gen)
    k = torch.randn((8, L + 1, D), device=cuda_device, generator=gen)
    q[:, L] = 0
    k[:, L] = 0
    gq, gk = torch.randn_like(q), torch.randn_like(k)
    want = (rp.rope_plain(q, table), rp.rope_plain(k, table))
    dwant = (rp.rope_plain(gq, table, True), rp.rope_plain(gk, table, True))
    n = _kernels.launches[_kernels.ROPE_ENTRY]
    qq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
    qo, ko = rp.apply_rope(qq * 1, kk * 1, table)
    torch.autograd.backward((qo, ko), (gq, gk))
    assert _kernels.launches[_kernels.ROPE_ENTRY] == n + 2
    for got, exp in ((qo, want[0]), (ko, want[1]), (qq.grad, dwant[0]),
                     (kk.grad, dwant[1])):
        assert float((got - exp).abs().max()) <= 1e-6 * float(
            exp.abs().max())
    assert torch.equal(qo[:, :, R:], q[:, :, R:])
    assert not qo[:, L].any()


class _Ops(TorchDispatchMode):
    """Every aten op's inputs' storages and outputs' shapes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a.untyped_storage().data_ptr() for a in
               torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o.shape for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        self.ops.append((str(func), ins, outs))
        return out


@pytest.mark.parametrize("kind", ["full", "window"])
def test_no_key_or_value_copied_to_the_query_heads(kind, cuda_device,
                                                   monkeypatch):
    """A layer's forward and backward: the kernels take K and V of Hkv
    heads with the group's head shift (the tile kernel, the gather-dots,
    the SpMM and tile-grad), V's gradient sums the group (sum_heads = G),
    and no torch op reads K's or V's storage and writes a tensor of the
    64 query heads."""
    _, layer, core = _layer(kind, cuda_device)
    kv = KINDS[kind].kv_heads
    shift = (H // kv).bit_length() - 1
    calls = []
    real = _kernels.launch
    monkeypatch.setattr(_kernels, "launch",
                        lambda name, *a: (calls.append((name, a)),
                                          real(name, *a))[1])
    kept = {}
    project = ha.qkv_project

    def spy(*a, **kw):
        q, k, v = project(*a, **kw)
        kept["kv"] = {k.untyped_storage().data_ptr(),
                      v.untyped_storage().data_ptr()}
        return q, k, v

    monkeypatch.setattr(ha, "qkv_project", spy)
    x = torch.randn(L, F, device=cuda_device, requires_grad=True)
    with _Ops() as mode:
        layer(x).square().mean().backward()
    torch.cuda.synchronize()
    by = {}
    for name, args in calls:
        by.setdefault(name, []).append(args)
    tile = by["sddmm_tile_dot_float32"]
    assert [a[13] for a in tile] == [H] and [a[17] for a in tile] == [shift]
    gathers = [a for n, al in by.items() if n.startswith("sddmm_gather_dot")
               for a in al]
    assert gathers and all(a[19] == H and a[24] == shift for a in gathers)
    spmm = by[_kernels.SPMM_ENTRY]
    # (out heads, sum_heads, kv_shift): the aggregation reads V of the
    # group; dV sums the group's query heads
    assert (H, 1, shift) in [(a[19], a[21], a[22]) for a in spmm]
    assert (kv, H // kv, 0) in [(a[19], a[21], a[22]) for a in spmm]
    assert by[_kernels.TILE_GRAD_ENTRY][0][22] == shift
    assert by[_kernels.TILE_GRAD_REDUCE_ENTRY][0][15] == shift
    for op, ins, outs in mode.ops:
        if kept["kv"] & set(ins):
            assert not any(len(s) and s[0] == H for s in outs), op
