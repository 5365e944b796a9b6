"""The plain reference against dense float64 computations at tiny size."""

import numpy as np
import pytest
import torch

from perfbench import patterns, reference


def _dense_mask(pat):
    mask = np.zeros((pat.m, pat.n), dtype=bool)
    mask[pat.row_idx(), pat.col_idx] = True
    return mask


def test_sddmm_matches_dense_product():
    pat = patterns.powerlaw(40, 5, seed=1)
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 2, (41, 16)).astype(np.float32)
    bt = rng.uniform(0, 2, (41, 16)).astype(np.float32)
    got = reference.sddmm(pat, torch.from_numpy(a), torch.from_numpy(bt))
    full = a[:40].astype(np.float64) @ bt[:40].astype(np.float64).T
    want = full[pat.row_idx(), pat.col_idx]
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)


def test_sddmm_blocks_cover_every_entry(monkeypatch):
    monkeypatch.setattr(reference, "SDDMM_BLOCK", 7)
    pat = patterns.powerlaw(64, 6, seed=2)
    a = torch.rand(65, 8, dtype=torch.float32)
    bt = torch.rand(65, 8, dtype=torch.float32)
    want = (a[:64].double() @ bt[:64].double().T)[
        torch.as_tensor(pat.row_idx()), torch.as_tensor(pat.col_idx).long()]
    torch.testing.assert_close(reference.sddmm(pat, a, bt), want)


def test_rounding_controls():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -11 + 2 ** -13,
                      -(1.0 + 2 ** -12), 1.0 + 2 ** -11,
                      -(1.0 + 2 ** -11)], dtype=torch.float32)
    got = reference.round_tf32(x)
    # 10 mantissa bits: steps of 2^-10 at 1; ties away from zero
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, -1.0, 1.0 + 2 ** -10,
                            -(1.0 + 2 ** -10)]
    y = torch.rand(1000) * 4
    err = ((reference.round_tf32(y) - y).abs() / y).max()
    assert 0 < float(err) <= 2 ** -11


def _numpy_attention(ws, x, mask):
    w_q, w_k, w_v, w_o = (np.asarray(w, np.float64) for w in ws)
    x = np.asarray(x, np.float64)
    heads = []
    for h in range(w_q.shape[0]):
        q, k, v = x @ w_q[h], x @ w_k[h], x @ w_v[h]
        s = q @ k.T / np.sqrt(q.shape[1])
        s = np.where(mask, s, -np.inf)
        e = np.exp(s - s.max(axis=1, keepdims=True))
        heads.append((e / e.sum(axis=1, keepdims=True)) @ v)
    return np.concatenate(heads, axis=1) @ w_o


def _tiny(seed=0, L=24, F=8, H=2, D=4):
    g = torch.Generator().manual_seed(seed)
    ws = tuple(torch.randn(*shape, generator=g)
               for shape in ((H, F, D), (H, F, D), (H, F, D), (H * D, F)))
    x = torch.randn(L, F, generator=g)
    pat = patterns.attention_window(L, 3, 1)
    return ws, x, pat


def test_attention_matches_numpy():
    ws, x, pat = _tiny()
    got = reference.attention(ws, x, reference.dense_mask(pat, "cpu"))
    want = _numpy_attention(ws, x.numpy(), _dense_mask(pat))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_attention_lower_precisions_differ():
    ws, x, pat = _tiny(1)
    mask = reference.dense_mask(pat, "cpu")
    exact = reference.attention(ws, x, mask)
    gaps = {p: float((reference.attention(ws, x, mask, p).double()
                      - exact).abs().max() / exact.abs().max())
            for p in ("tf32", "bfloat16")}
    assert 1e-5 < gaps["tf32"] < gaps["bfloat16"] < 0.1


def test_stack_adds_each_layer_to_its_input():
    ws, x, pat = _tiny(4)
    mask = reference.dense_mask(pat, "cpu")
    ws2 = tuple(w * 0.5 for w in ws)
    h = x.double() + reference.attention(ws, x, mask)
    want = h + reference.attention(ws2, h, mask)
    torch.testing.assert_close(reference.stack([ws, ws2], x, mask), want)


def test_train_adam_matches_torch_adam():
    # two layers, batches of two sequences: the reference's per-layer
    # recomputation against autograd through the whole stack
    ws, x, pat = _tiny(2)
    layers = [ws, tuple(w * 0.7 for w in ws)]
    mask = reference.dense_mask(pat, "cpu")
    y = torch.randn_like(x)
    batches = [[(x, y), (x * 0.5, -y)], [(x * 2, y), (-x, y)],
               [(x, -y), (x * 0.3, y * 2)]]
    losses, grads, final = reference.train(layers, batches, mask, lr=1e-2)
    params = [w.double().clone().requires_grad_(True)
              for ws_l in layers for w in ws_l]
    opt = torch.optim.Adam(params, lr=1e-2)
    want_losses = []
    for i, batch in enumerate(batches):
        opt.zero_grad()
        stacked = [params[:4], params[4:]]
        loss = sum(reference.mse(reference.stack(stacked, xb, mask), yb)
                   for xb, yb in batch) / len(batch)
        loss.backward()
        if i == 0:
            assert len(grads) == len(params)
            for g, p in zip(grads, params):
                torch.testing.assert_close(g, p.grad)
        opt.step()
        want_losses.append(float(loss.detach()))
    assert losses == pytest.approx(want_losses, rel=1e-12)
    for p, q in zip(final, params):
        torch.testing.assert_close(p, q.detach())
