"""The port's training attention (``layers.attention_blocked``, the
``BlockedAttention`` autograd Function) against the JAX package's
``attention_xla`` and ``jax.grad`` through its custom VJP, on the same
numpy inputs: forward and dq, dk, dv in fp32 to rtol = atol = 1e-4
(readings ~4e-6), every mask case of ``tests/test_attention_vjp.py``,
MQA with uneven sequences, dv != d, uneven sq / sk and bf16 probabilities;
and what the Function keeps between forward and backward: only
(q, k, v, out, lse)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L

RTOL = ATOL = 1e-4


def _inputs(seed, b, hq, hkv, sq, sk, d, dv):
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.standard_normal(s).astype(np.float32)
    return (mk((b, hq, sq, d)), mk((b, hkv, sk, d)), mk((b, hkv, sk, dv)),
            mk((b, hq, sq, dv)))


def _jax(q, k, v, w, kw, p_bf16=False):
    """(out, (dq, dk, dv)) of sum(attention_xla(q, k, v) * w), jitted
    (the probability flag is read while tracing)."""
    def run(q, k, v, w):
        JL._P_BF16[0] = p_bf16
        try:
            out, vjp = jax.vjp(lambda *a: JL.attention_xla(*a, **kw),
                               q, k, v)
        finally:
            JL._P_BF16[0] = False
        return out, vjp(w)
    out, grads = jax.jit(run)(*[jnp.asarray(a) for a in (q, k, v, w)])
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch(q, k, v, w, kw, p_bf16=False):
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = L.attention_blocked(*leaves, p_bf16=p_bf16, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _hold(ref, got):
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL, atol=ATOL)
    for name, a, b in zip(("dq", "dk", "dv"), ref[1], got[1]):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=48),
    dict(causal=True, block_skip=True),
    dict(causal=True, window=48, block_skip=True),
])
def test_fwd_and_grad_match_jax(kw):
    q, k, v, w = _inputs(0, 2, 4, 2, 192, 192, 32, 32)
    kw = dict(kw, block_q=64, block_k=64)
    _hold(_jax(q, k, v, w, kw), _torch(q, k, v, w, kw))


@pytest.mark.parametrize("shape,kw", [
    # MQA, a sequence that is no multiple of the blocks
    ((1, 6, 1, 100, 100, 32, 32), dict(causal=True)),
    # MLA's d_qk != d_v
    ((1, 2, 2, 64, 64, 48, 32), dict(causal=True, block_q=32, block_k=32)),
    # fewer queries than keys (query i at sk - sq + i), banded skip
    ((1, 2, 1, 40, 100, 16, 16), dict(causal=True, window=30,
                                      block_skip=True, block_q=16,
                                      block_k=32)),
    ((2, 4, 2, 24, 80, 16, 16), dict(causal=True, block_skip=True,
                                     block_q=16, block_k=16)),
])
def test_mqa_uneven_and_v_dim(shape, kw):
    q, k, v, w = _inputs(1, *shape)
    kw.setdefault("block_q", 64)
    kw.setdefault("block_k", 64)
    _hold(_jax(q, k, v, w, kw), _torch(q, k, v, w, kw))


def test_bf16_probabilities_match_jax():
    """``attn_p_bf16``: bf16 P and V into the PV product, fp32 sums."""
    q, k, v, w = _inputs(2, 1, 4, 2, 128, 128, 32, 32)
    kw = dict(causal=True, block_q=64, block_k=64)
    _hold(_jax(q, k, v, w, kw, p_bf16=True),
          _torch(q, k, v, w, kw, p_bf16=True))


def test_block_skip_changes_no_bit():
    """Skipping dead tiles leaves out only exact zeros."""
    q, k, v, w = _inputs(3, 1, 2, 2, 256, 256, 32, 32)
    a = _torch(q, k, v, w, dict(causal=True, block_q=64, block_k=64))
    b = _torch(q, k, v, w, dict(causal=True, block_q=64, block_k=64,
                                block_skip=True))
    np.testing.assert_array_equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)


def test_rows_with_no_live_key_give_zero():
    """A window of 0 leaves no key to any query: out 0, no NaN, grads 0."""
    q, k, v, w = _inputs(4, 1, 2, 1, 32, 32, 16, 16)
    out, grads = _torch(q, k, v, w, dict(causal=True, window=0, block_q=16,
                                         block_k=16))
    assert not out.any() and all(not g.any() for g in grads)


def test_saves_only_q_k_v_out_lse():
    """Between forward and backward the Function holds (q, k, v, out,
    lse) and nothing else: no (sq, sk) score or probability matrix."""
    b, hq, hkv, s, d = 1, 4, 2, 96, 32
    q, k, v, _ = _inputs(5, b, hq, hkv, s, s, d, d)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    packed = []

    def pack(t):
        packed.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = L.attention_blocked(*leaves, block_q=32, block_k=32)
    assert [tuple(t.shape) for t in packed] == [
        (b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d),
        (b, hq, s, 1)]
    assert all(x is y for x, y in zip(packed[:3], leaves))
    assert torch.equal(packed[3], out)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[4].dtype == torch.float32


def test_train_mode_routes_through_the_function():
    """``forward(mode="train")`` attends through ``BlockedAttention``
    (GQA and MLA layers alike); prefill keeps the plain softmax."""
    from repro_torch.configs import get
    from repro_torch.configs.base import smoke_variant
    from repro_torch.models import registry
    calls = []
    real = L.BlockedAttention.apply

    def spy(*a):
        calls.append(a[6:9])                     # block_q, block_k, skip
        return real(*a)

    for arch in ("minitron-4b", "deepseek-v2-lite-16b"):
        cfg = smoke_variant(get(arch))
        params = registry.init(cfg, 0, device="cpu")
        batch = registry.make_batch(cfg, "train", 1, 8, device="cpu")
        calls.clear()
        L.BlockedAttention.apply = spy
        try:
            registry.forward(cfg, params, batch, mode="train")
            assert calls == [(cfg.attn_block_q, cfg.attn_block_k,
                              cfg.attn_block_skip)] * cfg.n_layers
            calls.clear()
            registry.forward(cfg, params, batch, mode="prefill")
            assert calls == []
        finally:
            L.BlockedAttention.apply = real
