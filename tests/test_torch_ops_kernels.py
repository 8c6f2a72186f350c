"""Port parity: kernels B8, B7, B4, B5 and the ``kernels/ops.py`` entry points.

The plain twins the CUDA kernels are held against on the card, and the
``ops`` wrappers on both branches (``use_pallas`` True: the kernel's
wrapper, which runs its twin on CPU tensors; False: the reference
formula), against the JAX Pallas kernels in interpret mode and the JAX
``ops`` wrappers, at the shapes ``tests/test_kernels.py`` and
``tests/test_new_kernels.py`` parametrize:

* stencil (B8) at (64, 128), (200, 256), (33, 128): BIT-EQUAL, fp32 and
  bf16, one sweep and iterated;
* tree row reduce (B7) at (10, 128), (100, 300), (7, 1000) x {add, max}:
  BIT-EQUAL; and the card kernel's combine orders (a warp per row with
  W-wide lanes, a row split over CTAs into fp32 partials), mirrored in
  Python, bit-equal to the twin; its split count from shapes alone, and
  its wrapper reading no device tensor on the host;
* RMSNorm (B4): fp32 at rtol = atol = 1e-6, bf16 at 1e-2 (the JAX tests'
  tolerances; the order of the sum of squares is free), also at the card
  kernel's edge widths; its plan (warps per row, rows per CTA) from
  shapes alone, and its wrapper reading no device tensor on the host;
* flash attention (B5), fp32 at 2e-5 (the JAX tests' tolerance: fp32
  summation order): causal, window 64, sq < sk, GQA and MQA, a length
  that is not a tile multiple; bf16 at 2e-2.

Also the package example ``repro_torch.examples.dataflow_stencil``: its
three errors equal the JAX example's.
"""

import itertools
import os
import pathlib
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.rmsnorm_kernel import rmsnorm as jrms
from repro.kernels.stencil import stencil2d as jstencil
from repro.kernels.stencil import stencil2d_iterated as jstencil_it
from repro.kernels.treereduce_kernel import tree_row_reduce as jtree
from repro_torch.kernels import ops
from repro_torch.kernels import treereduce_kernel as tk
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm_kernel import rmsnorm, rmsnorm_plain
from repro_torch.kernels.stencil import (stencil2d, stencil2d_iterated,
                                         stencil2d_plain)
from repro_torch.kernels.treereduce_kernel import (tree_row_reduce,
                                                   tree_row_reduce_plain)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _pair(x, dtype="float32"):
    """The same values as a JAX array and a torch tensor (bf16 rounded
    to nearest even by both)."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


# --- stencil (B8) ---------------------------------------------------------------------

STENCIL_SHAPES = [(64, 128, 32), (200, 256, 64), (33, 128, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,br", STENCIL_SHAPES)
def test_stencil_twin_bit_equal(h, w, br, dtype):
    jx, tx = _pair(_np((h, w), h), dtype)
    want = jstencil(jx, block_rows=br, interpret=True)
    for got in (stencil2d_plain(tx), stencil2d(tx)):
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("h,w,br", STENCIL_SHAPES)
def test_stencil_iterated_bit_equal(h, w, br):
    jx, tx = _pair(_np((h, w), w))
    want = jstencil_it(jx, 4, block_rows=br, interpret=True)
    got = stencil2d_iterated(tx, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(stencil2d_iterated(tx, 0).numpy(),
                                  tx.numpy())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ops_stencil_bit_equal(use_pallas):
    jx, tx = _pair(_np((64, 128), 1))
    want = jops.stencil(jx, use_pallas=use_pallas, block_rows=32)
    got = ops.stencil(tx, use_pallas=use_pallas, block_rows=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- tree row reduce (B7) -------------------------------------------------------------


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("rows,n", [(10, 128), (100, 300), (7, 1000)])
def test_tree_row_reduce_twin_bit_equal(rows, n, op):
    jx, tx = _pair(_np((rows, n), n))
    want = np.asarray(jtree(jx, op=op, interpret=True))
    for got in (tree_row_reduce_plain(tx, op), tree_row_reduce(tx, op)):
        assert got.shape == (rows,) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["add", "max"])
def test_tree_row_reduce_bf16_bit_equal(op):
    jx, tx = _pair(_np((9, 777), 5), "bfloat16")
    want = jtree(jx, op=op, interpret=True)
    got = tree_row_reduce(tx, op)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_ops_row_reduce(use_pallas, op):
    jx, tx = _pair(_np((100, 300), 2))
    want = np.asarray(jops.row_reduce(jx, op=op, use_pallas=use_pallas))
    got = ops.row_reduce(tx, op=op, use_pallas=use_pallas).numpy()
    if use_pallas:
        np.testing.assert_array_equal(got, want)
    else:       # jnp.sum and torch.sum: each its own order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_tree_row_reduce_rejects_unknown_op():
    with pytest.raises(ValueError):
        tree_row_reduce(torch.zeros(2, 4), "min")


# B7's card design, mirrored in Python: the kernel's combine orders, each
# in fp32, must be bit-equal to the plain twin's halving.

_COMBINE = {"add": torch.add, "max": torch.maximum}


def _padded_f32(x, op, length):
    """x (rows, n) padded with the identity to ``length``, in fp32."""
    ident = 0.0 if op == "add" else -np.inf
    rows, n = x.shape
    pad = torch.full((rows, length - n), ident, dtype=x.dtype)
    return torch.cat([x, pad], dim=1).float()


def _jtree(leaf, J, combine):
    """The kernel's stage 1 (``jtree``): the halving tree over j of
    ``leaf(j)``, J = R * 2^m leaves, streamed in subtrees j = lo + 2^m h
    (h < R, R = min(J, 8)) halved in registers and merged on a
    binary-counter stack in bit-reversed order of lo."""
    R = min(J, 8)
    nchunks = J // R
    m = nchunks.bit_length() - 1
    stack = {}
    for k in range(nchunks):
        lo = int(format(k, f"0{m}b")[::-1], 2) if m else 0
        v = [leaf(lo + nchunks * h) for h in range(R)]
        half = R // 2
        while half >= 1:
            v = [combine(v[h], v[h + half]) for h in range(half)]
            half //= 2
        acc, kk, level = v[0], k, 0
        while kk & 1:
            acc = combine(stack[level], acc)
            kk >>= 1
            level += 1
        stack[level] = acc
    return acc


def _halve(v, combine):
    """Halving over the last axis (a power of two long)."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = combine(v[..., :half], v[..., half:])
    return v[..., 0]


def _warp_order(x, op, W):
    """One warp per row: lane l holds elements W l + c + 32 W j; halving
    over j in the lane, then over lanes (shuffle down), then over the W
    components of lane 0."""
    combine = _COMBINE[op]
    rows, n = x.shape
    p2 = 1 << (n - 1).bit_length()
    span = max(p2, 32 * W)
    xp = _padded_f32(x, op, span)
    J = span // (32 * W)
    acc = _jtree(lambda j: xp[:, 32 * W * j:32 * W * (j + 1)].reshape(
        rows, 32, W), J, combine)
    lanes = min(32, max(1, p2 // W))
    acc = _halve(acc[:, :lanes].transpose(1, 2), combine)    # (rows, W)
    return _halve(acc[:, :min(W, p2)], combine).to(x.dtype)


def _split_order(x, op, C):
    """A row split over C CTAs: residue t of Q = 512 C halves over j its
    x[t + Q j] (into the fp32 scratch), then one CTA of P = min(Q, 1024)
    threads halves each thread's t + P j and the P values."""
    combine = _COMBINE[op]
    rows, n = x.shape
    p2 = 1 << (n - 1).bit_length()
    Q = tk.TREE_SPLIT_RESIDUES * C
    xp = _padded_f32(x, op, p2)
    part = _jtree(lambda j: xp[:, Q * j:Q * (j + 1)], p2 // Q, combine)
    assert part.dtype == torch.float32 and part.shape == (rows, Q)
    P = min(Q, 1024)
    per = _jtree(lambda j: part[:, P * j:P * (j + 1)], Q // P, combine)
    return _halve(per, combine).to(x.dtype)


def _tree_input(rows, n, dtype, seed):
    """Values over many binades, so that any other combine order rounds
    differently."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)) * np.exp2(rng.integers(-12, 12,
                                                              (rows, n)))
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["add", "max"])
def test_tree_kernel_orders_bit_equal_to_twin(op, dtype):
    """The warp-per-row order (W = 1, 4 and 8 lanes' components) and the
    split order (C = 2 ... 16 CTAs per row) are the plain halving, bit
    for bit, at lengths around every vector and tile edge."""
    for n in (1, 3, 4, 5, 8, 31, 128, 129, 1000, 1001, 4096, 4097, 70000):
        x = _tree_input(3, n, dtype, n)
        want = tree_row_reduce_plain(x, op)
        for W in (1, 4, 8):
            got = _warp_order(x, op, W)
            assert torch.equal(got, want), (n, W)
        p2 = 1 << (n - 1).bit_length()
        for C in (2, 4, 16):
            if tk.TREE_SPLIT_RESIDUES * C <= p2:
                assert torch.equal(_split_order(x, op, C), want), (n, C)


def test_tree_orders_have_teeth():
    """A left-to-right fp32 sum of the same input rounds differently, so
    the bit-equality above tests the order."""
    x = _tree_input(3, 4097, torch.float32, 1)
    seq = torch.zeros(3)
    for j in range(x.shape[1]):
        seq = seq + x[:, j]
    assert not torch.equal(seq, tree_row_reduce_plain(x, "add"))


def test_tree_split_count_comes_from_shapes_alone():
    """A warp per row when the rows fill the card; otherwise the fewest
    power-of-two splits that give two CTAs per SM, as long as each
    residue's tree spans at least TREE_MIN_LEAVES elements."""
    assert tk.tree_splits(32768, 4096, 132) == 1     # main shape
    assert tk.tree_splits(16, 256000, 132) == 32     # long: 512 CTAs
    assert tk.tree_splits(1, 1 << 24, 132) == 512
    assert tk.tree_splits(7, 1000, 132) == 1
    assert tk.tree_splits(4, 65536, 132) == 16       # capped by leaves
    for rows, n in itertools.product((1, 3, 16, 100, 264, 5000),
                                     (1, 100, 4096, 65537, 256000, 1 << 24)):
        c = tk.tree_splits(rows, n, 132)
        p2 = 1 << (n - 1).bit_length()
        assert c >= 1 and c & (c - 1) == 0
        if c > 1:
            assert p2 // (tk.TREE_SPLIT_RESIDUES * c) >= tk.TREE_MIN_LEAVES
        assert (rows * c >= 2 * 132 or p2 // (tk.TREE_SPLIT_RESIDUES * 2 * c)
                < tk.TREE_MIN_LEAVES)


@pytest.mark.parametrize("rows,n,dtype,n_split", [
    (16, 256000, torch.bfloat16, 32), (32768, 4096, torch.float32, 1)])
def test_tree_wrapper_reads_no_device_tensor_on_the_host(
        monkeypatch, rows, n, dtype, n_split):
    """With meta tensors (which hold no data), the CUDA path of B7's
    wrapper reaches the launch with the split count of the shapes and,
    when split, an fp32 scratch of 512 partials per CTA."""
    calls, scratch = [], []
    empty = torch.empty

    def spy_empty(*args, **kw):
        t = empty(*args, **kw)
        scratch.append(t)
        return t

    monkeypatch.setattr(tk, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(tk, "_kernel",
                        lambda: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(tk, "sm_count", lambda index: 132)
    monkeypatch.setattr(tk.torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    x = torch.zeros((rows, n), dtype=dtype, device="meta")
    monkeypatch.setattr(tk.torch, "empty", spy_empty)
    before = tree_row_reduce.launches
    out = tree_row_reduce(x, "max")
    assert out.device.type == "meta" and out.shape == (rows,)
    assert out.dtype == dtype
    assert tree_row_reduce.launches == before + 1
    assert len(calls) == 1 and calls[0][5] == n_split
    parts = scratch[1:]
    if n_split == 1:
        assert parts == [] and calls[0][2] is None
    else:
        assert [tuple(t.shape) for t in parts] == [
            (rows, tk.TREE_SPLIT_RESIDUES * n_split)]
        assert parts[0].dtype == torch.float32


# --- RMSNorm (B4) ---------------------------------------------------------------------


@pytest.mark.parametrize("rows,d", [(64, 128), (100, 256), (5, 512)])
def test_rmsnorm_twin_fp32(rows, d):
    jx, tx = _pair(_np((rows, d), d))
    jw, tw = _pair(_np((d,), rows, 0.1))
    want = np.asarray(jrms(jx, jw, interpret=True))
    for got in (rmsnorm_plain(tx, tw), rmsnorm(tx, tw)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_rmsnorm_twin_bf16():
    jx, tx = _pair(_np((32, 128), 7), "bfloat16")
    jw, tw = _pair(_np((128,), 8, 0.1))
    want = jrms(jx, jw, interpret=True)
    got = rmsnorm(tx, tw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("rows,d,x_dtype,w_dtype", [
    (1, 3072, "bfloat16", "bfloat16"), (8, 3071, "float32", "bfloat16"),
    (3, 1001, "bfloat16", "float32"), (2, 16384, "bfloat16", "bfloat16"),
    (2, 16384, "float32", "float32")])
def test_rmsnorm_twin_at_the_kernel_edges(rows, d, x_dtype, w_dtype):
    """The card kernel's edge widths (one row; d not a multiple of the
    16-byte vector; rows wider than its registers hold; mixed x and w
    dtypes): the twin it is held to on the card against the JAX kernel."""
    jx, tx = _pair(_np((rows, d), d + rows), x_dtype)
    jw, tw = _pair(_np((d,), d, 0.1), w_dtype)
    want = jrms(jx, jw, interpret=True)
    got = rmsnorm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (rows, d)
    tol = 1e-6 if x_dtype == "float32" else 1e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("rows,d,x_bytes,plan", [
    (4096, 3072, 2, (1, 4)),      # main: a warp per row, 4 rows per CTA
    (8, 3072, 2, (8, 1)),         # few rows: 8 warps each
    (4096, 3072, 4, (2, 2)),      # fp32: 768 vectors, two warps per row
    (4096, 3071, 2, (8, 1)),      # scalars: 3071 of them, 8 warps
    (4096, 16384, 2, (8, 1)),     # 2048 vectors
    (64, 16384, 4, (0, 1)),       # 4096 vectors: the two-pass kernel
    (1, 100, 4, (8, 1))])
def test_rmsnorm_plan(rows, d, x_bytes, plan):
    from repro_torch.kernels.rmsnorm_kernel import (RMS_MAX_VECS,
                                                    rmsnorm_plan)
    wpr, rpc = rmsnorm_plan(rows, d, x_bytes, 132)
    assert (wpr, rpc) == plan
    v = 16 // x_bytes
    nvec = d // v if d % v == 0 else d
    if wpr:
        assert nvec <= 32 * wpr * RMS_MAX_VECS and wpr * rpc <= 8


def test_rmsnorm_wrapper_reads_no_device_tensor_on_the_host(monkeypatch):
    """With meta tensors (which hold no data), the CUDA path of B4's
    wrapper reaches the launch with the plan of the shapes."""
    from repro_torch.kernels import rmsnorm_kernel as rk
    calls = []
    monkeypatch.setattr(rk, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(rk, "_kernel",
                        lambda: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(rk, "sm_count", lambda index: 132)
    monkeypatch.setattr(rk.torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    x = torch.zeros((8, 3072), dtype=torch.bfloat16, device="meta")
    w = torch.zeros((3072,), dtype=torch.float32, device="meta")
    before = rk.rmsnorm.launches
    out = rk.rmsnorm(x, w)
    assert out.device.type == "meta" and out.shape == (8, 3072)
    assert out.dtype == torch.bfloat16
    assert rk.rmsnorm.launches == before + 1
    assert len(calls) == 1 and calls[0][3:5] == (8, 3072)
    assert calls[0][6:10] == (1, 0, 8, 1)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ops_fused_rmsnorm(use_pallas):
    jx, tx = _pair(_np((64, 3072), 3))
    jw, tw = _pair(_np((3072,), 4, 0.1))
    want = np.asarray(jops.fused_rmsnorm(jx, jw, use_pallas=use_pallas))
    got = ops.fused_rmsnorm(tx, tw, use_pallas=use_pallas).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# --- flash attention (B5) -------------------------------------------------------------

# (b, hq, hkv, sq, sk, d, window)
ATTN_CASES = {
    "causal MHA": (1, 2, 2, 128, 128, 64, None),
    "GQA": (2, 4, 2, 256, 256, 64, None),
    "MQA": (1, 8, 1, 128, 128, 128, None),
    "not a tile multiple": (1, 2, 2, 192, 192, 32, None),
    "window 64": (1, 2, 2, 256, 256, 64, 64),
    "sq < sk (decode alignment)": (2, 4, 4, 1, 300, 64, None),
    "sq < sk, GQA, window": (1, 4, 2, 100, 300, 32, 48),
}


def _attn_inputs(case, dtype="float32"):
    b, hq, hkv, sq, sk, d, window = ATTN_CASES[case]
    seed = sum(ATTN_CASES[case][:6])
    q = _pair(_np((b, hq, sq, d), seed), dtype)
    k = _pair(_np((b, hkv, sk, d), seed + 1), dtype)
    v = _pair(_np((b, hkv, sk, d), seed + 2), dtype)
    return q, k, v, window


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_twin_fp32(case):
    (jq, tq), (jk, tk), (jv, tv), window = _attn_inputs(case)
    want = np.asarray(jflash(jq, jk, jv, causal=True, window=window,
                             block_q=64, block_k=64, interpret=True))
    for got in (flash_attention_plain(tq, tk, tv, window=window),
                flash_attention(tq, tk, tv, window=window)):
        assert got.shape == tq.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["GQA", "window 64"])
def test_flash_attention_twin_bf16(case):
    (jq, tq), (jk, tk), (jv, tv), window = _attn_inputs(case, "bfloat16")
    want = jflash(jq, jk, jv, causal=True, window=window, block_q=64,
                  block_k=64, interpret=True)
    got = flash_attention(tq, tk, tv, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)


def test_flash_attention_non_causal_and_empty_rows():
    """causal=False attends every key; a row whose window holds no key
    (queries before the keys start: sq > sk) outputs 0, as the kernel's
    l == 0 guard does."""
    (jq, tq), (jk, tk), (jv, tv), _ = _attn_inputs("GQA")
    want = np.asarray(jflash(jq, jk, jv, causal=False, block_q=64,
                             block_k=64, interpret=True))
    got = flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    got = flash_attention_plain(tq, tk[:, :, :200], tv[:, :, :200])
    assert torch.equal(got[:, :, :56], torch.zeros_like(got[:, :, :56]))
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", ["GQA", "window 64",
                                  "sq < sk (decode alignment)"])
def test_ops_attention(case, use_pallas):
    (jq, tq), (jk, tk), (jv, tv), window = _attn_inputs(case)
    want = np.asarray(jops.attention(jq, jk, jv, window=window,
                                     use_pallas=use_pallas, block_q=64,
                                     block_k=64))
    got = ops.attention(tq, tk, tv, window=window, use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# --- the other ops entry points -------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ops_paged_decode_attention(use_pallas):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 4, 1, 32)).astype(np.float32)
    kp, vp = (rng.standard_normal((8, 2, 8, 32)).astype(np.float32)
              for _ in range(2))
    bt = rng.permutation(8).reshape(2, 4).astype(np.int32)
    pos = np.array([5, 20], np.int32)
    want = np.asarray(jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(bt), jnp.asarray(pos),
        use_pallas=use_pallas))
    got = ops.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(bt),
        torch.from_numpy(pos), use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ops_kv_quant_bit_equal(use_pallas):
    x = _np((300, 64), 12, 3.0)
    jq, js = jops.kv_quant(jnp.asarray(x), use_pallas=use_pallas)
    tq, ts = ops.kv_quant(torch.from_numpy(x), use_pallas=use_pallas)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_f32(ts).reshape(-1),
                                  _f32(js).reshape(-1))


def test_ops_ssd_waits_for_its_slice():
    """``ops.ssd`` raised until the mamba2 slice; now both branches match
    the JAX ``ops.ssd`` (B6's twin against the Pallas kernel in interpret
    mode) to the JAX tests' 2e-4."""
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((2, 64, 3, 32)) * 0.5).astype(np.float32)
    dt = rng.uniform(0.1, 0.5, (2, 64, 3)).astype(np.float32)
    A = -rng.uniform(0.5, 1.5, (3,)).astype(np.float32)
    B, C = ((rng.standard_normal((2, 64, 16)) * 0.5).astype(np.float32)
            for _ in range(2))
    for use_pallas in (False, True):
        want = np.asarray(jops.ssd(*map(jnp.asarray, (x, dt, A, B, C)),
                                   chunk=16, use_pallas=use_pallas))
        got = ops.ssd(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=16,
                      use_pallas=use_pallas)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_cpu_tensors_run_twins_and_count_no_launch():
    fns = (stencil2d, tree_row_reduce, rmsnorm, flash_attention)
    before = [fn.launches for fn in fns]
    x = torch.ones(8, 16)
    stencil2d(x)
    stencil2d_iterated(x, 3)
    tree_row_reduce(x)
    rmsnorm(x, torch.zeros(16))
    q = torch.ones(1, 2, 4, 32)
    flash_attention(q, q, q)
    assert [fn.launches for fn in fns] == before


def test_wrappers_refuse_a_device_that_is_neither_cpu_nor_cuda():
    """No fallback: a tensor off the CPU launches the kernel or raises."""
    m = torch.empty(8, 16, device="meta")
    q = torch.empty(1, 2, 4, 32, device="meta")
    for call in (lambda: stencil2d(m), lambda: stencil2d_iterated(m, 2),
                 lambda: tree_row_reduce(m),
                 lambda: rmsnorm(m, torch.empty(16, device="meta")),
                 lambda: flash_attention(q, q, q)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()


# --- the package example --------------------------------------------------------------


def _errors(cmd):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if "max err:" in ln]
    assert len(lines) == 3, out.stdout
    return [float(ln.rsplit(":", 1)[1]) for ln in lines]


def test_package_example_reproduces_the_jax_example():
    port = _errors([sys.executable, "-m",
                    "repro_torch.examples.dataflow_stencil", "--device",
                    "cpu"])
    jax_ = _errors([sys.executable, str(ROOT / "examples" /
                                        "dataflow_stencil.py")])
    assert port == jax_
    assert port[0] < 1e-6 and port[1:] == [0.0, 0.0]
