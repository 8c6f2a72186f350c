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
  BIT-EQUAL;
* RMSNorm (B4): fp32 at rtol = atol = 1e-6, bf16 at 1e-2 (the JAX tests'
  tolerances; the order of the sum of squares is free);
* flash attention (B5), fp32 at 2e-5 (the JAX tests' tolerance: fp32
  summation order): causal, window 64, sq < sk, GQA and MQA, a length
  that is not a tile multiple; bf16 at 2e-2.

Also the package example ``repro_torch.examples.dataflow_stencil``: its
three errors equal the JAX example's.
"""

import os
import pathlib
import subprocess
import sys

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
