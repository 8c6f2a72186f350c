"""Port parity: the Mamba2 SSD scan, its oracles and kernel B6's twin.

The same numpy-made inputs (the JAX tests' scales: x, B and C x 0.5,
dt ~ U(0.1, 0.5), A = -U(0.5, 1.5)) go through both packages:

* ``ref.ssd_recurrence_ref`` and ``ref.ssd_chunked_ref`` against the JAX
  oracles, with an incoming state, a ragged tail (``s % chunk != 0``,
  zero-dt padding) and state continuation across two calls;
* ``ssd_scan`` on CPU tensors (its plain twin, what the CUDA kernel is
  held against on the card) against the JAX Pallas kernel in interpret
  mode at the three shapes of ``tests/test_kernels.py``;
* ``ops.ssd`` against the JAX ``ops.ssd`` on both branches;
* the card kernel's order (C·Bᵀ once per (b, chunk), chunk-local states,
  the serial state pass, the C·S_in term), mirrored in Python, against
  the twin and the JAX Pallas kernel: one chunk, chunk 48, ds 16/48/128
  and a decay that underflows; its layout (``ssd_plan``) from shapes
  alone, and its wrapper reading no device tensor on the host.

Tolerance: rtol = atol = 2e-4, the JAX tests' own (fp32, sums in other
orders over up to 256 positions and several chunks); the port's oracles
against JAX's land far inside it (~1e-6).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jscan
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

torch.set_num_threads(2)

TOL = 2e-4


def _inputs(seed, b, s, h, dh, ds):
    """(x, dt, A, B, C) as numpy fp32; b None for one unbatched sequence."""
    rng = np.random.default_rng(seed)
    lead = (s,) if b is None else (b, s)
    x = (rng.standard_normal(lead + (h, dh)) * 0.5).astype(np.float32)
    dt = rng.uniform(0.1, 0.5, lead + (h,)).astype(np.float32)
    A = -rng.uniform(0.5, 1.5, (h,)).astype(np.float32)
    B = (rng.standard_normal(lead + (ds,)) * 0.5).astype(np.float32)
    C = (rng.standard_normal(lead + (ds,)) * 0.5).astype(np.float32)
    return x, dt, A, B, C


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_recurrence_matches_jax_with_incoming_state():
    arrs = _inputs(1, None, 40, 3, 16, 8)
    st = (np.random.default_rng(2).standard_normal((3, 8, 16)) * 0.5
          ).astype(np.float32)
    jy, js = jref.ssd_recurrence_ref(*_j(arrs), state=jnp.asarray(st))
    ty, ts = ref.ssd_recurrence_ref(*_t(arrs), state=torch.from_numpy(st))
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("s,chunk", [(64, 16), (50, 16), (37, 8), (5, 8)])
def test_chunked_matches_jax_including_ragged_tails(s, chunk):
    """s % chunk != 0 pads with zero dt (an exact no-op on the state)."""
    arrs = _inputs(s, None, s, 2, 16, 8)
    st = (np.random.default_rng(3).standard_normal((2, 8, 16)) * 0.5
          ).astype(np.float32)
    jy, js = jref.ssd_chunked_ref(*_j(arrs), chunk=chunk,
                                  state=jnp.asarray(st))
    ty, ts = ref.ssd_chunked_ref(*_t(arrs), chunk=chunk,
                                 state=torch.from_numpy(st))
    assert ty.shape == (s, 2, 16) and ts.shape == (2, 8, 16)
    _close(ty, jy)
    _close(ts, js)
    # the chunked form equals the port's own recurrence (the duality).
    ry, rs = ref.ssd_recurrence_ref(*_t(arrs), state=torch.from_numpy(st))
    _close(ty, ry.numpy())
    _close(ts, rs.numpy())


def test_state_continuation():
    """Two calls, the second fed the first's final state, give one call's
    outputs and final state (prefill then decode rely on it)."""
    x, dt, A, B, C = _t(_inputs(4, None, 64, 2, 16, 8))
    y_full, st_full = ref.ssd_chunked_ref(x, dt, A, B, C, chunk=16)
    y1, st1 = ref.ssd_chunked_ref(x[:32], dt[:32], A, B[:32], C[:32], 16)
    y2, st2 = ref.ssd_chunked_ref(x[32:], dt[32:], A, B[32:], C[32:], 16,
                                  state=st1)
    _close(torch.cat([y1, y2]), y_full.numpy())
    _close(st2, st_full.numpy())


@pytest.mark.parametrize("b,s,h,dh,ds,chunk", [
    (1, 64, 2, 32, 16, 16),
    (2, 128, 3, 64, 32, 32),
    (1, 256, 1, 64, 128, 64),   # mamba2-1.3b-like ratios
])
def test_kernel_twin_matches_jax_pallas_kernel(b, s, h, dh, ds, chunk):
    arrs = _inputs(s + h, b, s, h, dh, ds)
    want = jscan(*_j(arrs), chunk=chunk, interpret=True)
    before = ssd_scan.launches
    got = ssd_scan(*_t(arrs), chunk=chunk)
    assert ssd_scan.launches == before      # CPU tensors: the twin, no launch
    assert got.dtype == torch.float32 and got.shape == (b, s, h, dh)
    _close(got, want)
    assert torch.equal(got, ssd_scan_plain(*_t(arrs), chunk=chunk))
    # and the recurrence, as the JAX test holds the Pallas kernel.
    x, dt, A, B, C = _j(arrs)
    rec = jax.vmap(lambda xx, dd, bb, cc: jref.ssd_recurrence_ref(
        xx, dd, A, bb, cc)[0])(x, dt, B, C)
    _close(got, rec)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ops_ssd_matches_jax_ops(use_pallas):
    arrs = _inputs(9, 2, 96, 3, 16, 16)
    want = jops.ssd(*_j(arrs), chunk=32, use_pallas=use_pallas)
    _close(ops.ssd(*_t(arrs), chunk=32, use_pallas=use_pallas), want)


def test_ops_ssd_reference_branch_pads_ragged_lengths():
    arrs = _inputs(10, 2, 45, 2, 16, 16)
    want = jops.ssd(*_j(arrs), chunk=16, use_pallas=False)
    _close(ops.ssd(*_t(arrs), chunk=16, use_pallas=False), want)


def test_ragged_length_raises_like_the_reference():
    arrs = _inputs(11, 1, 40, 2, 16, 16)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        jscan(*_j(arrs), chunk=16, interpret=True)
    for fn in (ssd_scan, ssd_scan_plain):
        with pytest.raises(ValueError, match="not a multiple of chunk"):
            fn(*_t(arrs), chunk=16)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ops.ssd(*_t(arrs), chunk=16, use_pallas=True)


def test_wrapper_refuses_non_cpu_tensors_without_a_kernel():
    """No silent fallback: tensors off the CPU launch the kernel or
    raise; meta tensors raise before any launch."""
    x, dt, A, B, C = _t(_inputs(12, 1, 32, 2, 16, 16))
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_scan(x.to("meta"), dt, A, B, C, chunk=16)


# --- the card kernel's order (csrc/ssd_scan.cu), mirrored in Python ------------------


def _decomposed(x, dt, A, B, C, chunk):
    """B6's chunk-parallel order: G = C·Bᵀ once per (b, chunk) over the
    causal triangle (the exp of the decay taken only on and below the
    diagonal); each chunk's own state; the serial pass over chunks,
    S_in[c] = exp(cum_last[c-1]) S_in[c-1] + S_loc[c-1]; then per chunk
    y = (G ∘ L ∘ dt_j)·x + exp(cum_i) C_i·S_in.  fp32 throughout."""
    b, s, h, dh = x.shape
    ds, nc = B.shape[-1], s // chunk
    xc = x.reshape(b, nc, chunk, h, dh)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc, Cc = B.reshape(b, nc, chunk, ds), C.reshape(b, nc, chunk, ds)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    G = torch.einsum("bcis,bcjs->bcij", Cc, Bc) * tri          # once per (b, c)
    cum = torch.cumsum(dtc * A, dim=2)                         # (b, nc, Q, h)
    cl = cum[:, :, -1]                                         # (b, nc, h)
    wj = torch.exp(cl[:, :, None] - cum) * dtc
    S_loc = torch.einsum("bcjs,bcjh,bcjhd->bchsd", Bc, wj, xc)
    S_in = torch.zeros_like(S_loc)
    run = torch.zeros_like(S_loc[:, 0])
    for c in range(nc):                                        # the serial pass
        S_in[:, c] = run
        run = run * torch.exp(cl[:, c])[..., None, None] + S_loc[:, c]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (b, nc, i, j, h)
    mask = tri[None, None, :, :, None]
    L = torch.where(mask, torch.exp(diff.masked_fill(~mask, 0.0)), 0.0)
    assert torch.isfinite(L).all()      # no inf above the diagonal
    W = G[..., None] * L * dtc[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhd->bcihd", W, xc)
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "bcis,bchsd->bcihd", Cc, S_in)
    return y.reshape(b, s, h, dh)


@pytest.mark.parametrize("b,s,h,dh,ds,chunk,deep", [
    (2, 64, 3, 16, 16, 64, False),      # one chunk (nc = 1)
    (1, 144, 2, 32, 48, 48, False),     # chunk 48, ds 48
    (2, 256, 2, 64, 128, 64, False),    # ds 128, four chunks
    (1, 96, 2, 16, 16, 32, True),       # |A| dt large: exp underflows to 0
])
def test_kernel_order_matches_twin_and_jax(b, s, h, dh, ds, chunk, deep):
    x, dt, A, B, C = _inputs(s * 7 + ds, b, s, h, dh, ds)
    if deep:
        A = A * 200.0        # cum falls by ~20-300 per position
    arrs = (x, dt, A, B, C)
    got = _decomposed(*_t(arrs), chunk)
    assert torch.isfinite(got).all()
    _close(got, ssd_scan_plain(*_t(arrs), chunk=chunk).numpy())
    _close(got, jscan(*_j(arrs), chunk=chunk, interpret=True))


def test_ssd_plan_from_shapes():
    from repro_torch.kernels.ssd_scan import ssd_plan
    main = ssd_plan(4, 2048, 64, 64, 128, 256)
    assert main["dhs"] == 64 and main["qp"] == 256 and main["n_chunks"] == 8
    assert main["ctas"] == {"cb": 10 * 8 * 4, "state": 2048, "pass": 2048,
                            "out": 8192}
    assert main["scratch"] == {"G": (4, 8, 256, 256),
                               "S": (4, 64, 8, 128, 64), "L": (4, 64, 8)}
    assert main["scratch_bytes"] == 4 * (4 * 8 * 256 * 256
                                         + 4 * 64 * 8 * 128 * 64 + 4 * 64 * 8)
    long = ssd_plan(1, 16384, 64, 64, 128, 256)
    assert long["ctas"]["state"] == 4096
    odd = ssd_plan(3, 240, 5, 48, 16, 48)
    assert odd["dhs"] == 16 and odd["qp"] == 64 and odd["n_chunks"] == 5
    assert odd["ctas"]["out"] == 5 * 1 * 3 * 5 * 3


def test_ssd_wrapper_reads_no_device_tensor_on_the_host(monkeypatch):
    """With meta tensors (which hold no data), the CUDA path of B6's
    wrapper reaches the one C call with the plan's slab and fp32 scratch
    of the plan's shapes, allocated on x's device."""
    from repro_torch.kernels import ssd_scan as ss
    calls, scratch = [], []
    empty = torch.empty

    def spy_empty(*args, **kw):
        t = empty(*args, **kw)
        scratch.append(t)
        return t

    monkeypatch.setattr(ss, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(ss, "_kernel",
                        lambda: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(ss.torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    b, s, h, dh, ds, chunk = 2, 512, 4, 48, 128, 256
    meta = dict(device="meta")
    x = torch.zeros((b, s, h, dh), **meta)
    dt = torch.zeros((b, s, h), **meta)
    A = torch.zeros((h,), **meta)
    B, C = (torch.zeros((b, s, ds), **meta) for _ in range(2))
    monkeypatch.setattr(ss.torch, "empty", spy_empty)
    before = ss.ssd_scan.launches
    y = ss.ssd_scan(x, dt, A, B, C, chunk)
    assert y.device.type == "meta" and y.shape == x.shape
    assert ss.ssd_scan.launches == before + 1
    plan = ss.ssd_plan(b, s, h, dh, ds, chunk)
    assert len(calls) == 1 and calls[0][9:16] == (b, s, h, dh, ds, chunk, 16)
    assert [tuple(t.shape) for t in scratch] == [
        plan["scratch"][k] for k in ("G", "S", "L")]
    assert all(t.dtype == torch.float32 and t.device.type == "meta"
               for t in scratch)
